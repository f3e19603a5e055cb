"""Shared by the mfu readers: model FLOPs of the window's prompt and
output tokens (pbench.counts) over the window's wall times the card's
bf16 peak."""


def mfu(r):
    c, m, fam = r.counts, r.model, r.family
    steps, wall = r.steps, r.wall_s
    if not steps or wall <= 0:
        return None
    flops = 0.0
    for s in steps:
        if s["prompt"]:
            flops += c.prompt_flops(m, fam, s["prompt"])
        for ctx in s["ctx"]:
            flops += c.token_flops(m, fam, ctx)
    return 100.0 * flops / (wall * c.PEAK_BF16)
