"""Decode attention's share of its roofline in the profiled slice: the
least time of every call (the residents' K/V at their context lengths,
q and o of the residents, over 3.35 TB/s; or the FLOPs over 989 TFLOP/s
if larger), summed, over the device time of the kernels named below."""

KERNELS = ("dec_split",)


def read(r):
    t = r.trace
    if t is None or r.family != "moe_attention":
        return None
    dev = r.kernel_seconds(KERNELS)
    c, m = r.counts, r.model
    bound = 0.0
    for s in r.slice_steps:
        if s["ctx"]:
            fl, nb = c.decode_attn(len(s["ctx"]), m["n_heads"],
                                   m["n_kv_heads"], m["head_dim"],
                                   sum(s["ctx"]))
            bound += m["n_layers"] * c.bound_s(fl, nb)
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
