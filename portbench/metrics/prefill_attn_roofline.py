"""Causal prefill attention's share of its roofline in the profiled
slice: each admitted prompt's least time (max of its causal FLOPs over
989 TFLOP/s and its q, k, v, o bytes over 3.35 TB/s) at every attention
layer, summed, over the device time of the kernels named below."""

KERNELS = ("fa_fwd_tc",)


def read(r):
    t = r.trace
    if t is None or r.family != "moe_attention":
        return None
    dev = r.kernel_seconds(KERNELS)
    c, m = r.counts, r.model
    bound = 0.0
    for s in r.slice_steps:
        if s["prompt"]:
            fl, nb = c.flash_fwd(1, s["prompt"], s["prompt"], m["n_heads"],
                                 m["n_kv_heads"], m["head_dim"])
            bound += m["n_layers"] * c.bound_s(fl, nb)
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
