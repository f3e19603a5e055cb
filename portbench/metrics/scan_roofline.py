"""The selective scan's share of its roofline in the profiled slice:
each admitted prompt's least time (its bytes over 3.35 TB/s, or its
float32 FLOPs over 67 TFLOP/s if larger) at every Mamba layer, summed,
over the device time of the kernels named below."""

KERNELS = ("scan_fwd",)


def read(r):
    t = r.trace
    if t is None or r.family != "mamba1":
        return None
    dev = r.kernel_seconds(KERNELS)
    c, m = r.counts, r.model
    mb = m["mamba"]
    bound = 0.0
    for s in r.slice_steps:
        if s["prompt"]:
            fl, nb = c.scan_fwd(1, s["prompt"], mb["d_inner"], mb["d_state"])
            bound += m["n_layers"] * c.bound_s(fl, nb, c.PEAK_F32)
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
