"""Device-to-host copies per engine step in the profiled slice: each is
a point where the host waits for the card (MoE ragged's group sizes,
the argmax's read)."""


def read(r):
    t = r.trace
    if t is None or not t["steps"]:
        return None
    return t["d2h"] / t["steps"]
