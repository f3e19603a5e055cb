"""Share of the profiled slice's wall with no operation on the device."""


def read(r):
    t = r.trace
    if t is None or t["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
