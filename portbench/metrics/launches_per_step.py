"""Kernels the device ran per engine step in the profiled slice (each a
launch from the host)."""


def read(r):
    t = r.trace
    if t is None or not t["steps"]:
        return None
    return t["kernels"] / t["steps"]
