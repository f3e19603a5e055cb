"""Median wall of the engine steps that admitted nothing: one gang
decode iteration over the residents."""
import statistics


def read(r):
    walls = [s["t1"] - s["t0"] for s in r.steps
             if s["admitted"] is None and s["ctx"]]
    return statistics.median(walls) * 1e3 if walls else None
