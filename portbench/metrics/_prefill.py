"""Shared by the prefill readers: the wall of the steps that admitted a
request (its prefill and that step's decode iteration) per 1,000 prompt
tokens admitted."""


def ms_per_ktok(r):
    steps = [s for s in r.steps if s["admitted"] is not None]
    tokens = sum(s["prompt"] for s in steps)
    if not tokens:
        return None
    return sum(s["t1"] - s["t0"] for s in steps) / tokens * 1e6
