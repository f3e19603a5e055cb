"""Numbers from the window's wall stamps (``pbench.serve.Recorder``).

End-to-end metrics take the whole window: a rate is all the work over all
the window's wall seconds, a tail is the tail of every sample in it.  The
per-layer readers (``metrics/*.py``) use the same stamps through
:class:`Reading`, which in a traced run leaves out the profiled slice
(the profiler slows the host while it runs)."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def percentile(xs, q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if len(xs) \
        else None


def window_s(rec) -> float:
    return rec.close_t - rec.open_t


def output_tokens(rec) -> int:
    return sum(len(s["ctx"]) for s in rec.window_steps())


def prompt_tokens(rec) -> int:
    return sum(s["prompt"] for s in rec.window_steps())


def token_gaps(rec) -> List[float]:
    """Wall gaps between consecutive tokens of a request, both inside the
    window."""
    out = []
    for walls in rec.tok_walls.values():
        w = [t for t in walls if rec.in_window(t)]
        out.extend(b - a for a, b in zip(w, w[1:]))
    return out


def first_token_waits(rec) -> List[float]:
    """Enqueue to first token, for every request whose first token falls
    in the window."""
    return [walls[0] - rec.enq[rid] for rid, walls in rec.tok_walls.items()
            if walls and rec.in_window(walls[0]) and rid in rec.enq]


def end_to_end(rec, t_start: float) -> Dict[str, Optional[float]]:
    w = window_s(rec)
    gaps = token_gaps(rec)
    waits = first_token_waits(rec)
    return {
        "output_tok_s": output_tokens(rec) / w,
        "prompt_tok_s": prompt_tokens(rec) / w,
        "tbt_p95_ms": None if not gaps else percentile(gaps, 95) * 1e3,
        "ttft_p90_s": percentile(waits, 90),
        "setup_s": rec.open_t - t_start,
    }


class Reading:
    """What a per-layer reader sees: the stamps (less the profiled slice),
    the slice's reduced trace (or None), the cell and the counts."""

    def __init__(self, rec, cell, trace: Optional[Dict], excluded=None):
        from pbench import counts
        self.rec, self.cell, self.trace, self.counts = rec, cell, trace, \
            counts
        self.model = cell.config["model"]
        self.family = cell.config["family"]
        self.excluded = excluded

    def _kept(self, t: float) -> bool:
        x = self.excluded
        return x is None or not (x[0] <= t <= x[1])

    @property
    def steps(self) -> List[Dict]:
        return [s for s in self.rec.window_steps() if self._kept(s["t0"])]

    @property
    def routes(self) -> List[tuple]:
        r = self.rec
        return [(a, b) for a, b in r.routes
                if r.in_window(a) and b <= r.close_t and self._kept(a)]

    @property
    def wall_s(self) -> float:
        w = window_s(self.rec)
        if self.excluded is not None:
            a, b = self.excluded
            w -= max(0.0, min(b, self.rec.close_t) - max(a, self.rec.open_t))
        return w

    def kernel_seconds(self, names) -> float:
        """Device seconds in the slice of the kernels whose names contain
        any of ``names`` (the profiler names a CUDA kernel by its
        demangled signature)."""
        return sum(sec for name, sec in self.trace["by_name"].items()
                   if any(n in name for n in names))

    @property
    def slice_steps(self) -> List[Dict]:
        """The steps the profiled slice covered."""
        if self.trace is None:
            return []
        t0s = set(self.trace["step_t0"])
        return [s for s in self.rec.steps if s["t0"] in t0s]
