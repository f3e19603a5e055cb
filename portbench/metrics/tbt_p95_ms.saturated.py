"""95th percentile of the wall gaps between two tokens of a request in a
cell run above capacity (the window before the profiled slice): the
decode steps of both engines and the admissions between them."""
import numpy as np


def read(r):
    rec, t_end = r.rec, r.rec.close_t
    if r.excluded is not None:
        t_end = min(t_end, r.excluded[0])
    gaps = []
    for walls in rec.tok_walls.values():
        w = [t for t in walls if rec.open_t <= t <= t_end]
        gaps.extend(b - a for a, b in zip(w, w[1:]))
    return float(np.percentile(gaps, 95)) * 1e3 if gaps else None
