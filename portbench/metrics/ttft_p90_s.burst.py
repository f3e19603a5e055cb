"""90th percentile, over the requests whose first token falls in the
window before the profiled slice, of enqueue to first token: under the
mix's bursts the queue at the gateway decides it."""
import numpy as np


def read(r):
    rec, t_end = r.rec, r.rec.close_t
    if r.excluded is not None:
        t_end = min(t_end, r.excluded[0])
    waits = [w[0] - rec.enq[rid] for rid, w in rec.tok_walls.items()
             if w and rec.open_t <= w[0] <= t_end and rid in rec.enq]
    return float(np.percentile(waits, 90)) if waits else None
