"""Share of the profiled slice's ``repro.moe.experts`` spans inside which
the program launched its grouped expert kernel (a kernel whose name holds
``grouped_ffn``): 100 where every routed layer's experts ran on it, 0
where they all fell back to the per-expert loop (a parent without the
kernel).  A launch is placed by its CUDA runtime call, matched to its
kernel through the correlation ids, as ``_spans`` places device time;
only spans wholly inside the slice count.  None where the run was not
traced or recorded no ``repro.moe.experts`` span."""
import bisect
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "_spans", Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)

SPAN = "repro.moe.experts"
KERNEL = "grouped_ffn"


def read(r):
    d = _mod.read(r)
    if not _mod.has(d, SPAN):
        return None
    events = r.rec.profiler.result.profiler.kineto_results.events()
    return share(events, d["lo"], d["hi"])


def share(events, lo, hi):
    """Percent of the ``SPAN`` spans within [lo, hi] (ns) in which a
    ``KERNEL`` kernel was launched, from kineto events."""
    spans, runtime, kernels = [], {}, []
    for ev in events:
        name, s = ev.name(), ev.start_ns()
        key = (ev.correlation_id(), ev.linked_correlation_id())
        if str(ev.device_type()).endswith("CUDA"):
            if KERNEL in name:
                kernels.append(key)
        elif name == SPAN:
            e = s + ev.duration_ns()
            if lo <= s < e <= hi:
                spans.append((s, e))
        elif name.startswith("cu"):
            runtime[key] = s
    if not spans:
        return None
    spans.sort()
    starts = [s for s, _ in spans]
    hit = set()
    for key in kernels:
        t = runtime.get(key)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < spans[i][1]:
            hit.add(i)
    return 100.0 * len(hit) / len(spans)
