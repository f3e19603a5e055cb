"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` (CPU and
CUDA activities) over a fixed number of engine steps mid-window, started
and stopped between steps with the card synchronised, and reduced in
memory (nothing is written to disk).

Reduced to: the device's busy seconds (the union of its kernel, copy and
set intervals) over the slice's wall, kernel device time by name, kernel
launches and device-to-host copies, and the idle gaps of the device
attributed to what the host was doing (the innermost host op or
annotation open at the gap's midpoint)."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional


class Slice:
    """Profiles ``steps`` engine steps from the first one that starts
    ``at`` (a share of the window) into the window."""

    def __init__(self, at: float, steps: int, sync):
        self.at, self.n, self.sync = float(at), int(steps), sync
        self.prof = None
        self.t0 = self.t1 = None
        self.done = 0
        self.step_t0: List[float] = []
        self.excluded = None          # (start, end) of the slice's hosting

    def before_step(self, rec, t0: float):
        if self.prof is None and self.t1 is None \
                and rec.open_t is not None \
                and t0 >= rec.open_t + self.at * rec.seconds:
            from torch.profiler import ProfilerActivity, profile
            self.sync()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = rec.clock()
            self._x0 = t0
        if self.prof is not None:
            self.step_t0.append(t0)

    def after_step(self, rec, t1: float):
        if self.prof is None:
            return
        self.done += 1
        if self.done >= self.n:
            self.sync()
            self.t1 = rec.clock()
            self.prof.stop()
            # the profiler's tracing leaves the host slower after it
            # stops: the stamps' readers keep to the window before it
            self.excluded = (self._x0, float("inf"))
            self.result = self.prof
            self.prof = None

    def close(self):
        """Stop a slice the window cut short (its numbers still count)."""
        if self.prof is not None:
            import time
            self.sync()
            self.t1 = time.perf_counter()
            self.prof.stop()
            self.excluded = (self._x0, float("inf"))
            self.result = self.prof
            self.prof = None


LAUNCH_API = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
              "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
              "cudaLaunchCooperativeKernel")


def _union(intervals):
    total, end = 0, None
    out = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            out.append([s, e])
            end = e
        elif e > end:
            out[-1][1] = e
            end = e
    for s, e in out:
        total += e - s
    return total, out


def reduce(sl: Slice) -> Optional[Dict]:
    """The slice's numbers, or None where no slice ran."""
    prof = getattr(sl, "result", None)
    if prof is None:
        return None
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = str(ev.device_type())
        rec = (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
        (dev if kind.endswith("CUDA") else host).append(rec)
    kernels = [r for r in dev if not r[0].startswith(("Memcpy", "Memset"))]
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in dev:
        by_name[name] += (e - s) * 1e-9
    busy_ns, merged = _union([(s, e) for _, s, e in dev])
    d2h = sum(1 for r in dev if r[0].startswith("Memcpy") and "DtoH" in r[0])
    # idle gaps inside the span of the device's work, named by the
    # innermost host op open at the gap's midpoint
    host.sort(key=lambda r: r[1])
    starts = [r[1] for r in host]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        gap = b - a
        if gap <= 0:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "host (no op open)"
        for j in range(i, max(i - 4000, -1), -1):
            if host[j][2] >= mid and host[j][0] not in LAUNCH_API:
                name = host[j][0]
                break
        gaps[name] += gap * 1e-9
    wall = sl.t1 - sl.t0
    return {
        "wall_s": wall,
        "busy_s": busy_ns * 1e-9,
        "steps": sl.done,
        "kernels": len(kernels),
        "d2h": d2h,
        "by_name": dict(by_name),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
        "step_t0": list(sl.step_t0),
    }

