"""Shared by the span readers: the program's own wall-clock spans in the
profiled slice.

The program names ranges of its serving path ``repro.<layer>.<part>``
(``repro_torch.serving.trace.span`` and ``sync``; docs/TRACING.md lists
them).  They record only while the profiler runs, into its own event
stream, so they share the kineto clock of the kernels and copies.  This
module reads them from the profiler the harness already keeps
(``r.rec.profiler.result``) and returns None where the run was not
traced, or a dict of:

  ``lo``, ``hi``   the slice on the kineto clock (ns): the first start of
                   its events and the last end of those other than the
                   spans (the harness's closing synchronize);
  ``spans``        name -> {"n", "wall_s", "self_s", "walls"} over the
                   spans wholly inside the slice (a span open when the
                   profiler started or stopped is not recorded); self
                   time is a span's wall less its children's;
  ``idle_s``       the slice's idle time: its length less the union of
                   the device's intervals in it;
  ``idle_by``      the idle time by the innermost span open over each
                   part of it, ``unspanned`` where none is: the parts add
                   up to ``idle_s``;
  ``device_by``    each device interval's seconds (kernels, copies and
                   sets) by the innermost span open at its launch, found
                   through the launch's correlation ids;
  ``d2h``          the device-to-host copies, ``d2h_in_sync`` those
                   launched inside a ``repro.sync.*`` span, ``d2h_out`` the
                   others by the innermost span at their launch;
  ``sync_sites``   site -> {"spans", "d2h"} of each ``repro.sync.*`` name;
  ``idle_under``   prefix -> idle seconds while any open span's name
                   starts with it (``idle_under("repro.moe.")``).

The walk is cached on ``r`` (the readers share one), and its summary is
printed once to standard error as a ``spans: {...}`` line (before the
check's lines), for the tables of where the time goes."""
import bisect
import json
import sys

PREFIX = "repro."
SYNC = "repro.sync."
UNSPANNED = "unspanned"


def read(r):
    if r.trace is None:
        return None
    cached = getattr(r, "_program_spans", None)
    if cached is None:
        prof = getattr(getattr(r.rec, "profiler", None), "result", None)
        if prof is None:
            return None
        cached = walk(prof.profiler.kineto_results.events())
        r._program_spans = cached
        print("spans: " + json.dumps(summary(cached, r.trace)),
              file=sys.stderr)
    return cached


def has(d, name):
    """Whether the program recorded a span of ``name`` in the slice (a
    parent commit without spans records none)."""
    return d is not None and name in d["spans"]


def walk(events):
    """The numbers above from kineto events (objects with ``name()``,
    ``device_type()``, ``start_ns()``, ``duration_ns()``,
    ``correlation_id()`` and ``linked_correlation_id()``)."""
    dev, host, named = [], [], []
    for ev in events:
        s = ev.start_ns()
        rec = (s, s + ev.duration_ns(), ev.name(), ev.correlation_id(),
               ev.linked_correlation_id())
        if str(ev.device_type()).endswith("CUDA"):
            dev.append(rec)
        elif rec[2].startswith(PREFIX):
            named.append(rec)
        else:
            host.append(rec)
    if not dev and not host:
        return None
    # a span open when the profiler started is not recorded at all, one
    # open when it stopped is cut at the stop, past every other event
    lo = min(r[0] for r in dev + host + named)
    hi = max(r[1] for r in dev + host)
    kept = sorted((r for r in named if lo <= r[0] < r[1] <= hi),
                  key=lambda r: (r[0], -r[1]))
    parent, segs = _nest(kept, lo, hi)
    chains = []
    for i, r in enumerate(kept):
        p = parent[i]
        chains.append((chains[p] if p >= 0 else ()) + (r[2],))

    # spans: counts, walls and self times
    child_s = [0] * len(kept)
    for i, p in enumerate(parent):
        if p >= 0:
            child_s[p] += kept[i][1] - kept[i][0]
    spans = {}
    for i, (s, e, name, _, _) in enumerate(kept):
        d = spans.setdefault(name, {"n": 0, "wall_s": 0.0, "self_s": 0.0,
                                    "walls": []})
        d["n"] += 1
        d["wall_s"] += (e - s) * 1e-9
        d["self_s"] += (e - s - child_s[i]) * 1e-9
        d["walls"].append((e - s) * 1e-9)

    # the device's idle time, by the innermost span over each part
    busy = _union([(max(s, lo), min(e, hi)) for s, e, *_ in dev
                   if e > lo and s < hi])
    idle = []
    t = lo
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if hi > t:
        idle.append((t, hi))
    idle_by = {}
    idle_seg = [0] * len(segs)
    j = 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            ov = min(b, segs[k][1]) - max(a, segs[k][0])
            if ov > 0:
                idle_seg[k] += ov
                name = kept[segs[k][2]][2] if segs[k][2] >= 0 else UNSPANNED
                idle_by[name] = idle_by.get(name, 0.0) + ov * 1e-9
            k += 1
    idle_s = sum(b - a for a, b in idle) * 1e-9

    # each device interval by the innermost span open at its launch: a
    # launch (a CUDA runtime call) shares its kernel's correlation id and
    # linked id (the host op it ran in); with no runtime call recorded,
    # the op's start stands for the launch
    runtime, ops = {}, {}
    for s, _, name, c, lk in host:
        if name.startswith("cu"):
            runtime[(c, lk)] = s
        elif lk == 0 and s < ops.get(c, hi + 1):
            ops[c] = s
    starts = [g[0] for g in segs]

    def at(t):
        if t is None:
            return -1
        k = bisect.bisect_right(starts, t) - 1
        return segs[k][2] if 0 <= k and t < segs[k][1] else -1

    device_by, d2h_out, sync_sites = {}, {}, {}
    d2h = d2h_in = 0
    for s, e, name, c, lk in dev:
        t = runtime.get((c, lk))
        if t is None:
            t = ops.get(lk) if lk else None
        i = at(t)
        key = kept[i][2] if i >= 0 else UNSPANNED
        device_by[key] = device_by.get(key, 0.0) + (e - s) * 1e-9
        if name.startswith("Memcpy") and "DtoH" in name:
            d2h += 1
            site = next((n for n in (chains[i] if i >= 0 else ())
                         if n.startswith(SYNC)), None)
            if site is None:
                d2h_out[key] = d2h_out.get(key, 0) + 1
            else:
                d2h_in += 1
                ss = sync_sites.setdefault(site[len(SYNC):],
                                           {"spans": 0, "d2h": 0})
                ss["d2h"] += 1
    for name, d in spans.items():
        if name.startswith(SYNC):
            sync_sites.setdefault(name[len(SYNC):],
                                  {"spans": 0, "d2h": 0})["spans"] = d["n"]

    def idle_under(prefix):
        return sum(idle_seg[k] for k, g in enumerate(segs) if g[2] >= 0
                   and any(n.startswith(prefix) for n in chains[g[2]])) \
            * 1e-9

    return {"lo": lo, "hi": hi, "spans": spans, "idle_s": idle_s,
            "idle_by": idle_by, "device_by": device_by, "d2h": d2h,
            "d2h_in_sync": d2h_in, "d2h_out": d2h_out,
            "sync_sites": sync_sites, "idle_under": idle_under}


def _nest(kept, lo, hi):
    """Each span's parent (the innermost span enclosing it, -1 for none)
    and the slice cut into segments (start, end, innermost span or -1),
    for spans sorted by (start, -end) and nested as calls nest."""
    parent = [-1] * len(kept)
    segs, stack = [], []
    t = lo

    def close_until(s):
        nonlocal t
        while stack and kept[stack[-1]][1] <= s:
            j = stack.pop()
            e = kept[j][1]
            if e > t:
                segs.append((t, e, j))
                t = e

    for i, r in enumerate(kept):
        close_until(r[0])
        if r[0] > t:
            segs.append((t, r[0], stack[-1] if stack else -1))
            t = r[0]
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    close_until(hi)
    if hi > t:
        segs.append((t, hi, -1))
    return parent, segs


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summary(d, trace):
    """The walk's numbers for the ``spans:`` line: per span name its
    count, wall and self seconds; idle and device seconds by span; the
    host copies by sync site and those outside any; the idle time's sum
    beside the slice's (and the reducer's wall less busy)."""
    if d is None:
        return None
    top = 16

    def rounded(m):
        return {k: round(v, 6) for k, v in
                sorted(m.items(), key=lambda kv: -kv[1])[:top]}
    return {
        "slice_s": round((d["hi"] - d["lo"]) * 1e-9, 6),
        "idle_s": round(d["idle_s"], 6),
        "idle_assigned_s": round(sum(d["idle_by"].values()), 6),
        "reducer_idle_s": round(trace["wall_s"] - trace["busy_s"], 6),
        "steps": trace["steps"],
        "idle_by": rounded(d["idle_by"]),
        "device_by": rounded(d["device_by"]),
        "spans": {k: [v["n"], round(v["wall_s"], 6), round(v["self_s"], 6)]
                  for k, v in sorted(d["spans"].items())},
        "d2h": d["d2h"], "d2h_in_sync": d["d2h_in_sync"],
        "d2h_out": d["d2h_out"], "sync_sites": d["sync_sites"],
        "idle_moe_s": round(d["idle_under"]("repro.moe."), 6),
    }
