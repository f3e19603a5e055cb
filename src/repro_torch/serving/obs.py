"""Trace & metrics export: Chrome trace-event JSON and a Prometheus /
JSON metrics registry.

Two consumers, two formats:

  * ``chrome_trace(recorder)`` renders a ``serving.trace`` recorder into
    the Chrome trace-event format (the JSON Perfetto / chrome://tracing
    load directly).  Layout: pid 0 is the router (queued spans per
    request, admission instants, queue-depth counter); pid ``1 + i`` is
    instance ``i`` (prefill / decode spans, first-token / preempt
    instants, KV-occupancy and backlog counters).  Within a pid,
    requests are packed onto lanes (tids) greedily -- a lane is reused
    as soon as its previous span ends -- so the lane count visualizes
    effective concurrency, not slot identity.
  * ``MetricsRegistry`` is a flat name->value gauge registry with
    Prometheus text-exposition and JSON renderers.  It ingests nested
    dicts (``StreamMetrics.snapshot()``, ``DQNAgent.telemetry()``) by
    flattening keys, so the gateway's SLO metrics, decision-attribution
    block, and RL-training telemetry all land in one scrape target.

``python -m repro_torch.serving.obs --validate trace.json`` checks a
trace file against the schema; exits nonzero on any violation.

The port's own copy of ``repro.serving.obs`` (framework-free).
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Optional

from repro_torch.serving import trace as tr

_US = 1e6          # trace timestamps are seconds; Chrome wants microseconds

# router-side instants (pid 0); everything else rides an instance pid
_ROUTER_INSTANTS = {tr.EV_ADMIT: "admit", tr.EV_DEFER: "defer",
                    tr.EV_SHED: "shed", tr.EV_CANCEL: "cancel",
                    tr.EV_EVICT: "evict", tr.EV_ROUTE: "route",
                    tr.EV_RETRY: "retry"}
_INSTANCE_INSTANTS = {tr.EV_FIRST_TOKEN: "first_token",
                      tr.EV_PREEMPT: "preempt", tr.EV_FAIL: "fail",
                      tr.EV_RECOVER: "recover", tr.EV_HEDGE: "hedge"}


class _Lanes:
    """Greedy lane packer: first lane whose previous span has ended."""

    def __init__(self):
        self.ends: List[float] = []

    def take(self, start: float, end: float) -> int:
        for i, e in enumerate(self.ends):
            if e <= start:
                self.ends[i] = end
                return i
        self.ends.append(end)
        return len(self.ends) - 1


def _spans_for(events) -> List[dict]:
    """Reconstruct per-request spans from one rid's canonical events:
    queued (arrive -> route, router pid), prefill (inst_admit ->
    prefill_done) and decode (prefill_done -> complete) per visit --
    a preemption closes the open span and the next inst_admit opens a
    fresh prefill, so re-runs show as separate spans on the lane."""
    spans = []
    queued_at: Optional[float] = None
    open_span: Optional[dict] = None

    def close(t: float):
        nonlocal open_span
        if open_span is not None:
            open_span["t1"] = t
            spans.append(open_span)
            open_span = None

    for t, etype, rid, inst, tenant, data in events:
        if etype == tr.EV_ARRIVE:
            queued_at = t
        elif etype == tr.EV_ROUTE and queued_at is not None:
            spans.append({"name": "queued", "pid": 0, "t0": queued_at,
                          "t1": t, "rid": rid, "tenant": tenant,
                          "args": data or {}})
            queued_at = None
        elif etype == tr.EV_INST_ADMIT:
            close(t)
            open_span = {"name": "prefill", "pid": 1 + inst, "t0": t,
                         "rid": rid, "tenant": tenant,
                         "args": data or {}}
        elif etype == tr.EV_PREFILL_DONE:
            close(t)
            open_span = {"name": "decode", "pid": 1 + inst, "t0": t,
                         "rid": rid, "tenant": tenant, "args": {}}
        elif etype in (tr.EV_COMPLETE, tr.EV_PREEMPT, tr.EV_HEDGE):
            # a hedge withdraws the request from its instance, ending
            # whatever span the doomed attempt had open
            close(t)
    if open_span is not None:          # request still in flight at end
        close(open_span["t0"])
    return spans


def chrome_trace(recorder, title: str = "repro-router") -> Dict:
    """Render a recorder into a Chrome trace-event JSON document."""
    out: List[dict] = []
    by_rid: Dict[int, list] = {}
    instances = set()
    for ev in recorder.events():
        if ev[3] >= 0:
            instances.add(ev[3])
        if ev[2] >= 0:
            by_rid.setdefault(ev[2], []).append(ev)
        name = _INSTANCE_INSTANTS.get(ev[1])
        if name is not None:
            out.append({"name": name, "ph": "i", "s": "p",
                        "pid": 1 + ev[3] if ev[3] >= 0 else 0, "tid": 0,
                        "ts": ev[0] * _US,
                        "args": dict(ev[5] or {}, rid=ev[2])})
        name = _ROUTER_INSTANTS.get(ev[1])
        if name is not None and name != "route":
            out.append({"name": name, "ph": "i", "s": "p", "pid": 0,
                        "tid": 0, "ts": ev[0] * _US,
                        "args": dict(ev[5] or {}, rid=ev[2])})
    spans = [s for evs in by_rid.values() for s in _spans_for(evs)]
    spans.sort(key=lambda s: (s["t0"], s["t1"], s["rid"]))
    lanes: Dict[int, _Lanes] = {}
    for s in spans:
        lane = lanes.setdefault(s["pid"], _Lanes()).take(s["t0"], s["t1"])
        out.append({"name": s["name"], "ph": "X", "pid": s["pid"],
                    "tid": lane, "ts": s["t0"] * _US,
                    "dur": max(s["t1"] - s["t0"], 0.0) * _US,
                    "cat": s["tenant"] or "default",
                    "args": dict(s["args"], rid=s["rid"])})
    for t, name, value, inst in recorder.counters:
        pid = 1 + inst if inst >= 0 else 0
        if inst >= 0:
            instances.add(inst)
        out.append({"name": name, "ph": "C", "pid": pid, "tid": 0,
                    "ts": t * _US, "args": {name: value}})
    meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "router"}},
            {"name": "process_sort_index", "ph": "M", "pid": 0, "tid": 0,
             "args": {"sort_index": 0}}]
    for i in sorted(instances):
        meta.append({"name": "process_name", "ph": "M", "pid": 1 + i,
                     "tid": 0, "args": {"name": f"instance {i}"}})
        meta.append({"name": "process_sort_index", "ph": "M",
                     "pid": 1 + i, "tid": 0,
                     "args": {"sort_index": 1 + i}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms",
            "otherData": {"title": title,
                          "n_emitted": recorder.n_emitted,
                          "dropped": recorder.dropped}}


def validate_chrome_trace(doc) -> List[str]:
    """Schema check for ``chrome_trace`` output (and, loosely, any
    chrome://tracing JSON-object-format document).  Returns a list of
    violations; empty means valid."""
    errs: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document must be an object with a 'traceEvents' list"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' must be a list"]
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errs.append(f"{where}: not an object")
            continue
        for k in ("name", "ph", "pid"):
            if k not in e:
                errs.append(f"{where}: missing '{k}'")
        ph = e.get("ph")
        if ph not in ("X", "C", "M", "i", "B", "E"):
            errs.append(f"{where}: unknown ph {ph!r}")
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                errs.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: X event needs dur >= 0")
        if ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args:
                errs.append(f"{where}: C event needs non-empty args")
        if len(errs) >= 50:
            errs.append("... (truncated)")
            break
    return errs


# -- metrics registry ---------------------------------------------------

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(*parts: str) -> str:
    name = "_".join(p for p in parts if p)
    name = _NAME_OK.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


class MetricsRegistry:
    """Flat gauge registry; everything a scrape of the router exposes.

    ``ingest`` flattens nested dicts key-by-key (lists and non-numeric
    leaves are skipped, ``None`` leaves are skipped), so the gateway's
    ``snapshot()`` -- including the ``attribution`` / drift block -- and
    the agent's ``telemetry()`` land as e.g.::

        gateway_e2e_p95, gateway_attribution_agree_rate,
        gateway_attribution_drift_abs_err_p50, rl_loss, rl_td_abs_mean
    """

    def __init__(self):
        self._vals: Dict[str, float] = {}

    def set(self, name: str, value) -> None:
        if isinstance(value, bool):
            value = int(value)
        if isinstance(value, (int, float)):
            self._vals[_metric_name(name)] = float(value)

    def ingest(self, mapping: Dict, prefix: str = "") -> None:
        for k, v in mapping.items():
            name = _metric_name(prefix, str(k))
            if isinstance(v, dict):
                self.ingest(v, prefix=name)
            else:
                self.set(name, v)

    def ingest_snapshot(self, snap: Dict, prefix: str = "gateway"):
        self.ingest(snap, prefix=prefix)

    def ingest_rl(self, telemetry: Dict, prefix: str = "rl"):
        self.ingest(telemetry, prefix=prefix)

    def to_json(self) -> Dict[str, float]:
        return dict(sorted(self._vals.items()))

    def to_prometheus(self) -> str:
        lines = []
        for name, val in sorted(self._vals.items()):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {val:.10g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def save(self, path: str) -> None:
        """Write the registry; ``.prom`` extension selects the text
        exposition format, anything else gets JSON."""
        if path.endswith(".prom"):
            with open(path, "w") as f:
                f.write(self.to_prometheus())
        else:
            with open(path, "w") as f:
                json.dump(self.to_json(), f, indent=1, sort_keys=True)

    def __len__(self) -> int:
        return len(self._vals)

    def __getitem__(self, name: str) -> float:
        return self._vals[_metric_name(name)]


def write_trace(recorder, path: str, title: str = "repro-router"):
    """chrome_trace -> JSON file (the ``--trace PATH`` implementation)."""
    doc = chrome_trace(recorder, title=title)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.obs",
        description="validate trace / metrics artifacts")
    ap.add_argument("--validate", metavar="TRACE_JSON", required=True,
                    help="Chrome trace-event JSON file to check")
    ap.add_argument("--metrics", metavar="METRICS_JSON", default=None,
                    help="optional metrics-registry JSON to check")
    args = ap.parse_args(argv)
    with open(args.validate) as f:
        doc = json.load(f)
    errs = validate_chrome_trace(doc)
    n_ev = len(doc.get("traceEvents", [])) if isinstance(doc, dict) else 0
    if errs:
        for e in errs:
            print(f"INVALID {args.validate}: {e}")
        return 1
    print(f"OK {args.validate}: {n_ev} trace events")
    if args.metrics:
        with open(args.metrics) as f:
            m = json.load(f)
        bad = not isinstance(m, dict) or not m or any(
            not isinstance(v, (int, float)) or isinstance(v, bool)
            for v in m.values())
        if bad:
            print(f"INVALID {args.metrics}: expected a non-empty "
                  "{name: number} object")
            return 1
        print(f"OK {args.metrics}: {len(m)} metrics")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
