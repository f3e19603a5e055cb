"""One run of one cell: set-up, the measured window, the check, the
numbers.  ``run.py`` calls :func:`run` once a card has been found; the
tests call it on the CPU with a tiny cell."""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
from typing import Dict

import numpy as np

from pbench import check, program, serve, spec, traffic, window
from pbench import weights as wts


def _reader(root, name):
    path = root / "metrics" / f"{name}.py"
    sp = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False) -> Dict:
    import torch
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    c = cell.cell
    cfg = program.model_config(cell.config)
    params = wts.make(cell.config, seed, device)
    gw, adapter, engines, policy = serve.build(
        cfg, params, cell.config, str(cell.router_dir), device)
    items = traffic.stream(cell.mix, c["requests"], c["rate"], c["backlog"],
                           seed, cell.config["model"]["vocab_size"])
    reqs = program.requests(items)
    lengths = sorted({p for _, p, _ in traffic.size_block(cell.mix)})
    serve.warm(engines, [lengths[0], lengths[len(lengths) // 2],
                         lengths[-1]], sync)
    rec = serve.Recorder(seconds, c["backlog"])
    if trace:
        from pbench import profile as prof_lib
        rec.profiler = prof_lib.Slice(c["slice"]["at"], c["slice"]["steps"],
                                      sync)
    serve.wrap(rec, gw, adapter, engines, policy)
    try:
        gw.run(reqs)
    except serve.WindowClosed:
        pass
    else:
        raise RuntimeError("the stream ran out before the window closed: "
                           "give the cell more requests")
    for hook in ("enqueue", "step", "decode", "route"):
        if not rec.fired[hook]:
            raise RuntimeError(f"the {hook} wrapper never fired")
    trace_sum = None
    excluded = None
    if trace:
        from pbench import profile as prof_lib
        rec.profiler.close()
        trace_sum = prof_lib.reduce(rec.profiler)
        excluded = rec.profiler.excluded
    sync()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # -- the check, with the program's state freed ------------------------
    finished = check.finished(rec, adapter, engines)
    books = check.bookkeeping(rec, adapter, engines)
    stranded = check.stranded(rec, adapter, engines)
    for e in engines:
        e.cache = None
    del gw, engines
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    chk = c["check"]
    picked = check.sample(finished, rec.served, seed, chk["sample"])
    gaps, ctl = check.logit_gaps(params, cell.config, picked, rec.served,
                                 device, control=control)
    mism = check.router_mismatches(rec.acts,
                                   str(cell.router_dir / "weights.json"))
    n_books = sum(books.values())
    checks = _gap_checks(gaps, chk)
    checks["router_mismatch"] = {"value": mism, "limit": 0}
    checks["bookkeeping"] = {"value": n_books, "limit": 0}
    correct = bool(picked) and _within(checks)

    # -- the numbers ------------------------------------------------------
    metrics = {}
    if not trace:
        e2e = window.end_to_end(rec, t_start)
        for m in cell.end_to_end:
            val = e2e[m["name"]]
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        r = window.Reading(rec, cell, trace_sum, excluded)
        for m in cell.per_layer:
            val = _reader(cell.root, m["name"])(r)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(rec.enq),
           "failed": n_books, "metrics": metrics, "device": dev}
    if trace_sum is not None:
        dev["busy_s"] = trace_sum["busy_s"]
        dev["window_s"] = trace_sum["wall_s"]
        out["breakdown"] = {"device_ops": [[k[:160], v] for k, v in
                                           trace_sum["device_ops"]],
                            "idle_gaps": [[k[:160], v] for k, v in
                                          trace_sum["idle_gaps"]]}
    out["detail"] = {
        "seed": seed, "window_s": window.window_s(rec),
        "steps": len(rec.window_steps()), "routes": len(rec.routes),
        "finished": len(finished), "sampled": len(picked),
        "served_tokens_checked": int(sum(len(g) for g in gaps)),
        "books": books, "stranded": stranded,
        "gaps_max": [float(g.max()) for g in gaps if len(g)],
        "gap_stats": _stats(gaps),
    }
    if control:
        # the control in the program's place, judged by the same numbers
        # and limits as the program's run: it has to come out not correct
        ctl_checks = _gap_checks(ctl, chk)
        out["detail"]["control_gaps_max"] = [float(g.max()) for g in ctl
                                             if len(g)]
        out["detail"]["control_stats"] = _stats(ctl)
        out["control_checks"] = ctl_checks
        out["control_correct"] = bool(picked) and _within(ctl_checks)
    out["checks"] = checks
    return out


def _gap_checks(gaps, chk: Dict) -> Dict:
    """The gap numbers that the cell's ``check`` gives a limit, each
    beside it."""
    return {name: {"value": val, "limit": chk[name]}
            for name, val in check.gap_numbers(gaps).items() if name in chk}


def _within(checks: Dict) -> bool:
    return all(v["value"] <= v["limit"] for v in checks.values())


def _stats(gaps) -> Dict:
    """Widest, 99th percentile, mean and count over every checked
    position of a run."""
    g = np.concatenate([x for x in gaps if len(x)]) if gaps else np.zeros(0)
    if not len(g):
        return {}
    return {"max": float(g.max()), "p99": float(np.percentile(g, 99)),
            "mean": float(g.mean()), "n": int(len(g)),
            "n_over_0.1": int((g > 0.1).sum())}


def report(out: Dict, stream_err=sys.stderr, stream_out=sys.stdout):
    """Each number compared beside its limit as the last lines of
    standard error, then the result as the last line of standard
    output (its ``checks`` key last)."""
    if "control_checks" in out:
        for name, v in out["control_checks"].items():
            print(f"control {name}: {v['value']!r} (limit {v['limit']!r})",
                  file=stream_err)
        print(f"control correct: {out['control_correct']}", file=stream_err)
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=stream_err)
    stream_err.flush()
    print(json.dumps(out, default=_num), file=stream_out)
    stream_out.flush()


def _num(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    raise TypeError(type(x))

