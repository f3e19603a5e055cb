"""Sim-vs-engine fidelity harness: does the simulator predict the
engine?  (PyTorch twin of ``repro.serving.fidelity``.)

The whole routing stack -- RL training, the heuristics, every benchmark
-- runs on the discrete-event simulator; production serves on real
``LLMInstance`` engines.  The simulator is only trustworthy if, given
the same calibrated ``HardwareProfile``, it produces the same latency
*distributions* the engine does.  This module quantifies that: it
replays ONE gateway arrival stream through

  * the Python-stepper simulator (``Cluster(backend="py")``),
  * the vectorized simulator (``Cluster(backend="vec")``),
  * the device-resident simulator (``Cluster(backend="jax")``, on
    ``device``), and
  * real engines (``EngineClusterAdapter`` over the port's
    ``LLMInstance``, on the device the parameters live on),

each behind an identically-configured ``Gateway`` under one
``RoutingPolicy``, and reports per-percentile TTFT / TBT / E2E deltas
between every backend pair.  The engine stamps first-token and
completion at the iteration's END -- its virtual clock advances before
the decode pass, the same anchor as ``SimInstance._iteration`` -- so on
a shared profile the virtual-clock deltas are zero and any residual is
a real modelling gap, not an anchoring artifact.

The stream is engine-sized (prompts from a small set of lengths; decode
lengths within the KV budget) and fully deterministic, so fidelity
reports are reproducible across machines: every clock involved is
virtual.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.profiles import HardwareProfile, profile_to_json
from repro_torch.models import params as params_lib
from repro_torch.serving.engine import LLMInstance
from repro_torch.serving.gateway import (EngineClusterAdapter, Gateway,
                                         GatewayConfig, simulator_cluster)
from repro_torch.serving.policies import make_gateway_policy
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import get_scheduler

METRICS = ("ttft", "tbt", "e2e")


@dataclass(frozen=True)
class FidelityConfig:
    """One replayed stream + the serving shape it runs on."""
    n_requests: int = 48
    rate: float = 4.0                  # mean arrival rate (req/s)
    seed: int = 0
    n_instances: int = 2
    n_slots: int = 4
    cache_len: int = 128               # engine KV cache length per slot
    capacity_tokens: int = 400         # profile KV budget (engine-sized)
    # prompts drawn from a FIXED length set (the reference's engine
    # compiles one prefill per distinct length; the streams stay equal)
    prompt_lengths: Tuple[int, ...] = (16, 32, 48, 64)
    decode_range: Tuple[int, int] = (4, 48)
    policy: str = "mixing"
    dt: float = 0.02
    max_time: float = 600.0
    quantiles: Tuple[float, ...] = (0.5, 0.95, 0.99)
    # any core.backends registry names; pairwise deltas are reported
    # for every pair, so the default covers every sim backend and the
    # real engine
    backends: Tuple[str, ...] = ("py", "vec", "jax", "engine")
    # multi-turn session stream + prefix-cache model: follow-up prompts
    # extend the prior turn's context in whole ``prefix_block`` blocks
    # (prompt lengths stay on a bounded ladder of block multiples) and
    # every backend runs a per-instance PrefixCache of
    # ``prefix_cache_tokens``.  Validates that the sim's hit/miss
    # prefill cost tracks the engine's suffix-only virtual clock.
    sessions: bool = False
    prefix_cache_tokens: int = 0
    prefix_block: int = 16
    # saturating stream: arrivals land in back-to-back bursts of
    # ~2*n_slots ladder-top prompts with high-biased decodes, so the
    # resident KV footprint overflows ``capacity_tokens`` and every
    # backend must preempt and queue.  This makes the PREEMPTION path
    # part of the fidelity surface: the report gains per-pair
    # preemption deltas (``both_preempt``: sim and engine preempt
    # alike), not just whether their latencies match when nothing
    # contends.
    saturate: bool = False


def serving_profile(profile: HardwareProfile,
                    fcfg: FidelityConfig) -> HardwareProfile:
    """Clamp a (possibly datacenter-sized) profile to the harness's
    engine-sized serving shape so sim and engine share one budget."""
    return dataclasses.replace(
        profile,
        capacity_tokens=min(profile.capacity_tokens,
                            fcfg.capacity_tokens),
        max_batch=fcfg.n_slots)


def make_stream(fcfg: FidelityConfig) -> List[tuple]:
    """The deterministic arrival stream as (prompt, decode, arrival)
    specs -- each backend materializes its own fresh Request objects.
    With ``fcfg.sessions``, specs are 5-tuples that append the
    per-block (prefix_hashes, full_hashes) chains of a growing
    multi-turn conversation."""
    rng = np.random.default_rng(fcfg.seed)
    if fcfg.saturate:
        # bursts of 2*n_slots simultaneous ladder-top requests: with
        # high-biased decodes the per-request peak KV footprint times
        # n_slots residents exceeds the profile budget, so backends
        # must preempt (and the overflow half of each burst queues)
        g = max(2 * fcfg.n_slots, 2)
        n_groups = -(-fcfg.n_requests // g)
        group_t = np.cumsum(rng.exponential(g / fcfg.rate,
                                            size=n_groups))
        p_top = int(max(fcfg.prompt_lengths))
        lo, hi = fcfg.decode_range
        d_lo = max(lo, hi - max((hi - lo) // 4, 1))
        out = []
        for gi in range(n_groups):
            for j in range(g):
                if len(out) >= fcfg.n_requests:
                    break
                d = int(rng.integers(d_lo, hi + 1))
                out.append((p_top, d, float(group_t[gi]) + j * 1e-3))
        return out
    if not fcfg.sessions:
        gaps = rng.exponential(1.0 / fcfg.rate, size=fcfg.n_requests)
        arrivals = np.cumsum(gaps)
        lengths = rng.choice(fcfg.prompt_lengths, size=fcfg.n_requests)
        lo, hi = fcfg.decode_range
        decodes = rng.integers(lo, hi + 1, size=fcfg.n_requests)
        return [(int(p), int(d), float(t))
                for p, d, t in zip(lengths, decodes, arrivals)]
    B = fcfg.prefix_block
    # context ladder bounded to few prompt lengths, and every turn fits
    # the engine-sized KV budget
    max_blocks = min(int(fcfg.capacity_tokens * 0.9) // B, 10)
    n_sessions = max(fcfg.n_requests // 3, 1)
    starts = np.cumsum(rng.exponential(3.0 / fcfg.rate,
                                       size=n_sessions))
    out: List[tuple] = []
    sid = 0
    while len(out) < fcfg.n_requests:
        t = float(starts[sid % n_sessions]) + (sid // n_sessions) * 30.0
        chain: List[tuple] = []
        p_blocks = int(rng.integers(1, 3))
        for _turn in range(int(rng.integers(2, 5))):
            d_blocks = int(rng.integers(1, 3))
            if p_blocks + d_blocks > max_blocks:
                break
            while len(chain) < p_blocks + d_blocks:
                chain.append((fcfg.seed, sid, len(chain)))
            out.append((p_blocks * B, d_blocks * B, t,
                        tuple(chain[:p_blocks]),
                        tuple(chain[:p_blocks + d_blocks])))
            t += 1.0 + float(rng.exponential(1.0))
            p_blocks = p_blocks + d_blocks + 1
        sid += 1
    out.sort(key=lambda x: x[2])
    return out[:fcfg.n_requests]


def _requests(stream: Sequence[tuple]) -> List[Request]:
    out = []
    for spec in stream:
        p, d, t = spec[:3]
        hashes = spec[3:] if len(spec) > 3 else (None, None)
        out.append(Request(prompt_tokens=p, decode_tokens=d, arrival=t,
                           tenant="fidelity", prefix_hashes=hashes[0],
                           full_hashes=hashes[1]))
    return out


def _gateway_cfg(fcfg: FidelityConfig, backend: str) -> GatewayConfig:
    return GatewayConfig(dt=fcfg.dt, n_slots=fcfg.n_slots,
                         max_time=fcfg.max_time,
                         backend=backend if backend != "engine" else "py",
                         prefix_cache_tokens=fcfg.prefix_cache_tokens,
                         prefix_block=fcfg.prefix_block)


def _percentiles(vals: List[float], quantiles: Sequence[float]) -> Dict:
    out = {}
    arr = np.array([v for v in vals if v is not None], float)
    for q in quantiles:
        key = f"p{int(q * 100)}"
        out[key] = float(np.quantile(arr, q)) if arr.size else None
    out["mean"] = float(arr.mean()) if arr.size else None
    out["n"] = int(arr.size)
    return out


def _backend_cluster(backend: str, profile: HardwareProfile,
                     fcfg: FidelityConfig, model_cfg, params, device):
    if backend != "engine":
        return simulator_cluster(_gateway_cfg(fcfg, backend),
                                 (profile,) * fcfg.n_instances,
                                 device=device)
    if params is None:
        if model_cfg is None:
            raise ValueError("backend 'engine' needs model_cfg (and "
                             "optionally params)")
        dev = resolve_device(device)
        params = params_lib.init_params(
            model_cfg, torch.Generator(device=dev).manual_seed(0),
            device=dev)
    dev = params["embed"].device
    engines = [LLMInstance(model_cfg, params, profile,
                           get_scheduler("fcfs"), n_slots=fcfg.n_slots,
                           cache_len=fcfg.cache_len, instance_id=i,
                           prefix_cache_tokens=fcfg.prefix_cache_tokens,
                           prefix_block=fcfg.prefix_block, device=dev)
               for i in range(fcfg.n_instances)]
    return EngineClusterAdapter(engines, dt=fcfg.dt)


def run_backend(backend: str, profile: HardwareProfile,
                fcfg: FidelityConfig, stream, model_cfg=None,
                params=None, device="cuda") -> Dict:
    """Serve the stream on one backend; returns the percentile report.
    The engine backend runs on the device ``params`` live on, or builds
    seeded parameters on ``device`` when ``params`` is None; the ``jax``
    simulator runs on ``device``."""
    prof = serving_profile(profile, fcfg)
    reqs = _requests(stream)
    cluster = _backend_cluster(backend, prof, fcfg, model_cfg, params,
                               device)
    gw = Gateway(_gateway_cfg(fcfg, backend),
                 (prof,) * fcfg.n_instances,
                 make_gateway_policy(fcfg.policy), cluster=cluster)
    stats = gw.run(reqs)
    done = [r for r in reqs if r.finished is not None]
    report = {m: _percentiles([getattr(r, m) for r in done],
                              fcfg.quantiles) for m in METRICS}
    report["completed"] = len(done)
    report["preemptions"] = int(sum(r.preemptions for r in reqs))
    report["makespan"] = (max(r.finished for r in done)
                          - min(r.arrival for r in done)) if done else None
    report["shed"] = stats["shed"]
    caches = [getattr(inst, "prefix_cache", None)
              for inst in gw.cluster.instances]
    hit = sum(c.hit_tokens for c in caches if c is not None)
    look = sum(c.lookup_tokens for c in caches if c is not None)
    report["cache_hit_rate"] = (hit / look) if look else None
    return report


def _deltas(a: Dict, b: Dict, quantiles: Sequence[float]) -> Dict:
    """Per-metric percentile deltas b - a (absolute and relative)."""
    out = {}
    for m in METRICS:
        md = {}
        for q in quantiles:
            key = f"p{int(q * 100)}"
            va, vb = a[m].get(key), b[m].get(key)
            if va is None or vb is None:
                md[key] = {"abs": None, "rel": None}
            else:
                md[key] = {"abs": vb - va,
                           "rel": (vb - va) / va if va else None}
        out[m] = md
    # preemption fidelity: do both backends preempt, and comparably?
    pa, pb = a["preemptions"], b["preemptions"]
    out["preemptions"] = {"a": pa, "b": pb, "abs": pb - pa,
                          "both_preempt": bool(pa > 0 and pb > 0)}
    return out


def run_fidelity(profile: HardwareProfile,
                 fcfg: Optional[FidelityConfig] = None,
                 model_cfg=None, params=None, device="cuda") -> Dict:
    """The harness: one stream, every configured backend, all pairwise
    percentile deltas.  ``model_cfg``/``params`` (or ``device``) are
    only read when ``fcfg.backends`` includes ``"engine"``; ``device``
    also places the ``jax`` simulator."""
    fcfg = fcfg or FidelityConfig()
    stream = make_stream(fcfg)
    backends = {}
    for backend in fcfg.backends:
        backends[backend] = run_backend(backend, profile, fcfg, stream,
                                        model_cfg, params, device)
    deltas = {}
    names = list(fcfg.backends)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            deltas[f"{b}_vs_{a}"] = _deltas(backends[a], backends[b],
                                            fcfg.quantiles)
    return {
        "profile": profile_to_json(serving_profile(profile, fcfg)),
        "config": dataclasses.asdict(fcfg),
        "backends": backends,
        "deltas": deltas,
    }


def save_report(report: Dict, path: str):
    with open(path, "w") as f:
        json.dump(report, f, indent=2)


def format_report(report: Dict) -> str:
    """Human-readable fidelity table (per-backend percentiles + the
    headline engine-vs-sim deltas)."""
    lines = []

    def f(v):
        return f"{v:8.3f}" if v is not None else "       -"
    for name, rep in report["backends"].items():
        lines.append(
            f"{name:>7s}  n={rep['completed']:<3d} "
            f"e2e p50/p95={f(rep['e2e']['p50'])}{f(rep['e2e']['p95'])}  "
            f"ttft p95={f(rep['ttft']['p95'])}  "
            f"tbt p95={f(rep['tbt']['p95'])}  "
            f"preempt={rep['preemptions']}")
    for pair, d in report["deltas"].items():
        e95 = d["e2e"]["p95"]["rel"]
        t95 = d["ttft"]["p95"]["rel"]
        lines.append(f"{pair:>16s}: e2e p95 rel delta="
                     f"{e95:+.3f}" if e95 is not None else
                     f"{pair:>16s}: e2e p95 rel delta=-")
        if t95 is not None:
            lines[-1] += f"  ttft p95 rel delta={t95:+.3f}"
    return "\n".join(lines)
