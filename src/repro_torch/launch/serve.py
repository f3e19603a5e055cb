"""Serving launcher of the PyTorch port: real LLM engines behind the
paper's router (twin of ``repro.launch.serve``'s ``--mode engine`` and
``--mode gateway --backend engine`` paths).

  # reduced engines on the card (the default device), impact heuristic
  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
      --requests 12

  # the online gateway over reduced real engines, any gateway policy
  # (rr|jsq|mixing|mixing+cache|sticky|rl), with chaos and failover
  PYTHONPATH=src python -m repro_torch.launch.serve --mode gateway \
      --backend engine --policy mixing --requests 12 \
      --chaos-seed 7 --failover

  # the same on the CPU (attention through the kernels' plain versions)
  PYTHONPATH=src python -m repro_torch.launch.serve --mode gateway \
      --backend engine --requests 12 --device cpu

The simulator mode, the gateway over the simulators, online learning,
calibration and the trace/metrics export come with later slices of the
port; asking for them exits with a message saying so.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import impact, rl_router as rl
from repro_torch.core.profiles import V100_LLAMA2_7B, load_profile
from repro_torch.models import params as params_lib
from repro_torch.serving import trace as trace_lib
from repro_torch.serving.chaos import FaultSchedule
from repro_torch.serving.engine import LLMInstance
from repro_torch.serving.gateway import (EngineClusterAdapter, Gateway,
                                         GatewayConfig)
from repro_torch.serving.metrics import format_snapshot
from repro_torch.serving.policies import (make_gateway_policy,
                                          restore_rl_policy)
from repro_torch.serving.request import Request, summarize
from repro_torch.serving.scheduler import get_scheduler

LATER = "comes with a later slice of the PyTorch port"


def _base_profile(args):
    """The serving profile: a calibrated JSON artifact when given,
    else the paper's V100 calibration."""
    if getattr(args, "profile_json", None):
        return load_profile(args.profile_json)
    return V100_LLAMA2_7B


def _tiny_engines(args, capacity: int = 400) -> List[LLMInstance]:
    """Reduced-config engines sharing one seeded set of weights (the
    reference's defaults: 4 slots, 128-token caches)."""
    dev = resolve_device(getattr(args, "device", "cuda"))
    cfg = get_config(args.arch).reduced()
    base = _base_profile(args)
    prof = dataclasses.replace(
        base, capacity_tokens=min(base.capacity_tokens, capacity))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = params_lib.init_params(cfg, gen, device=dev)
    return [LLMInstance(cfg, params, prof,
                        get_scheduler(args.scheduler), n_slots=4,
                        cache_len=128, instance_id=i,
                        prefix_cache_tokens=args.prefix_cache,
                        prefix_block=args.prefix_block, device=dev)
            for i in range(args.instances)]


def engine_requests(n: int) -> List[Request]:
    """The reference's ``--mode engine`` stream: seeded prompt lengths
    10-79 and decode lengths 5-59."""
    rng = np.random.default_rng(0)
    return [Request(prompt_tokens=int(rng.integers(10, 80)),
                    decode_tokens=int(rng.integers(5, 60)))
            for _ in range(n)]


def serve_engine(args, insts: Optional[List[LLMInstance]] = None,
                 reqs: Optional[List[Request]] = None) -> dict:
    """Route each request by the impact heuristic (Eq. 1-2) across the
    engines, step them to completion, print and return ``summarize``.
    Callers may hand in their own engines and requests; by default the
    reduced ``--arch`` engines serve the reference's request stream."""
    if insts is None:
        insts = _tiny_engines(args)
    if reqs is None:
        reqs = engine_requests(args.requests)
    prof = insts[0].profile
    for r in reqs:   # impact-heuristic routing (Eq. 1-2)
        scores = impact.mixing_per_instance(
            prof, r.prompt_tokens, r.decode_tokens,
            [i.resident_tokens() for i in insts])
        insts[int(np.argmax(scores))].submit(r)
        for inst in insts:
            inst.step()
    while sum(len(i.completed) for i in insts) < len(reqs):
        if not any(inst.queue or any(inst.slots) for inst in insts):
            break
        for inst in insts:
            inst.step()
    stats = summarize(reqs)
    print(stats)
    return stats


def _router_cfg(args) -> rl.RouterConfig:
    """The reference launcher's router configuration, serving fields."""
    return rl.RouterConfig(variant="guided", n_instances=args.instances,
                           q_arch="decomposed", seed=0,
                           cache_weight=(0.5 if args.prefix_cache
                                         else 0.0),
                           include_cache_features=bool(
                               args.prefix_cache))


def _chaos_schedule(args) -> Optional[FaultSchedule]:
    """--chaos-seed: build the seeded FaultSchedule for this run."""
    if args.chaos_seed is None:
        return None
    horizon = args.requests / max(args.rate, 1e-9)
    return FaultSchedule.random(
        seed=args.chaos_seed, m=args.instances, horizon=horizon,
        n_crashes=args.chaos_crashes,
        n_stragglers=args.chaos_stragglers,
        n_bursts=args.chaos_bursts)


def gateway_requests(n: int) -> List[Request]:
    """The reference's ``--mode gateway --backend engine`` stream:
    seeded prompt lengths 10-79, decode lengths 5-59, one arrival every
    0.05 s."""
    rng = np.random.default_rng(0)
    return [Request(prompt_tokens=int(rng.integers(10, 80)),
                    decode_tokens=int(rng.integers(5, 60)),
                    arrival=float(i) * 0.05, tenant="engine")
            for i in range(n)]


def serve_gateway(args, engines: Optional[List[LLMInstance]] = None,
                  policy=None, reqs: Optional[List[Request]] = None
                  ) -> dict:
    """The online gateway over real engines (``--backend engine``):
    admission, shedding/deferral, the routing policy, chaos and failover
    in front of ``LLMInstance`` replicas.  Callers may hand in their own
    engines, policy and request stream; by default the reduced ``--arch``
    engines serve the reference's stream under ``--policy``.  Prints the
    reference's summary lines and returns the gateway's stats."""
    if args.backend != "engine":
        sys.exit(f"--mode gateway --backend {args.backend}: the gateway "
                 f"over the simulators {LATER}; this port serves "
                 "--backend engine")
    if args.online:
        raise SystemExit("--online needs a simulator backend "
                         "(py/vec): the engine adapter fires no "
                         "decode events for the backlog reward)")
    if args.metrics_out:
        sys.exit(f"--metrics-out: the metrics export (serving/obs.py) "
                 f"{LATER}")
    cfg = _router_cfg(args)
    chaos = _chaos_schedule(args)
    gcfg = GatewayConfig(queue_cap=args.queue_cap, on_full=args.on_full,
                         scheduler=args.scheduler,
                         chunked_prefill=args.chunked_prefill,
                         backend="py",
                         default_deadline_s=args.deadline,
                         prefix_cache_tokens=args.prefix_cache,
                         prefix_block=args.prefix_block,
                         chaos=chaos, failover=args.failover,
                         max_retries=args.max_retries,
                         hedge_after_s=args.hedge_after)
    recorder = (trace_lib.TraceRecorder(sample=args.trace_sample)
                if args.trace else None)
    if engines is None:
        engines = _tiny_engines(args)
    if policy is None:
        policy_name = args.policy
        if policy_name == "rl":
            if args.checkpoint:
                policy = restore_rl_policy(cfg, args.checkpoint,
                                           m=args.instances)
            else:
                print("WARNING: --backend engine --policy rl needs "
                      "--checkpoint (no simulator to train on); "
                      "falling back to the mixing policy")
                policy_name = "mixing"
                policy = make_gateway_policy(policy_name, cfg)
        else:
            policy = make_gateway_policy(policy_name, cfg)
    gw = Gateway(gcfg, None, policy, cluster=EngineClusterAdapter(engines),
                 trace=recorder)
    if reqs is None:
        reqs = gateway_requests(args.requests)
    stats = gw.run(reqs)
    print(f"policy={stats['policy']} served n={stats['n']} "
          f"admitted={stats['admitted']} shed={stats['shed']} "
          f"preemptions={stats['preemptions']}")
    if chaos is not None or args.failover:
        print(f"chaos: orphaned={stats['orphaned']} "
              f"retried={stats['retried']} hedged={stats['hedged']} "
              f"breaker_trips={stats.get('breaker_trips', 0)}")
    print(format_snapshot(stats["snapshot"]))
    if recorder is not None:
        print(f"recorded {len(recorder.events())} trace events "
              f"({recorder.dropped} dropped); writing {args.trace} "
              f"(serving/obs.py) {LATER}")
    return stats


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags that the engine paths read, plus
    ``--device``.  The simulator-only flags (``--sessions``,
    ``--drift``, ``--pattern``, the online and calibration settings)
    come with the slices that port those modes, so argparse rejects
    them here."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("sim", "engine", "gateway"),
                    default="engine")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines and the RL "
                    "router ('cuda' needs a card; 'cpu' runs the "
                    "kernels' plain versions)")
    ap.add_argument("--backend",
                    choices=("sim", "py", "vec", "jax", "engine"),
                    default="sim",
                    help="gateway cluster backend; the port serves "
                    "'engine' (real engines), the simulator backends "
                    "come with a later slice")
    ap.add_argument("--policy", default="mixing",
                    choices=("rl", "mixing", "mixing+cache", "jsq",
                             "rr", "sticky"),
                    help="gateway routing policy")
    ap.add_argument("--queue-cap", type=int, default=0,
                    help="admission queue bound (0 = unbounded)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="client timeout in seconds (deferred requests "
                    "past it are cancelled)")
    ap.add_argument("--on-full", default="shed",
                    choices=("shed", "defer"))
    ap.add_argument("--checkpoint", default=None,
                    help="router checkpoint dir for --policy rl")
    ap.add_argument("--online", action="store_true",
                    help="gateway: continual learning on the live "
                    "stream (needs a simulator backend)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="gateway: inject a seeded FaultSchedule "
                    "(serving.chaos) of crashes / stragglers / tenant "
                    "bursts into the run")
    ap.add_argument("--chaos-crashes", type=int, default=1,
                    help="crash+restart events in the schedule")
    ap.add_argument("--chaos-stragglers", type=int, default=1,
                    help="straggler slowdown windows in the schedule")
    ap.add_argument("--chaos-bursts", type=int, default=0,
                    help="correlated tenant-burst windows")
    ap.add_argument("--failover", action="store_true",
                    help="gateway failover: crash orphans re-enter "
                    "admission with bounded retries + backoff; health "
                    "tracker / circuit breaker filters candidates")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="failover retry budget per request")
    ap.add_argument("--hedge-after", type=float, default=None,
                    metavar="SECONDS",
                    help="hedged re-dispatch: withdraw a routed "
                    "request still tokenless after this long and "
                    "re-route it (None = off)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="gateway: record request lifecycle spans into "
                    "a TraceRecorder (the export to PATH comes with a "
                    "later slice)")
    ap.add_argument("--trace-sample", type=float, default=1.0,
                    help="head-sampling fraction of requests traced")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="gateway: metrics registry export (a later "
                    "slice)")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit a HardwareProfile from the engine (a "
                    "later slice)")
    ap.add_argument("--profile-json", default=None,
                    help="serve with the profile loaded from this JSON "
                    "instead of the default V100 calibration")
    ap.add_argument("--prefix-cache", type=int, default=0,
                    help="per-instance prefix/KV cache budget in "
                    "tokens (0 = cache model off)")
    ap.add_argument("--prefix-block", type=int, default=32,
                    help="prefix-cache hash-block size in tokens")
    ap.add_argument("--arch", default="llama-2-7b")
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--scheduler", default="fcfs")
    ap.add_argument("--chunked-prefill", type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.calibrate:
        sys.exit(f"--calibrate {LATER}")
    if args.mode == "sim":
        sys.exit(f"--mode sim {LATER}; the port serves --mode engine and "
                 "--mode gateway --backend engine")
    if args.mode == "gateway":
        serve_gateway(args)
    else:
        serve_engine(args)


if __name__ == "__main__":
    main()
