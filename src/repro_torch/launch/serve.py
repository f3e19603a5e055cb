"""Serving launcher of the PyTorch port: the paper's router over the
calibrated simulator or real LLM engines (twin of
``repro.launch.serve``).  Everything runs on the card unless
``--device cpu`` is given.

  # closed-loop simulator episode: train the router, then serve
  PYTHONPATH=src python -m repro_torch.launch.serve --mode sim \
      --requests 400

  # online gateway over the simulator: open-loop multi-tenant stream,
  # pluggable policy, the learned length predictor in the loop, rolling
  # SLO metrics; --policy rl trains the router first, or restores it
  # with --checkpoint DIR
  PYTHONPATH=src python -m repro_torch.launch.serve --mode gateway \
      --policy rl|mixing|jsq|rr --pattern bursty --queue-cap 64

  # same, with lifecycle tracing + metrics export (serving.obs):
  # trace.json opens in Perfetto, metrics.json/.prom is the scrape
  PYTHONPATH=src python -m repro_torch.launch.serve --mode gateway \
      --trace trace.json --metrics-out metrics.json

  # the same gateway over the vectorized simulator, and ONLINE
  # continual learning: the gateway trains its own router on the live
  # stream with the r_mixing safe-fallback guardrail (--drift serves the
  # mix-flip scenario; --checkpoint warm-starts the learner)
  PYTHONPATH=src python -m repro_torch.launch.serve --mode gateway \
      --backend vec --online --guardrail 0.12 --drift

  # the gateway over reduced real engines, any gateway policy
  # (rr|jsq|mixing|mixing+cache|sticky|rl --checkpoint DIR), with chaos
  # and failover
  PYTHONPATH=src python -m repro_torch.launch.serve --mode gateway \
      --backend engine --policy mixing --requests 12 \
      --chaos-seed 7 --failover

  # reduced engines, impact-heuristic routing
  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
      --requests 12

  # calibrate a HardwareProfile from the reduced --arch engine
  # (core.calibrate): sweep + fit, print diagnostics, write the JSON
  # artifact; --min-r2 makes a loose fit a non-zero exit
  PYTHONPATH=src python -m repro_torch.launch.serve --calibrate \
      --arch qwen3-0.6b --profile-json profile.json --min-r2 0.95

  # serve on a calibrated profile instead of the V100 default
  PYTHONPATH=src python -m repro_torch.launch.serve --mode gateway \
      --profile-json profile.json

``--backend jax`` serves over the device-resident simulator pool
(``core.jaxsim``) on ``--device``.  The gateway advances one tick a
call, under the pool's default 8-tick minimum span (``min_span_ticks``),
so per-tick serving runs the pool's inherited numpy rounds, as ``--backend
vec`` does; the round loop's kernel (its plain version on the CPU) runs
only for spans of 8 ticks or more, as the pooled trainer's.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import warnings
from typing import List, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import calibrate as cal
from repro_torch.core import impact, rl_router as rl
from repro_torch.core import workload as wl
from repro_torch.core.cluster_manager import (ManagedCluster,
                                              ManagedClusterConfig)
from repro_torch.core.predictor import quick_bucket_predictor
from repro_torch.core.profiles import V100_LLAMA2_7B
from repro_torch.models import params as params_lib
from repro_torch.serving import obs
from repro_torch.serving import trace as trace_lib
from repro_torch.serving.chaos import FaultSchedule, inject_bursts
from repro_torch.serving.engine import LLMInstance
from repro_torch.serving.gateway import (EngineClusterAdapter, Gateway,
                                         GatewayConfig, MicroBatchPredictor,
                                         simulator_cluster)
from repro_torch.serving.metrics import format_snapshot
from repro_torch.serving.policies import (RLPolicy, make_gateway_policy,
                                          restore_rl_policy)
from repro_torch.serving.request import Request, summarize
from repro_torch.serving.scheduler import get_scheduler
from repro_torch.training.online import OnlineConfig, OnlineTrainer

def _base_profile(args):
    """The serving profile: a calibrated JSON artifact when given (under
    ``--calibrate`` that path is the output, not an input), else the
    paper's V100 calibration."""
    if (getattr(args, "profile_json", None)
            and not getattr(args, "calibrate", False)):
        return cal.load_profile(args.profile_json)
    return V100_LLAMA2_7B


def run_calibrate(args) -> int:
    """--calibrate: sweep the reduced engine for --arch on --device, fit
    a profile, print diagnostics, optionally write --profile-json.
    Non-zero exit when the fit misses --min-r2 or the gradient sanity
    ordering.  On the CPU, torch runs the sweep on one intra-op thread
    (restored afterwards), as the reference pins XLA's."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = params_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    threads = torch.get_num_threads()
    if dev.type == "cpu":
        torch.set_num_threads(1)
    try:
        res = cal.calibrate(cfg, params)
    finally:
        torch.set_num_threads(threads)
    print(cal.format_result(res))
    if args.profile_json:
        res.save(args.profile_json)
        print(f"wrote {args.profile_json}")
    failures = []
    if res.prefill_fit.r2 < args.min_r2:
        failures.append(f"prefill R^2 {res.prefill_fit.r2:.4f} "
                        f"< {args.min_r2}")
    if res.decode_fit.r2 < args.min_r2:
        failures.append(f"decode R^2 {res.decode_fit.r2:.4f} "
                        f"< {args.min_r2}")
    if not res.ok:
        failures.append("gradient sanity (grad1 > grad2 > 0) failed")
    for f in failures:
        print(f"CALIBRATION GATE: {f}")
    return 1 if failures else 0


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
    # the online learner gets the health features: under chaos they
    # carry the straggler/degradation signal it adapts to
    return rl.RouterConfig(variant="guided", n_instances=args.instances,
                           q_arch="decomposed", seed=0,
                           explore_episodes=max(args.train_episodes - 3,
                                                1),
                           scheduler=args.scheduler,
                           chunked_prefill=args.chunked_prefill,
                           prefix_cache_tokens=args.prefix_cache,
                           prefix_block=args.prefix_block,
                           cache_weight=(0.5 if args.prefix_cache
                                         else 0.0),
                           include_cache_features=bool(
                               args.prefix_cache),
                           include_health_features=args.online)


def _train_quick_agent(args, cfg: rl.RouterConfig, profile=None,
                       agent=None) -> dict:
    """Train the router on ``--train-episodes`` simulator episodes of
    ``--requests`` at ``--rate`` (a fresh agent on ``--device`` unless
    one is given); returns ``rl.train``'s ``{"agent", "history"}``."""
    return rl.train(cfg, profile or V100_LLAMA2_7B,
                    lambda ep: wl.to_requests(
                        wl.generate(args.requests, seed=ep), rate=args.rate,
                        seed=ep + 50),
                    n_episodes=args.train_episodes, agent=agent,
                    device=args.device)


def serve_sim(args, agent=None) -> dict:
    """--mode sim: the closed-loop path (``ManagedCluster.serve``) over
    the simulator, routed by ``agent`` (trained here unless given);
    prints and returns the episode's stats."""
    resolve_device(args.device)
    cfg = _router_cfg(args)
    base = _base_profile(args)
    if agent is None:
        agent = _train_quick_agent(args, cfg, base)["agent"]
    mgr = ManagedCluster(ManagedClusterConfig(n_instances=args.instances),
                         cfg, base, agent)
    reqs = wl.to_requests(wl.generate(args.requests, seed=991),
                          rate=args.rate, seed=992)
    stats = mgr.serve(reqs)
    print(f"served n={stats['n']} e2e={stats['e2e_mean']:.2f}s "
          f"ttft={stats['ttft_mean']:.2f}s "
          f"preemptions={stats['preemptions']}")
    return stats


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


def _resolve_backend(args) -> str:
    """Map the CLI flags onto one ``core.backends`` registry name.
    ``--backend`` names it directly ('sim' is the legacy alias for the
    ``py`` stepper); ``--sim-backend`` is the deprecated spelling and
    wins when set."""
    backend = "py" if args.backend == "sim" else args.backend
    if args.sim_backend is not None:
        warnings.warn(
            "--sim-backend is deprecated; use --backend py|vec|jax",
            DeprecationWarning, stacklevel=2)
        if args.backend in ("sim", args.sim_backend):
            backend = args.sim_backend
    return backend


#: flags only the simulator-backed gateway reads (dest names)
SIM_ONLY = ("pattern", "sessions", "drift", "train_episodes",
            "sim_backend")
#: flags only ``--online`` reads (dest names)
ONLINE_ONLY = ("guardrail", "online_eps", "save_learner")
#: flags only ``--calibrate`` reads (dest names)
CALIBRATE_ONLY = ("min_r2",)


def _given(args, dests) -> List[str]:
    """The flags among ``dests`` set to other than their defaults."""
    defaults = build_parser()
    return ["--" + d.replace("_", "-") for d in dests
            if getattr(args, d) != defaults.get_default(d)]


def serve_gateway(args, engines: Optional[List[LLMInstance]] = None,
                  policy=None, reqs: Optional[List[Request]] = None
                  ) -> dict:
    """The online gateway over the ``py`` or ``vec`` simulator (the
    learned length predictor in the loop; ``--online`` trains the router
    on the live stream) or over real engines (``--backend engine``):
    admission, shedding/deferral, the routing policy, chaos and failover.
    Over engines, callers may hand in their own engines, policy and
    request stream; by default the reduced ``--arch`` engines serve the
    reference's stream under ``--policy``.  Prints the reference's
    summary lines, writes ``--trace`` / ``--metrics-out``, and returns
    the gateway's stats (with the predictor's counters under
    ``"predictor"`` over the simulator, and the online learner's
    telemetry under ``"online"``)."""
    backend = _resolve_backend(args)
    if args.online and backend == "engine":
        raise SystemExit("--online needs a simulator backend "
                         "(py/vec): the engine adapter fires no "
                         "decode events for the backlog reward)")
    if backend == "engine":
        given = _given(args, SIM_ONLY)
        if given:
            sys.exit(f"{', '.join(given)}: read only over the simulator "
                     "(--backend py|vec|jax), not over --backend engine")
    dev = resolve_device(args.device)
    cfg = _router_cfg(args)
    chaos = _chaos_schedule(args)
    gcfg = GatewayConfig(queue_cap=args.queue_cap, on_full=args.on_full,
                         scheduler=args.scheduler,
                         chunked_prefill=args.chunked_prefill,
                         backend=backend,
                         default_deadline_s=args.deadline,
                         prefix_cache_tokens=args.prefix_cache,
                         prefix_block=args.prefix_block,
                         attribution=bool(args.metrics_out),
                         chaos=chaos, failover=args.failover,
                         max_retries=args.max_retries,
                         hedge_after_s=args.hedge_after)
    recorder = (trace_lib.TraceRecorder(sample=args.trace_sample)
                if args.trace else None)
    length = None
    trainer = None
    if backend == "engine":
        if engines is None:
            engines = _tiny_engines(args)
        if policy is None:
            policy_name = args.policy
            if policy_name == "rl":
                if args.checkpoint:
                    policy = restore_rl_policy(cfg, args.checkpoint,
                                               m=args.instances, device=dev)
                else:
                    print("WARNING: --backend engine --policy rl needs "
                          "--checkpoint (no simulator to train on); "
                          "falling back to the mixing policy")
                    policy_name = "mixing"
                    policy = make_gateway_policy(policy_name, cfg)
            else:
                policy = make_gateway_policy(policy_name, cfg)
        gw = Gateway(gcfg, None, policy,
                     cluster=EngineClusterAdapter(engines), trace=recorder)
        if reqs is None:
            reqs = gateway_requests(args.requests)
        stats = gw.run(reqs)
    else:
        base = _base_profile(args)
        profiles = (base,) * args.instances
        sessions = (wl.SessionConfig(block=args.prefix_block)
                    if args.sessions else None)
        if args.drift:
            scn = wl.make_drift_scenario(seed=7,
                                         n_requests=args.requests,
                                         rate=args.rate,
                                         pattern=args.pattern,
                                         profiles=profiles)
            if chaos is None and scn.meta["chaos"] is not None:
                chaos = scn.meta["chaos"]
                gcfg = dataclasses.replace(gcfg, chaos=chaos,
                                           failover=True)
        else:
            scn = wl.make_tenant_scenario(seed=7,
                                          n_requests=args.requests,
                                          rate=args.rate,
                                          pattern=args.pattern,
                                          profiles=profiles,
                                          sessions=sessions)
        length = MicroBatchPredictor(quick_bucket_predictor(
            base, n_train=2000, epochs=2, device=dev))
        if args.online:
            ocfg = OnlineConfig(eps=args.online_eps,
                                guard=args.guardrail > 0,
                                guard_regret=args.guardrail,
                                warm_start=args.checkpoint,
                                checkpoint_dir=args.save_learner,
                                checkpoint_every=(500 if args.save_learner
                                                  else 0))
            trainer = OnlineTrainer(cfg, ocfg, m=args.instances,
                                    device=dev)
            policy = trainer.policy
        elif args.policy == "rl":
            if args.checkpoint:
                policy = restore_rl_policy(cfg, args.checkpoint,
                                           m=args.instances, device=dev)
            else:
                policy = RLPolicy(
                    _train_quick_agent(args, cfg, base)["agent"], cfg)
        else:
            policy = make_gateway_policy(args.policy, cfg)
        gw = Gateway(gcfg, profiles, policy, length=length,
                     cluster=simulator_cluster(gcfg, profiles, recorder,
                                               device=dev),
                     trace=recorder)
        try:
            if chaos is not None and chaos.bursts:
                reqs = inject_bursts(scn.requests, chaos,
                                     seed=args.chaos_seed)
                samples = list(scn.samples) + [None] * (
                    len(reqs) - len(scn.requests))
                stats = gw.run(reqs, samples=samples)
            else:
                stats = gw.run(scn)
        finally:
            if trainer is not None:
                trainer.close()     # the checkpoint writer, if any
    print(f"policy={stats['policy']} served n={stats['n']} "
          f"admitted={stats['admitted']} shed={stats['shed']} "
          f"preemptions={stats['preemptions']}")
    if chaos is not None or args.failover:
        print(f"chaos: orphaned={stats['orphaned']} "
              f"retried={stats['retried']} hedged={stats['hedged']} "
              f"breaker_trips={stats.get('breaker_trips', 0)}")
    if length is not None:
        stats["predictor"] = {"hits": length.hits, "misses": length.misses,
                              "forwards": length.forwards}
        print(f"predictor: hits={length.hits} misses={length.misses} "
              f"forwards={length.forwards}")
    if trainer is not None:
        t = trainer.telemetry()
        stats["online"] = t
        print(f"online: decisions={int(t['decisions'])} "
              f"transitions={int(t['transitions'])} "
              f"learner_steps={trainer.agent.steps} "
              f"publishes={int(t['publishes'])} "
              f"explored={int(t['explored'])} "
              f"fallback_entries={int(t['fallback_entries'])} "
              f"mode={t['mode']}")
    print(format_snapshot(stats["snapshot"]))
    if args.trace:
        doc = obs.write_trace(recorder, args.trace,
                              title=f"gateway-{stats['policy']}")
        print(f"wrote {args.trace} ({len(doc['traceEvents'])} trace "
              f"events, {recorder.dropped} dropped)")
    if args.metrics_out:
        reg = obs.MetricsRegistry()
        reg.ingest_snapshot(stats["snapshot"])
        telemetry = getattr(getattr(gw.policy, "agent", None),
                            "telemetry", None)
        if telemetry is not None:
            reg.ingest_rl(telemetry())
        reg.save(args.metrics_out)
        print(f"wrote {args.metrics_out} ({len(reg)} metrics)")
    return stats


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags that the ported modes read, plus
    ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("sim", "engine", "gateway"),
                    default="sim")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the router, the length "
                    "predictor and the engines ('cuda' needs a card; "
                    "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--backend",
                    choices=("sim", "py", "vec", "jax", "engine"),
                    default="sim",
                    help="gateway cluster backend: any name from the "
                    "core.backends registry ('py' (or its legacy alias "
                    "'sim'), 'vec' and 'jax' (on --device) pick the "
                    "simulator, 'engine' runs reduced real engines)")
    ap.add_argument("--policy", default="mixing",
                    choices=("rl", "mixing", "mixing+cache", "jsq",
                             "rr", "sticky"),
                    help="gateway routing policy")
    ap.add_argument("--pattern", default="bursty",
                    choices=("poisson", "bursty", "diurnal"))
    ap.add_argument("--queue-cap", type=int, default=0,
                    help="admission queue bound (0 = unbounded)")
    ap.add_argument("--sim-backend", choices=("py", "vec", "jax"),
                    default=None,
                    help="DEPRECATED alias: use --backend py|vec|jax")
    ap.add_argument("--deadline", type=float, default=None,
                    help="client timeout in seconds (deferred requests "
                    "past it are cancelled)")
    ap.add_argument("--on-full", default="shed",
                    choices=("shed", "defer"))
    ap.add_argument("--prefix-cache", type=int, default=0,
                    help="per-instance prefix/KV cache budget in "
                    "tokens (0 = cache model off); enables the "
                    "cache-affinity policies and RL state feature")
    ap.add_argument("--prefix-block", type=int, default=32,
                    help="prefix-cache hash-block size in tokens")
    ap.add_argument("--sessions", action="store_true",
                    help="gateway: multi-turn conversation workload "
                    "(follow-up prompts extend prior turns; tenants "
                    "share system prompts) instead of independent "
                    "queries")
    ap.add_argument("--checkpoint", default=None,
                    help="router checkpoint dir for --policy rl (and "
                    "the warm-start source for --online)")
    ap.add_argument("--online", action="store_true",
                    help="gateway: continual learning on the live "
                    "stream (training.online) -- the router trains on "
                    "its own transitions between arrival windows and "
                    "hot-swaps refreshed weights without pausing "
                    "admission; implies the RL policy with health "
                    "features")
    ap.add_argument("--guardrail", type=float, default=0.12,
                    metavar="REGRET",
                    help="--online safe fallback: when the Q-head's "
                    "mean r_mixing regret over the guard window "
                    "exceeds this, route by r_mixing for a cooldown "
                    "while learning continues (0 = guardrail off)")
    ap.add_argument("--online-eps", type=float, default=0.05,
                    help="--online guided exploration rate (softmax "
                    "over the r_mixing guidance bonus)")
    ap.add_argument("--save-learner", default=None, metavar="DIR",
                    help="--online: periodically checkpoint the FULL "
                    "learner state (Q + target + optimizer + replay) "
                    "here for exact mid-stream resume")
    ap.add_argument("--drift", action="store_true",
                    help="gateway: serve the nonstationary drift "
                    "scenario (mid-stream workload-mix flip + tenant "
                    "churn + straggler/crash chaos) instead of the "
                    "stationary tenant mix")
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
                    help="gateway: record request lifecycle spans and "
                    "write a Chrome trace-event JSON (load in Perfetto "
                    "/ chrome://tracing)")
    ap.add_argument("--trace-sample", type=float, default=1.0,
                    help="head-sampling fraction of requests traced")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="gateway: write the metrics registry (SLO "
                    "snapshot + decision attribution + RL telemetry) "
                    "as JSON, or Prometheus text if PATH ends in "
                    ".prom")
    ap.add_argument("--calibrate", action="store_true",
                    help="sweep the reduced --arch engine on --device "
                    "and fit a HardwareProfile (core.calibrate); prints "
                    "fit diagnostics and exits")
    ap.add_argument("--profile-json", default=None,
                    help="with --calibrate: write the calibrated "
                    "profile artifact here; otherwise: serve with the "
                    "profile loaded from this JSON instead of the "
                    "default V100 calibration")
    ap.add_argument("--min-r2", type=float, default=0.0,
                    help="with --calibrate: exit non-zero unless both "
                    "fits reach this R^2")
    ap.add_argument("--arch", default="llama-2-7b")
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--scheduler", default="fcfs")
    ap.add_argument("--chunked-prefill", type=int, default=0)
    ap.add_argument("--train-episodes", type=int, default=8)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.calibrate:
        sys.exit(run_calibrate(args))
    given = _given(args, CALIBRATE_ONLY)
    if given:
        sys.exit(f"{', '.join(given)}: read only with --calibrate")
    given = [] if args.online else _given(args, ONLINE_ONLY)
    if given:
        sys.exit(f"{', '.join(given)}: read only with --online")
    if args.mode == "sim":
        serve_sim(args)
    elif args.mode == "gateway":
        serve_gateway(args)
    else:
        serve_engine(args)


if __name__ == "__main__":
    main()
