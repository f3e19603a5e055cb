"""Online serving gateway: streaming request router with pluggable
policies, an in-loop length predictor, and rolling SLO metrics.

The closed-loop entry point (``ManagedCluster.serve(reqs)``) consumes a
pre-materialized request list; a production router is an *open-loop*
service -- requests arrive continuously whether or not the cluster is
keeping up, and each must be routed on arrival.  The gateway provides
that loop as a first-class subsystem:

  * an open-loop arrival stream (any ``workload.Scenario`` --
    poisson/bursty/diurnal patterns, multi-tenant task mixes via
    ``workload.make_tenant_scenario``) delivered by simulated wall
    clock, with a bounded admission queue and backpressure: at
    saturation new arrivals are **shed** (rejected, counted per tenant)
    or **deferred** (held in a client-side overflow queue);
  * one ``RoutingPolicy`` decision per tick (``serving.policies``: rr /
    jsq / mixing / rl are one-line swaps), plus the SLA watchdog from
    the RL env (a defer on a request that has waited past
    ``defer_timeout`` is overridden with the best-impact placement);
  * the learned length predictor in the hot path via
    ``MicroBatchPredictor``: arrivals of each tick are predicted in ONE
    padded forward (micro-batching), LRU-cached per prompt content, and
    stamped onto the request as d-hat -- no oracle decode lengths
    anywhere in the routing path;
  * ``serving.metrics.StreamMetrics``: windowed P50/P95/P99
    TTFT/TBT/E2E, per-tenant breakdowns, SLO attainment, shed counters.

With an unbounded queue, the oracle length service, and the RL policy,
the gateway reproduces ``ManagedCluster.serve`` decision for decision
(tests/test_gateway.py) -- the closed-loop path is a special case of
this subsystem.

The gateway fronts either the discrete-event simulator ``Cluster`` or
real ``serving.engine.LLMInstance`` replicas (``EngineClusterAdapter``).

This is the port's copy of ``repro.serving.gateway``.
"""
from __future__ import annotations

import heapq
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import predictor as pred_lib
from repro_torch.core import rl_router as rl
from repro_torch.core import workload as wl
from repro_torch.serving import trace as tr_lib
from repro_torch.serving.chaos import ChaosInjector, FaultSchedule, \
    HealthTracker
from repro_torch.serving.metrics import SLO, StreamMetrics
from repro_torch.serving.request import Phase, Request, summarize


# -- length services --------------------------------------------------------

class OracleLength:
    """Ground-truth decode lengths (parity tests / upper bound)."""
    name = "oracle"

    def prefetch(self, pairs: Sequence[Tuple[Request, object]]):
        pass

    def estimate(self, req: Request) -> int:
        return req.decode_tokens


class MicroBatchPredictor:
    """The learned bucket predictor in the serving hot path.

    ``prefetch`` runs once per arrival window (tick): every new arrival
    whose prompt content is not LRU-cached is encoded and predicted in
    one forward padded to ``batch_pad`` rows -- so the predictor costs
    one pass per window, not one per request, at one fixed shape.
    Results are stamped on the request (``predicted_bucket`` /
    ``predicted_decode``) and cached by prompt content, so repeated
    prompts (retries, templated traffic) skip the network entirely."""
    name = "microbatch"

    def __init__(self, predictor: pred_lib.BucketPredictor,
                 batch_pad: int = 16, cache_size: int = 4096,
                 default_bucket: int = 3):
        self.predictor = predictor
        self.batch_pad = batch_pad
        self.cache_size = cache_size
        self._cache: OrderedDict = OrderedDict()   # key -> (bucket, d_hat)
        self.hits = 0
        self.misses = 0
        self.forwards = 0            # encoder passes
        self.default_d = max(
            int(predictor.bucket_upper_tokens(default_bucket)), 1)

    @staticmethod
    def _key(sample) -> tuple:
        return (sample.task_id, sample.token_ids.tobytes())

    def _stamp(self, req: Request, bucket: int, d_hat: int):
        req.predicted_bucket = bucket
        req.predicted_decode = pred_lib.serviceable_decode(
            self.predictor.profile, d_hat, req.prompt_tokens)

    def prefetch(self, pairs: Sequence[Tuple[Request, object]]):
        todo: List[Tuple[tuple, Request, object]] = []
        for req, sample in pairs:
            if sample is None:
                continue
            key = self._key(sample)
            hit = self._cache.get(key)
            if hit is not None:
                self.hits += 1
                self._cache.move_to_end(key)
                self._stamp(req, *hit)
            else:
                self.misses += 1
                todo.append((key, req, sample))
        if not todo:
            return
        # one padded forward per batch_pad window (predict() owns the
        # pad/chunk logic)
        buckets = self.predictor.predict([s for _, _, s in todo],
                                         chunk=self.batch_pad)
        self.forwards += -(-len(todo) // self.batch_pad)
        for (key, req, _), b in zip(todo, buckets):
            d_hat = max(int(self.predictor.bucket_upper_tokens(int(b))),
                        1)
            self._cache[key] = (int(b), d_hat)
            self._stamp(req, int(b), d_hat)
            while len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)

    def estimate(self, req: Request) -> int:
        if req.predicted_decode is not None:
            return req.predicted_decode
        return self.default_d

    def bucket_of(self, decode_tokens: int) -> int:
        """Ground-truth bucket for a realized decode length (drift
        bucket-accuracy join in StreamMetrics)."""
        return self.predictor.bucket_of(decode_tokens)


# -- real-engine backend ----------------------------------------------------

class _EngineInstanceView:
    """Adapt one ``LLMInstance`` to the simulator-instance surface the
    policies and the state featurizer read."""

    def __init__(self, engine):
        self.engine = engine

    @property
    def profile(self):
        return self.engine.profile

    @property
    def failed(self):
        return self.engine.failed

    @property
    def residents(self):
        return self.engine.resident

    @property
    def queue(self):
        return self.engine.queue

    @property
    def n_slots(self):
        return self.engine.n_slots

    @property
    def clock(self):
        return self.engine.clock

    def resident_token_sum(self) -> float:
        return self.engine.resident_tokens()

    def queued_prompt_sum(self) -> float:
        return sum(r.prompt_tokens for r in self.engine.queue)

    def free_tokens(self) -> float:
        return self.engine.free_tokens()

    def outstanding_tokens(self) -> float:
        todo = 0.0
        for r in self.engine.resident:
            todo += (r.prompt_tokens - r.prefilled) + max(
                r.decode_tokens - r.decoded, 0)
        for r in self.engine.queue:
            todo += r.prompt_tokens + r.decode_tokens
        return todo

    @property
    def prefix_cache(self):
        return getattr(self.engine, "prefix_cache", None)

    @property
    def speed_factor(self) -> float:
        return self.engine.speed_factor


class EngineClusterAdapter:
    """Drive real ``LLMInstance`` replicas behind the gateway with
    the ``Cluster`` protocol (central queue, route, dt-advance).  Each
    engine runs its virtual clock up to the gateway tick; idle engines
    are fast-forwarded without burning iterations."""

    def __init__(self, engines, dt: float = 0.02):
        self.engines = list(engines)
        self.instances = [_EngineInstanceView(e) for e in self.engines]
        self.profile = self.engines[0].profile
        self.profiles = tuple(e.profile for e in self.engines)
        self.dt = dt
        self.central: deque = deque()
        self.t = 0.0
        self.completed: List[Request] = []

    @property
    def m(self) -> int:
        return len(self.engines)

    def set_trace(self, trace):
        """Attach a TraceRecorder to every engine (Cluster parity);
        instance ids in the events are adapter indices."""
        for i, e in enumerate(self.engines):
            e.trace = trace
            e.trace_instance = i

    def alive(self) -> List[int]:
        return [i for i, e in enumerate(self.engines) if not e.failed]

    def enqueue(self, req: Request):
        req.phase = Phase.QUEUED
        self.central.append(req)

    def route(self, idx: int) -> Request:
        req = self.central.popleft()
        self.engines[idx].submit(req)
        return req

    def advance(self) -> List[Request]:
        self.t += self.dt
        done: List[Request] = []
        with tr_lib.span("repro.cluster.advance"):
            for e in self.engines:
                if e.failed:
                    e.clock = self.t
                    continue
                while e.clock < self.t:
                    if not e.queue and not any(
                            s is not None for s in e.slots):
                        e.clock = self.t
                        break
                    done.extend(e.step())
        self.completed.extend(done)
        return done

    # -- fault injection (Cluster parity) ------------------------------
    def fail_instance(self, idx: int, requeue: bool = True
                      ) -> List[Request]:
        orphans = self.engines[idx].fail()
        if requeue:
            for r in orphans:
                self.central.appendleft(r)
        return orphans

    def recover_instance(self, idx: int):
        e = self.engines[idx]
        e.clock = max(e.clock, self.t)
        e.recover()

    def set_speed_factor(self, idx: int, factor: float):
        self.engines[idx].speed_factor = float(factor)

    def steal(self, req: Request) -> bool:
        if req.instance is None:
            return False
        return self.engines[req.instance].steal(req)


# -- the gateway ------------------------------------------------------------

@dataclass
class GatewayConfig:
    dt: float = 0.02                 # the paper's router cadence
    queue_cap: int = 0               # admission queue bound; 0 = unbounded
    on_full: str = "shed"            # "shed" | "defer" at saturation
    routes_per_tick: int = 1
    defer_timeout: float = 5.0       # SLA watchdog (RouterConfig parity)
    alpha: float = 0.5               # Eq.(1)/(2) balance for the watchdog
    scheduler: str = "fcfs"
    chunked_prefill: int = 0
    n_slots: Optional[int] = None
    max_time: float = 36_000.0
    metrics_window: float = 300.0
    quantiles: Tuple[float, ...] = (0.5, 0.95, 0.99)
    slo: SLO = field(default_factory=SLO)
    # simulator backend for the built-in cluster: "py" (SimInstance
    # reference stepper) or "vec" (core.vecsim structure-of-arrays)
    backend: str = "py"
    # per-instance prefix/KV cache model (core.prefix_cache); 0 = off
    prefix_cache_tokens: int = 0
    prefix_block: int = 32
    # client timeouts: a DEFERRED request whose deadline has passed is
    # dropped from the overflow queue and counted as ``cancelled``.
    # Requests may carry their own absolute ``deadline``; otherwise
    # ``default_deadline_s`` (seconds after arrival; None = no client
    # timeout) applies.
    default_deadline_s: Optional[float] = None
    # autoscaling: evaluate ``scale_up_when(shed_rate, p95_e2e)`` each
    # tick and add an instance at most once per ``scale_window``
    scale_window: float = 60.0
    # per-tenant admission quotas / weighted-fair shedding.  With
    # ``tenant_weights`` set, a full queue no longer sheds whoever
    # happens to arrive: each tenant's fair share of the bounded queue
    # is queue_cap * w_t / sum(w), and at saturation the request shed
    # is taken from the tenant MOST over its share -- evicting the
    # newest queued request of an over-share tenant to admit an
    # under-share arrival.  Tenants absent from the dict get
    # ``default_tenant_weight``.  None (default) keeps the old
    # tenant-blind behaviour.
    tenant_weights: Optional[Dict[str, float]] = None
    default_tenant_weight: float = 1.0
    # decision attribution: score every routing decision against the
    # r_mixing yardstick and join it to the request's eventual actuals
    # (per-policy regret + predictor drift in snapshot()).  Enabled
    # implicitly whenever a trace recorder is attached.
    attribution: bool = False
    # counter-track cadence (simulated seconds) for queue depth / KV
    # occupancy / backlog samples while tracing
    trace_counter_every: float = 1.0
    # -- chaos / failover (serving.chaos) ------------------------------
    # fault schedule replayed against the cluster at tick boundaries
    chaos: Optional[FaultSchedule] = None
    # failover: crash orphans re-enter admission with a bounded retry
    # budget and exponential backoff instead of instantly requeueing;
    # after ``max_retries`` failed attempts the request is shed
    failover: bool = False
    max_retries: int = 3
    retry_backoff_s: float = 0.25
    # hedged re-dispatch: a routed request still tokenless after
    # ``hedge_after_s`` is withdrawn from its (straggling) instance and
    # re-routed, at most ``max_hedges`` times.  None = off.
    hedge_after_s: Optional[float] = None
    max_hedges: int = 1
    # health tracker / circuit breaker knobs (HealthTracker); the
    # tracker runs whenever failover or chaos is on
    health_alpha: float = 0.3
    breaker_factor: float = 2.5
    breaker_min_samples: int = 8
    breaker_cooldown_s: float = 30.0


def simulator_cluster(cfg: GatewayConfig, profiles, trace=None,
                      device="cuda"):
    """The gateway's built-in simulator cluster for ``cfg.backend``,
    built through the ``core.backends`` registry; a backend whose pool
    lives on a device (``jax``) places it on ``device`` (the card unless
    the caller asks for the CPU)."""
    from repro_torch.core.backends import make_backend
    profiles = tuple(profiles)
    return make_backend(cfg.backend).make_cluster(
        profiles, len(profiles), device=device, scheduler=cfg.scheduler,
        dt=cfg.dt, chunked_prefill=cfg.chunked_prefill, n_slots=cfg.n_slots,
        prefix_cache_tokens=cfg.prefix_cache_tokens,
        prefix_block=cfg.prefix_block, trace=trace)


class Gateway:
    """Event-driven serving gateway over a cluster backend."""

    def __init__(self, cfg: GatewayConfig, profiles, policy,
                 length=None, cluster=None, scale_up_when=None,
                 trace=None):
        self.cfg = cfg
        self.trace = trace if trace is not None else tr_lib.NULL
        if cluster is not None:
            self.cluster = cluster
            if trace is not None:
                set_tr = getattr(cluster, "set_trace", None)
                if set_tr is not None:
                    set_tr(trace)
        else:
            self.cluster = simulator_cluster(cfg, profiles, trace)
        self.policy = policy
        self.length = length or OracleLength()
        self.metrics = StreamMetrics(window=cfg.metrics_window,
                                     quantiles=cfg.quantiles,
                                     slo=cfg.slo)
        # decision attribution (regret vs the r_mixing yardstick +
        # predictor drift): on whenever requested or whenever tracing
        # is -- the joined actuals feed snapshot()'s attribution block
        self._attr = bool(cfg.attribution) or self.trace.enabled
        if self._attr:
            self.metrics.enable_attribution(
                policy=getattr(policy, "name", "?"),
                bucket_of=getattr(self.length, "bucket_of", None))
        self._last_counter = -float("inf")
        self.shed: List[Request] = []
        self.cancelled: List[Request] = []
        # minimal autoscaling hook: ``scale_up_when(shed_rate, p95_e2e)``
        # -> bool is evaluated every tick; when it fires,
        # ``cluster.add_instance`` runs at most once per
        # ``cfg.scale_window`` of simulated time
        self.scale_up_when = scale_up_when
        self.scale_events: List[float] = []
        self._last_scale = -float("inf")
        self._last_scale_check = -float("inf")
        self._overflow: deque = deque()
        self._overflow_deadlines = False   # any deferred req has one?
        self._n_admitted = 0
        # per-tenant occupancy of the bounded admission queue (the
        # weighted-fair share bookkeeping; maintained even without
        # tenant_weights -- it is two dict ops per request)
        self._q_tenant: Dict[str, int] = {}
        # -- chaos / failover ------------------------------------------
        self.chaos = (ChaosInjector(cfg.chaos)
                      if cfg.chaos is not None else None)
        self.health = (HealthTracker(
            self.cluster.m, alpha=cfg.health_alpha,
            breaker_factor=cfg.breaker_factor,
            min_samples=cfg.breaker_min_samples,
            cooldown_s=cfg.breaker_cooldown_s)
            if (cfg.failover or self.chaos is not None) else None)
        self._retry_q: List[Tuple[float, int, Request]] = []  # heap
        self._retry_seq = 0
        # routed-but-tokenless requests eligible for hedging:
        # rid -> (req, gateway dispatch time)
        self._inflight: Dict[int, Tuple[Request, float]] = {}
        self.orphaned = 0
        self.hedged = 0
        # stateful policies (the online trainer) may attach to the
        # gateway: ``bind`` runs once, before any tick
        bind = getattr(policy, "bind", None)
        if bind is not None:
            bind(self)

    # -- admission / backpressure --------------------------------------
    def _queue_full(self) -> bool:
        cap = self.cfg.queue_cap
        return bool(cap) and len(self.cluster.central) >= cap

    def _admit(self, req: Request):
        if self.cfg.default_deadline_s is not None \
                and req.deadline is None:
            req.deadline = req.arrival + self.cfg.default_deadline_s
        tr = self.trace
        if self._queue_full() and not self._fair_evict_for(req):
            if self.cfg.on_full == "shed":
                req.phase = Phase.SHED
                self.shed.append(req)
                self.metrics.on_shed(req.tenant)
                if tr.enabled:
                    tr.emit(self.cluster.t, tr_lib.EV_SHED, req.rid,
                            -1, req.tenant)
            else:                       # defer: client-side overflow
                self._overflow.append(req)
                if req.deadline is not None:
                    self._overflow_deadlines = True
                if tr.enabled:
                    tr.emit(self.cluster.t, tr_lib.EV_DEFER, req.rid,
                            -1, req.tenant)
            return
        self.cluster.enqueue(req)
        self._n_admitted += 1
        self._q_tenant[req.tenant] = \
            self._q_tenant.get(req.tenant, 0) + 1
        self.metrics.on_admit(req.tenant)
        if tr.enabled:
            tr.emit(self.cluster.t, tr_lib.EV_ADMIT, req.rid, -1,
                    req.tenant)

    # -- weighted-fair shedding ----------------------------------------
    def _tenant_weight(self, tenant: str) -> float:
        w = self.cfg.tenant_weights
        return w.get(tenant, self.cfg.default_tenant_weight) if w \
            else self.cfg.default_tenant_weight

    def _fair_evict_for(self, req: Request) -> bool:
        """At saturation, try to make room for ``req`` by evicting the
        newest queued request of the tenant most over its weighted fair
        share.  Returns True if a slot was freed; False means the
        arrival itself is the (equal-)worst offender and takes the
        shed/defer as before.  No-op without ``tenant_weights``.

        Shares are computed over the tenants currently OCCUPYING the
        queue (plus the arrival): tenants that appeared once and went
        idle must not keep diluting everyone else's entitlement."""
        if self.cfg.tenant_weights is None:
            return False
        cap = self.cfg.queue_cap
        tenants = {t for t, n in self._q_tenant.items() if n > 0}
        tenants.add(req.tenant)
        total_w = sum(self._tenant_weight(t) for t in tenants)
        if total_w <= 0:
            return False

        def over(tenant: str, occupancy: int) -> float:
            share = cap * self._tenant_weight(tenant) / total_w
            return occupancy - share
        over_arrival = over(req.tenant,
                            self._q_tenant.get(req.tenant, 0) + 1)
        victim_tenant = None
        worst = over_arrival
        for t in tenants:
            n = self._q_tenant.get(t, 0)
            if n > 0 and t != req.tenant and over(t, n) > worst:
                worst = over(t, n)
                victim_tenant = t
        if victim_tenant is None:
            return False
        return self._evict_newest(victim_tenant)

    def _evict_newest(self, tenant: str) -> bool:
        """Push the newest queued (not yet routed) request of a tenant
        back out of the central queue: shed under ``on_full="shed"``,
        returned to the client-side overflow under ``"defer"`` (defer
        mode stays lossless -- the displaced request retries like any
        deferred arrival)."""
        central = self.cluster.central
        victim = None
        for r in reversed(central):
            if r.tenant == tenant:
                victim = r
                break
        if victim is None:
            return False
        central.remove(victim)
        self._n_admitted -= 1
        self._q_tenant[tenant] -= 1
        if self._q_tenant[tenant] == 0:
            del self._q_tenant[tenant]      # bound the dict's growth
        if self.cfg.on_full == "shed":
            victim.phase = Phase.SHED
            self.shed.append(victim)
            self.metrics.on_evict(tenant)
        else:
            victim.phase = Phase.QUEUED
            self._overflow.append(victim)
            if victim.deadline is not None:
                self._overflow_deadlines = True
            self.metrics.on_evict(tenant, shed=False)
        if self.trace.enabled:
            self.trace.emit(self.cluster.t, tr_lib.EV_EVICT,
                            victim.rid, -1, tenant,
                            {"mode": self.cfg.on_full})
        return True

    def _cancel_expired(self):
        """Client timeouts: deferred requests whose deadline has passed
        leave the overflow queue (the client hung up; re-admitting the
        work would burn capacity on an answer nobody reads).  O(queue)
        per tick, paid only while some deferred request actually
        carries a deadline."""
        if not self._overflow or not self._overflow_deadlines:
            return
        now = self.cluster.t
        keep: deque = deque()
        for req in self._overflow:
            if req.deadline is not None and now > req.deadline:
                req.phase = Phase.CANCELLED
                self.cancelled.append(req)
                self.metrics.on_cancel(req.tenant)
                if self.trace.enabled:
                    self.trace.emit(now, tr_lib.EV_CANCEL, req.rid,
                                    -1, req.tenant)
            else:
                keep.append(req)
        self._overflow = keep

    def _drain_overflow(self):
        self._cancel_expired()
        while self._overflow and not self._queue_full():
            req = self._overflow.popleft()
            self.cluster.enqueue(req)
            self._n_admitted += 1
            self._q_tenant[req.tenant] = \
                self._q_tenant.get(req.tenant, 0) + 1
            self.metrics.on_admit(req.tenant)
            if self.trace.enabled:
                self.trace.emit(self.cluster.t, tr_lib.EV_ADMIT,
                                req.rid, -1, req.tenant,
                                {"retry": True})

    def _maybe_scale_up(self):
        """Closed-loop elastic scale-out: fire the user predicate on
        the live shed rate and windowed P95 E2E, rate-limited to one
        ``add_instance`` per ``scale_window`` of simulated time.  The
        predicate (and its exact-quantile read over the metrics window)
        is consulted at most once per simulated second, not per tick."""
        if self.scale_up_when is None:
            return
        now = self.cluster.t
        if now - self._last_scale < self.cfg.scale_window:
            return
        if now - self._last_scale_check < 1.0:
            return
        self._last_scale_check = now
        st = self.metrics._all
        offered = st.admitted + st.shed
        shed_rate = st.shed / offered if offered else 0.0
        p95 = st.metrics["e2e"].win.quantile(0.95, now)
        if not self.scale_up_when(shed_rate,
                                  0.0 if p95 is None else p95):
            return
        add = getattr(self.cluster, "add_instance", None)
        if add is None:
            return
        add(self.cfg.scheduler, self.cfg.chunked_prefill)
        self._last_scale = now
        self.scale_events.append(now)

    # -- chaos / failover ----------------------------------------------
    def _apply_chaos(self):
        """Apply the fault schedule's due events at the tick boundary.
        With failover on, crash orphans go through the bounded-retry
        path; otherwise they requeue immediately (legacy semantics) but
        with the gateway's tenant-occupancy bookkeeping kept
        consistent."""
        if self.chaos is None:
            return
        on_orphans = (self._on_orphans if self.cfg.failover
                      else self._requeue_orphans)
        for kind, idx, _ in self.chaos.step(self.cluster,
                                            self.cluster.t, on_orphans):
            if kind == "recover" and self.health is not None:
                self.health.reset(idx)

    def _requeue_orphans(self, orphans: List[Request]):
        for req in orphans:
            self._inflight.pop(req.rid, None)
            self.orphaned += 1
            self.metrics.on_orphan(req.tenant)
            self.cluster.central.appendleft(req)
            self._q_tenant[req.tenant] = \
                self._q_tenant.get(req.tenant, 0) + 1

    def _on_orphans(self, orphans: List[Request]):
        """Failover: orphaned requests re-enter admission with a
        bounded retry budget and exponential backoff; past the budget
        they are shed (the outage consumed them)."""
        now = self.cluster.t
        cfg = self.cfg
        for req in orphans:
            self._inflight.pop(req.rid, None)
            self.orphaned += 1
            self.metrics.on_orphan(req.tenant)
            req.retries += 1
            if req.retries > cfg.max_retries:
                req.phase = Phase.SHED
                self.shed.append(req)
                self._n_admitted -= 1
                self.metrics.on_evict(req.tenant)   # admitted -> shed
                if self.trace.enabled:
                    self.trace.emit(now, tr_lib.EV_SHED, req.rid, -1,
                                    req.tenant,
                                    {"retries": int(req.retries - 1)})
                continue
            due = now + cfg.retry_backoff_s * (2.0 ** (req.retries - 1))
            heapq.heappush(self._retry_q,
                           (due, self._retry_seq, req))
            self._retry_seq += 1
            self.metrics.on_retry(req.tenant)
            if self.trace.enabled:
                self.trace.emit(now, tr_lib.EV_RETRY, req.rid, -1,
                                req.tenant,
                                {"retries": int(req.retries),
                                 "due": float(due)})

    def _drain_retries(self):
        """Re-admit retries whose backoff has elapsed.  They re-enter
        at the FRONT of the central queue: they are the stream's oldest
        requests and have already paid their backoff delay."""
        now = self.cluster.t
        while self._retry_q and self._retry_q[0][0] <= now:
            _, _, req = heapq.heappop(self._retry_q)
            req.phase = Phase.QUEUED
            self.cluster.central.appendleft(req)
            self._q_tenant[req.tenant] = \
                self._q_tenant.get(req.tenant, 0) + 1

    def _update_health(self):
        """Stamp the tracker's verdict onto the cluster: policies and
        the featurizer consult ``health_mask`` / ``health_scores``
        through duck-typed getattr, so every backend -- py, vec, engine
        adapter -- gets the same candidate-set filtering."""
        if self.health is None:
            return
        cluster = self.cluster
        self.health.ensure(cluster.m)
        mask, scores = self.health.assess(cluster.t, cluster.alive())
        cluster.health_mask = mask
        cluster.health_scores = scores

    def _hedge_stuck(self):
        """Hedged re-dispatch: a routed request still tokenless past
        ``hedge_after_s`` is withdrawn from its (straggling) instance
        and re-enters the central queue for a fresh placement."""
        cfg = self.cfg
        if cfg.hedge_after_s is None or not self._inflight:
            return
        cluster = self.cluster
        now = cluster.t
        is_vec = getattr(cluster, "is_vec", False)
        for rid, (req, t0) in list(self._inflight.items()):
            if now - t0 <= cfg.hedge_after_s \
                    or req.hedges >= cfg.max_hedges:
                continue
            if is_vec:
                cluster.pool.sync_request(cluster.gid_of(req))
            if req.first_token is not None or req.phase is Phase.DONE:
                del self._inflight[rid]     # progressing; leave it be
                continue
            src = req.instance
            if not cluster.steal(req):
                del self._inflight[rid]
                continue
            del self._inflight[rid]
            req.hedges += 1
            self.hedged += 1
            if self.health is not None and src is not None:
                self.health.on_bad(int(src))
            self.metrics.on_hedge(req.tenant)
            if self.trace.enabled:
                self.trace.emit(now, tr_lib.EV_HEDGE, req.rid,
                                -1 if src is None else int(src),
                                req.tenant,
                                {"inst": -1 if src is None
                                 else int(src)})
            req.phase = Phase.QUEUED
            cluster.central.appendleft(req)
            self._q_tenant[req.tenant] = \
                self._q_tenant.get(req.tenant, 0) + 1

    # -- routing -------------------------------------------------------
    def _route_some(self):
        cfg = self.cfg
        cluster = self.cluster
        tr = self.trace
        for _ in range(cfg.routes_per_tick):
            if not cluster.central:
                return
            head = cluster.central[0]
            d_hat = max(int(self.length.estimate(head)), 1)
            a = self.policy.route(cluster, head, d_hat)
            deferred = a is None or a >= cluster.m
            scores = None
            forced = False
            if deferred and cluster.t - head.arrival > cfg.defer_timeout:
                # SLA watchdog: force the best-impact placement (the
                # same override RoutingEnv.step applies)
                scores = rl.mixing_scores(cluster, head, d_hat,
                                          cfg.alpha)
                a = int(np.argmax(scores))
                deferred = False
                forced = True
                on_forced = getattr(self.policy, "on_forced", None)
                if on_forced is not None:
                    # the online trainer charges the watchdog's
                    # sla_penalty to the deferring decision (RoutingEnv
                    # reward parity)
                    on_forced(int(a))
            if deferred:
                return
            self._q_tenant[head.tenant] -= 1
            if self._q_tenant[head.tenant] == 0:
                del self._q_tenant[head.tenant]
            if self._attr:
                # uniform yardstick across ALL policies: the r_mixing
                # score vector this decision faced.  Regret is the
                # score gap to the mixing-argmax (0 for the heuristic
                # itself) -- joined to actuals at completion time.
                if scores is None:
                    scores = rl.mixing_scores(cluster, head, d_hat,
                                              cfg.alpha)
                best = int(np.argmax(scores))
                regret = float(scores[best] - scores[a])
                self.metrics.on_decision(head, d_hat, regret,
                                         agree=(a == best))
                if tr.enabled:
                    data = {"inst": int(a), "d_hat": int(d_hat),
                            "wait": float(cluster.t - head.arrival),
                            "regret": regret}
                    if forced:
                        data["forced"] = True
                    explain = getattr(self.policy, "explain", None)
                    if explain is not None:
                        ex = explain(cluster, head, d_hat)
                        if ex:
                            data.update(ex)
                    tr.emit(cluster.t, tr_lib.EV_ROUTE, head.rid,
                            int(a), head.tenant, data)
            cluster.route(a)
            if cfg.hedge_after_s is not None:
                self._inflight[head.rid] = (head, cluster.t)

    def _sample_counters(self):
        """Counter-track samples for the Perfetto export: router queue
        depth plus per-instance KV occupancy and outstanding backlog."""
        tr = self.trace
        t = self.cluster.t
        tr.counter(t, "queue_depth", len(self.cluster.central))
        for i, inst in enumerate(self.cluster.instances):
            tr.counter(t, "kv_tokens", inst.resident_token_sum(), i)
            tr.counter(t, "backlog", inst.outstanding_tokens(), i)

    # -- serving loop --------------------------------------------------
    def run(self, scenario_or_requests, samples=None) -> Dict:
        """Serve one open-loop stream to completion (or ``max_time``).

        Accepts a ``workload.Scenario`` (its ``samples`` feed the
        length service) or a plain request list.  Returns closed-loop
        summary stats + the streaming ``snapshot``."""
        if isinstance(scenario_or_requests, wl.Scenario):
            requests = scenario_or_requests.requests
            samples = scenario_or_requests.samples
        else:
            requests = list(scenario_or_requests)
        if samples is None:
            samples = [None] * len(requests)
        order = sorted(range(len(requests)),
                       key=lambda i: requests[i].arrival)
        stream = [(requests[i], samples[i]) for i in order]
        cluster = self.cluster
        cfg = self.cfg
        tr = self.trace
        i, n = 0, len(stream)
        track_health = self.health is not None
        # stateful-policy tick hooks (the online trainer): resolved once
        # -- None for every stock policy, so the loop pays one branch
        on_pre_route = getattr(self.policy, "on_pre_route", None)
        on_tick = getattr(self.policy, "on_tick", None)
        on_run_end = getattr(self.policy, "on_run_end", None)
        while True:
            self._apply_chaos()
            self._update_health()
            new: List[Tuple[Request, object]] = []
            while i < n and stream[i][0].arrival <= cluster.t:
                new.append(stream[i])
                i += 1
            if new:
                self.length.prefetch(new)
            self._drain_overflow()      # deferred clients retry first
            self._drain_retries()       # elapsed-backoff crash orphans
            for req, _ in new:
                if tr.enabled:
                    tr.emit(req.arrival, tr_lib.EV_ARRIVE, req.rid,
                            -1, req.tenant,
                            {"prompt": int(req.prompt_tokens)})
                with tr_lib.span("repro.gateway.admit"):
                    self._admit(req)
            self._hedge_stuck()
            if on_pre_route is not None:
                # every request enqueued this tick (arrivals, drained
                # overflow, retries, hedge requeues) is still in
                # cluster.central here
                on_pre_route(cluster)
            with tr_lib.span("repro.gateway.route"):
                self._route_some()
            done_now = cluster.advance()
            for r in done_now:
                if self._inflight:
                    self._inflight.pop(r.rid, None)
                if track_health and r.instance is not None:
                    self.health.on_complete(int(r.instance), r)
                self.metrics.on_complete(r, r.tenant)
            if on_tick is not None:
                on_tick(cluster, done_now)
            self._drain_overflow()
            self._maybe_scale_up()
            if tr.enabled and (cluster.t - self._last_counter
                               >= cfg.trace_counter_every):
                self._last_counter = cluster.t
                self._sample_counters()
            if (i >= n and not self._overflow and not self._retry_q
                    and len(cluster.completed) >= self._n_admitted):
                break
            if cluster.t > cfg.max_time:
                break
        if on_run_end is not None:
            on_run_end()
        if getattr(cluster, "is_vec", False):
            cluster.sync_all()   # in-flight requests on truncated runs
            for r in self.shed:
                r.phase = Phase.SHED   # fair-evicted: arena says QUEUED
        stats = summarize(requests)
        stats["preemptions"] = sum(r.preemptions for r in requests)
        stats["shed"] = len(self.shed)
        stats["cancelled"] = len(self.cancelled)
        stats["admitted"] = self._n_admitted
        stats["scaled"] = len(self.scale_events)
        stats["orphaned"] = self.orphaned
        stats["hedged"] = self.hedged
        stats["retried"] = sum(r.retries for r in requests)
        if self.health is not None:
            stats["breaker_trips"] = self.health.trips
        stats["policy"] = getattr(self.policy, "name", "?")
        stats["snapshot"] = self.metrics.snapshot(cluster.t)
        return stats
