"""Discrete-event cluster simulator for routing experiments (the port's
own copy of ``repro.core.simulator``: ``SimInstance``, ``Cluster`` and
``run_heuristic``; ``Cluster(backend=...)`` dispatches through
``core.backends``).

``SimInstance`` mirrors the real engine's continuous-batching semantics
(slot admission via an instance scheduler, one admission per iteration,
gang decode, capacity-budget preemption of the newest request) but costs
iterations with the calibrated HardwareProfile instead of running a model,
so thousand-request episodes run in milliseconds-per-simulated-second --
fast enough to train the RL router.

Sarathi-style chunked prefill (paper §6.3) is a timing-level instance
optimization: with ``chunked_prefill=C`` a prompt is processed C tokens per
iteration and decodes piggyback (no decode stall, smaller TBT spikes, TTFT
pays per-iteration overhead) -- exactly the trade-off Table 3 probes.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.profiles import HardwareProfile
from repro_torch.serving import trace as _trace
from repro_torch.serving.request import Phase, Request
from repro_torch.serving.scheduler import InstanceScheduler, get_scheduler


class SimInstance:
    def __init__(self, profile: HardwareProfile,
                 scheduler: InstanceScheduler, instance_id: int = 0,
                 chunked_prefill: int = 0, n_slots: Optional[int] = None,
                 prefix_cache_tokens: int = 0, prefix_block: int = 32,
                 trace=None):
        self.profile = profile
        # lifecycle tracing (serving.trace); NULL keeps the hot path at
        # one attribute check per emission site
        self.trace = trace if trace is not None else _trace.NULL
        self.scheduler = scheduler
        self.instance_id = instance_id
        self.chunk = chunked_prefill
        self.n_slots = n_slots or profile.max_batch
        # prefix/KV cache model (0 tokens = disabled -- the paper's
        # baseline setup): admitted requests whose prompt hash-chain
        # shares a cached prefix start with ``prefilled = cached``
        self.prefix_cache = (PrefixCache(prefix_cache_tokens,
                                         prefix_block)
                             if prefix_cache_tokens > 0 else None)
        self.residents: List[Request] = []      # decoding or chunk-prefilling
        self.queue: deque = deque()
        self.clock = 0.0
        self.completed: List[Request] = []
        self.failed = False
        # straggler model: scales every iteration time (1.0 = nominal);
        self.speed_factor = 1.0
        self.spikes: List[float] = []           # iteration times > 2x base
        self._admit_seq = 0
        # observer hooks (the RL env maintains its backlog penalty
        # incrementally from these instead of rescanning every request
        # every tick): on_token(r) after each decoded token, on_preempt(r)
        # BEFORE a preemption resets r's progress.
        self.on_token = None
        self.on_preempt = None
        # incrementally-maintained token sums (every mutation site in
        # this class updates them; recomputing per query dominated the
        # simulator's profile).  Queue invariant: queued requests always
        # have zero progress (preemption resets before requeue), so the
        # queue's context sum equals its prompt sum.
        self._rts = 0.0                # sum of total_context, residents
        self._qps = 0.0                # sum of prompt_tokens, queue
        self._out = 0.0                # outstanding prompt+decode tokens

    # -- router-visible state ------------------------------------------------
    def resident_token_sum(self) -> float:
        return self._rts

    def queued_prompt_sum(self) -> float:
        return self._qps

    def outstanding_tokens(self) -> float:
        """Total tokens yet to be processed (for JSQ) -- O(1).

        Maintained incrementally like ``_rts``/``_qps`` (it used to
        rescan residents+queue on every JSQ route decision): submit
        adds prompt+decode, each prefill token and each decoded token
        subtracts one, preemption re-adds the lost progress.  Admission
        and completion are net zero (queued requests carry no progress;
        a completing request has none left)."""
        return self._out

    def free_tokens(self) -> float:
        return self.profile.capacity_tokens - self._rts - self._qps

    def earliest_completion(self) -> float:
        """(iterations left) x (average batch time) for the closest
        resident (paper §4.2)."""
        if not self.residents:
            return 0.0
        left = min(max(r.decode_tokens - r.decoded, 0)
                   for r in self.residents)
        return left * self.profile.t_decode_base

    def load_summary(self) -> Dict:
        return {
            "n_resident": len(self.residents),
            "n_queued": len(self.queue),
            "p_tokens": [r.prompt_tokens for r in self.residents],
            "d_tokens": [r.decoded for r in self.residents],
            "resident_tokens": self.resident_token_sum(),
            "free_tokens": self.free_tokens(),
            "earliest_completion": self.earliest_completion(),
            "clock": self.clock,
        }

    # -- intake ---------------------------------------------------------------
    def submit(self, req: Request):
        req.phase = Phase.INSTANCE_QUEUE
        req.instance = self.instance_id
        req.routed_at = self.clock
        self.queue.append(req)
        self._qps += req.prompt_tokens
        self._out += req.prompt_tokens + req.decode_tokens

    # -- iterate until the cluster time --------------------------------------
    def run_until(self, t: float) -> List[Request]:
        done: List[Request] = []
        if self.failed:
            self.clock = t
            return done
        while self.clock < t:
            if not self.residents and not self.queue:
                self.clock = t
                break
            done.extend(self._iteration())
        return done

    def _iteration(self) -> List[Request]:
        profile = self.profile
        tr = self.trace
        prefill_tokens = 0
        # resident context tokens before this iteration's prefill/decode
        rts = self._rts
        # admission: one request per iteration if a slot is free
        if len(self.residents) < self.n_slots and self.queue:
            budget = profile.capacity_tokens - rts
            pick = self.scheduler.pick(list(self.queue), budget, profile)
            if pick is not None:
                req = self.queue[pick]
                del self.queue[pick]
                self._qps -= req.prompt_tokens
                req.phase = Phase.PREFILL
                req.admitted_idx = self._admit_seq
                self._admit_seq += 1
                self.residents.append(req)
                if self.prefix_cache is not None and req.prefix_hashes:
                    # longest-prefix hit: the cached part of the prompt
                    # is already prefilled (counts as resident context
                    # but never enters the prefill loop); the prompt's
                    # own chain becomes resident for later arrivals
                    cached = self.prefix_cache.admit(req.prompt_tokens,
                                                     req.prefix_hashes)
                    req.prefilled = cached
                    req.cached_prefix = cached
                    self._out -= cached
                self._rts += req.prefilled + req.decoded
                rts = self._rts
                if tr.enabled:
                    tr.emit(self.clock, _trace.EV_INST_ADMIT, req.rid,
                            self.instance_id, req.tenant,
                            {"cached": int(req.cached_prefix)})
        # prefill progress (full, or one chunk per iteration)
        for r in self.residents:
            if r.phase is Phase.PREFILL:
                step = (r.prompt_tokens - r.prefilled) if not self.chunk \
                    else min(self.chunk, r.prompt_tokens - r.prefilled)
                r.prefilled += step
                prefill_tokens += step
                if tr.enabled and self.chunk and step > 0:
                    tr.emit(self.clock, _trace.EV_PREFILL_CHUNK, r.rid,
                            self.instance_id, r.tenant,
                            {"tokens": int(step)})
                if r.prefilled >= r.prompt_tokens:
                    r.phase = Phase.DECODE
                    r.prefill_done = self.clock
                    if tr.enabled:
                        tr.emit(self.clock, _trace.EV_PREFILL_DONE, r.rid,
                                self.instance_id, r.tenant)
                if not self.chunk:
                    break     # unchunked: only one prefill per iteration
        # decode every resident already in decode phase
        decoding = [r for r in self.residents if r.phase is Phase.DECODE]
        # iteration time (spikes when prefill mixes in -- Fig. 1a);
        # resident-other is the pre-prefill context sum
        it_time = profile.iteration_time(prefill_tokens, rts) \
            * self.speed_factor
        if it_time > 2.0 * profile.t_decode_base * self.speed_factor:
            self.spikes.append(it_time)
        self.clock += it_time
        rts += prefill_tokens
        self._out -= prefill_tokens + len(decoding)
        done: List[Request] = []
        on_token = self.on_token
        for r in decoding:
            r.decoded += 1
            rts += 1
            if r.first_token is None:
                r.first_token = self.clock
                if tr.enabled:
                    tr.emit(self.clock, _trace.EV_FIRST_TOKEN, r.rid,
                            self.instance_id, r.tenant)
            r.token_times.append(self.clock)
            if on_token is not None:
                on_token(r)
            if r.decoded >= r.decode_tokens:
                r.phase = Phase.DONE
                r.finished = self.clock
                self.completed.append(r)
                done.append(r)
                if tr.enabled:
                    tr.emit(self.clock, _trace.EV_COMPLETE, r.rid,
                            self.instance_id, r.tenant)
                rts -= r.prefilled + r.decoded
                if self.prefix_cache is not None and r.full_hashes:
                    # the finished conversation's KV (prompt + reply)
                    # stays cached: the follow-up turn extends it
                    self.prefix_cache.insert(r.full_hashes)
        if done:
            self.residents = [r for r in self.residents
                              if r.phase is not Phase.DONE]
        # capacity enforcement: evict newest-admitted until within budget.
        # The OLDEST resident is never evicted (liveness: it runs to
        # completion even if it alone overshoots -- swap-space grace),
        # matching vLLM's recompute-preemption order.
        while rts > profile.capacity_tokens and len(self.residents) > 1:
            victim = max(self.residents, key=lambda r: r.admitted_idx)
            self.residents.remove(victim)
            rts -= victim.prefilled + victim.decoded
            self._out += victim.prefilled + victim.decoded
            if self.on_preempt is not None:
                self.on_preempt(victim)
            if tr.enabled:
                tr.emit(self.clock, _trace.EV_PREEMPT, victim.rid,
                        self.instance_id, victim.tenant,
                        {"lost": int(victim.prefilled + victim.decoded)})
            victim.reset_progress()
            self.queue.appendleft(victim)
            self._qps += victim.prompt_tokens
        self._rts = rts
        return done

    # -- fault injection ------------------------------------------------------
    def fail(self) -> List[Request]:
        self.failed = True
        if self.trace.enabled:
            self.trace.emit(self.clock, _trace.EV_FAIL, -1,
                            self.instance_id)
        orphans = list(self.residents) + list(self.queue)
        self.residents, self.queue = [], deque()
        if self.prefix_cache is not None:
            self.prefix_cache.clear()   # the KV pool dies with the node
        self._rts = 0.0
        self._qps = 0.0
        self._out = 0.0
        for r in orphans:
            if self.on_preempt is not None:
                self.on_preempt(r)
            r.reset_progress()
            r.phase = Phase.QUEUED
            r.instance = None
            # the attempt died: clear its timing stamps so TTFT/TBT/E2E
            # measure the attempt that actually serves the request (a
            # stale first_token would anchor TTFT at the dead node)
            r.first_token = None
            r.token_times = []
            r.prefill_done = None
        return orphans

    def recover(self):
        """Undo :meth:`fail`: the node comes back *empty* (no residents,
        cold prefix cache) at its current clock and resumes accepting
        work.  Emits ``recover`` so traces show the outage window."""
        self.failed = False
        if self.trace.enabled:
            self.trace.emit(self.clock, _trace.EV_RECOVER, -1,
                            self.instance_id)

    def restore(self):
        self.failed = False

    def steal(self, req: Request) -> bool:
        """Withdraw a routed request (hedged re-dispatch): remove it
        from this instance's queue or residents, reset its progress and
        timing stamps, and hand it back to the caller.  Returns False if
        the request is no longer here (completed this tick)."""
        if req in self.residents:
            self.residents.remove(req)
            self._rts -= req.prefilled + req.decoded
            self._out -= ((req.prompt_tokens - req.prefilled)
                          + (req.decode_tokens - req.decoded))
            if self.on_preempt is not None:
                self.on_preempt(req)
        else:
            try:
                self.queue.remove(req)
            except ValueError:
                return False
            self._qps -= req.prompt_tokens
            self._out -= req.prompt_tokens + req.decode_tokens
        req.reset_progress()
        req.phase = Phase.QUEUED
        req.instance = None
        req.first_token = None
        req.token_times = []
        req.prefill_done = None
        return True


class Cluster:
    """m instances + the central router queue, stepped at dt (= the paper's
    0.02 s action interval).

    ``profile`` may be a single HardwareProfile (homogeneous cluster, the
    paper's setup) or a sequence of per-instance profiles (heterogeneous
    cluster -- mixed GPU generations behind one router); in the latter
    case ``n_instances`` must match and ``cluster.profile`` is the first
    entry (the router-level reference profile).

    ``backend`` resolves through the ``core.backends`` registry:
    ``"vec"`` returns the vectorized structure-of-arrays implementation
    (`core.vecsim.VecCluster`, decision-for-decision identical;
    O(rounds) stepping instead of O(requests x instances)) -- the
    Python stepper remains the reference oracle."""

    def __new__(cls, profile=None, n_instances: int = 0,
                scheduler: str = "fcfs", dt: float = 0.02,
                chunked_prefill: int = 0,
                n_slots: Optional[int] = None, backend: str = "py",
                prefix_cache_tokens: int = 0, prefix_block: int = 32,
                trace=None):
        if cls is Cluster and backend != "py":
            from repro_torch.core.backends import make_backend
            # registry backends are not Cluster subclasses, so
            # __init__ below is not re-run on the returned object
            return make_backend(backend).make_cluster(
                profile, n_instances, scheduler=scheduler, dt=dt,
                chunked_prefill=chunked_prefill, n_slots=n_slots,
                prefix_cache_tokens=prefix_cache_tokens,
                prefix_block=prefix_block, trace=trace)
        return super().__new__(cls)

    def __init__(self, profile, n_instances: int,
                 scheduler: str = "fcfs", dt: float = 0.02,
                 chunked_prefill: int = 0,
                 n_slots: Optional[int] = None, backend: str = "py",
                 prefix_cache_tokens: int = 0, prefix_block: int = 32,
                 trace=None):
        if isinstance(profile, HardwareProfile):
            profiles = [profile] * n_instances
        else:
            profiles = list(profile)
            if len(profiles) != n_instances:
                raise ValueError(
                    f"{len(profiles)} profiles for {n_instances} instances")
        self.profile = profiles[0]
        self.profiles = tuple(profiles)
        self.dt = dt
        self._prefix_cache_tokens = prefix_cache_tokens
        self._prefix_block = prefix_block
        self._trace = trace if trace is not None else _trace.NULL
        self.instances = [
            SimInstance(profiles[i], get_scheduler(scheduler), i,
                        chunked_prefill, n_slots,
                        prefix_cache_tokens=prefix_cache_tokens,
                        prefix_block=prefix_block, trace=self._trace)
            for i in range(n_instances)]
        self.central: deque = deque()
        self.t = 0.0
        self.completed: List[Request] = []
        self.queue_len_trace: List[int] = []

    @property
    def m(self) -> int:
        return len(self.instances)

    def set_trace(self, trace):
        """Attach a TraceRecorder after construction (gateway over a
        pre-built cluster)."""
        self._trace = trace
        for inst in self.instances:
            inst.trace = trace

    def alive(self) -> List[int]:
        return [i for i, inst in enumerate(self.instances)
                if not inst.failed]

    def enqueue(self, req: Request):
        req.phase = Phase.QUEUED
        self.central.append(req)

    def route(self, idx: int) -> Request:
        req = self.central.popleft()
        self.instances[idx].submit(req)
        return req

    def advance(self) -> List[Request]:
        """Advance the cluster clock by dt; returns completions."""
        self.t += self.dt
        done: List[Request] = []
        for inst in self.instances:
            done.extend(inst.run_until(self.t))
        self.completed.extend(done)
        self.queue_len_trace.append(len(self.central))
        return done

    def add_instance(self, scheduler: str = "fcfs",
                     chunked_prefill: int = 0,
                     profile: Optional[HardwareProfile] = None) -> int:
        """Elastic scale-out (optionally with a different hardware tier)."""
        inst = SimInstance(profile or self.profile, get_scheduler(scheduler),
                           len(self.instances), chunked_prefill,
                           prefix_cache_tokens=self._prefix_cache_tokens,
                           prefix_block=self._prefix_block,
                           trace=self._trace)
        inst.clock = self.t
        # inherit cluster-level observer hooks (the RL env's incremental
        # backlog accounting must see the new instance's decode events)
        if self.instances:
            inst.on_token = self.instances[0].on_token
            inst.on_preempt = self.instances[0].on_preempt
        self.instances.append(inst)
        self.profiles = self.profiles + (inst.profile,)
        return inst.instance_id

    def fail_instance(self, idx: int, requeue: bool = True) -> List[Request]:
        """Node failure: orphaned requests are requeued centrally
        (default; idempotent request ids, progress restarts) or -- with
        ``requeue=False`` -- returned for the caller's failover machinery
        (the gateway's bounded-retry path) to take ownership of."""
        orphans = self.instances[idx].fail()
        if requeue:
            for r in orphans:
                self.central.appendleft(r)
        return orphans

    def recover_instance(self, idx: int):
        """Bring a failed instance back into service at the cluster
        clock; policies see it in ``alive()`` from the next decision."""
        inst = self.instances[idx]
        inst.clock = max(inst.clock, self.t)
        inst.recover()

    def set_speed_factor(self, idx: int, factor: float):
        """Straggler injection: scale instance ``idx``'s iteration times
        (1.0 = nominal, 2.0 = half speed)."""
        self.instances[idx].speed_factor = float(factor)

    def steal(self, req: Request) -> bool:
        """Withdraw a routed-but-tokenless request for hedged
        re-dispatch (see SimInstance.steal)."""
        if req.instance is None:
            return False
        return self.instances[req.instance].steal(req)


def run_heuristic(cluster: Cluster, requests: Sequence[Request], policy,
                  max_time: float = 36000.0,
                  routes_per_tick: int = 64) -> Dict:
    """Drive a (non-RL) routing policy over an episode."""
    pending = sorted(requests, key=lambda r: r.arrival)
    i = 0
    n = len(pending)
    while len(cluster.completed) < n and cluster.t < max_time:
        while i < n and pending[i].arrival <= cluster.t:
            cluster.enqueue(pending[i])
            i += 1
        for _ in range(routes_per_tick):
            if not cluster.central:
                break
            act = policy.act(cluster)
            if act is None or act >= cluster.m:
                break               # defer
            cluster.route(act)
        cluster.advance()
    if getattr(cluster, "is_vec", False):
        cluster.sync_all()       # in-flight requests on truncated runs
    from repro_torch.serving.request import summarize
    stats = summarize(requests)
    stats["spikes"] = sum(len(inst.spikes) for inst in cluster.instances)
    return stats
