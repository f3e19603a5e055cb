"""Seeded fault injection + per-instance health tracking.

A production router is ranked by how it behaves when the fleet is NOT
healthy: nodes crash and restart, stragglers serve at a fraction of
nominal speed, and tenants burst together.  This module makes those
conditions first-class and *deterministic*:

  * :class:`FaultSchedule` -- an immutable, seed-constructible script of
    :class:`Crash` (fail at ``t``, optionally restart ``restart_after``
    seconds later), :class:`Straggler` (a ``[t0, t1)`` window during
    which one instance's iteration times are scaled by ``factor``) and
    :class:`TenantBurst` (correlated extra arrivals for one tenant)
    events.  The same schedule replays bit-identically against the
    Python stepper, the vectorized simulator, and the real-engine
    adapter -- all three expose ``fail_instance(idx, requeue=...)``,
    ``recover_instance(idx)`` and ``set_speed_factor(idx, f)``.
  * :class:`ChaosInjector` -- applies a schedule's due events at the top
    of each gateway tick.  Crash orphans are handed to an optional
    callback (the gateway's bounded-retry failover) instead of being
    silently requeued.
  * :class:`HealthTracker` -- per-instance EWMA of *realized* TBT plus
    a decayed bad-event rate (cancels, hedges), driving a circuit
    breaker: an instance whose EWMA exceeds ``breaker_factor`` x the
    fleet median is removed from every policy's candidate set for
    ``cooldown_s``, then re-probed.  The tracker never opens the breaker
    on the entire alive fleet (guarded fallback: a degraded instance
    beats no instance).

Determinism contract: every float the tracker consumes is a bit-equal
request field on the py and vec backends (TBT is derived as
``(finished - first_token) / (decoded - 1)`` rather than from the
vec-synthesized ``token_times``), and per-instance completion order is
identical, so health decisions -- and therefore routing decisions --
stay bit-exact under injected faults (tests/test_chaos.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import Request

# -- fault schedule ----------------------------------------------------------

#: tie-break rank for events sharing a timestamp: a crash precedes the
#: recovery of another instance, slowdowns apply last
_KIND_RANK = {"fail": 0, "recover": 1, "slow": 2}


@dataclass(frozen=True)
class Crash:
    t: float
    instance: int
    restart_after: Optional[float] = None   # None = permanent loss


@dataclass(frozen=True)
class Straggler:
    t0: float
    t1: float
    instance: int
    factor: float = 3.0                     # iteration-time multiplier


@dataclass(frozen=True)
class TenantBurst:
    t0: float
    t1: float
    tenant: str
    rate: float = 4.0                       # extra arrivals/s in window


@dataclass(frozen=True)
class FaultSchedule:
    crashes: Tuple[Crash, ...] = ()
    stragglers: Tuple[Straggler, ...] = ()
    bursts: Tuple[TenantBurst, ...] = ()

    @classmethod
    def random(cls, seed: int, m: int, horizon: float,
               n_crashes: int = 1, n_stragglers: int = 1,
               n_bursts: int = 0, tenants: Sequence[str] = ("default",),
               restart_range: Tuple[float, float] = (5.0, 20.0),
               slow_range: Tuple[float, float] = (2.0, 5.0),
               burst_rate: float = 4.0) -> "FaultSchedule":
        """Seed-driven schedule: faults land in the first 60% of the
        horizon so their fallout is observable before the run ends."""
        rng = np.random.default_rng(seed)
        crashes = tuple(
            Crash(float(rng.uniform(0.1 * horizon, 0.6 * horizon)),
                  int(rng.integers(0, m)),
                  float(rng.uniform(*restart_range)))
            for _ in range(n_crashes))
        stragglers = []
        for _ in range(n_stragglers):
            t0 = float(rng.uniform(0.1 * horizon, 0.6 * horizon))
            dur = float(rng.uniform(0.1 * horizon, 0.3 * horizon))
            stragglers.append(
                Straggler(t0, min(t0 + dur, horizon),
                          int(rng.integers(0, m)),
                          float(rng.uniform(*slow_range))))
        bursts = []
        for _ in range(n_bursts):
            t0 = float(rng.uniform(0.1 * horizon, 0.7 * horizon))
            bursts.append(
                TenantBurst(t0, min(t0 + 0.15 * horizon, horizon),
                            tenants[int(rng.integers(0, len(tenants)))],
                            burst_rate))
        return cls(crashes, tuple(stragglers), tuple(bursts))

    def events(self) -> List[Tuple[float, str, int, float]]:
        """Flatten to a time-sorted ``(t, kind, instance, arg)`` list
        with a deterministic tie order (kind rank, then instance)."""
        ev: List[Tuple[float, str, int, float]] = []
        for c in self.crashes:
            ev.append((c.t, "fail", c.instance, 0.0))
            if c.restart_after is not None:
                ev.append((c.t + c.restart_after, "recover",
                           c.instance, 0.0))
        for s in self.stragglers:
            ev.append((s.t0, "slow", s.instance, s.factor))
            ev.append((s.t1, "slow", s.instance, 1.0))
        ev.sort(key=lambda e: (e[0], _KIND_RANK[e[1]], e[2]))
        return ev


def inject_bursts(requests: Sequence[Request],
                  schedule: FaultSchedule, seed: int = 0
                  ) -> List[Request]:
    """Correlated tenant bursts: clone the burst tenant's own request
    shapes at Poisson arrivals inside each burst window (fresh rids, so
    the originals are untouched).  Returns base + burst requests; a
    no-op for schedules without bursts."""
    out = list(requests)
    if not schedule.bursts or not requests:
        return out
    rng = np.random.default_rng(seed)
    next_rid = max(r.rid for r in requests) + 1
    for b in schedule.bursts:
        donors = [r for r in requests if r.tenant == b.tenant] \
            or list(requests)
        t = b.t0
        while True:
            t += float(rng.exponential(1.0 / b.rate))
            if t >= b.t1:
                break
            d = donors[int(rng.integers(0, len(donors)))]
            out.append(Request(prompt_tokens=d.prompt_tokens,
                               decode_tokens=d.decode_tokens,
                               arrival=t, task=d.task, rid=next_rid,
                               tenant=b.tenant))
            next_rid += 1
    return out


# -- injector ----------------------------------------------------------------

class ChaosInjector:
    """Replay a :class:`FaultSchedule` against any Cluster-protocol
    backend, applying every event whose time has come at the top of a
    tick.  ``on_orphans`` (gateway failover) takes ownership of crash
    fallout; without it orphans requeue centrally like the legacy
    ``Cluster.fail_instance`` path."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self._events = schedule.events()
        self._i = 0
        self.log: List[Tuple[float, str, int, float]] = []

    @property
    def pending(self) -> int:
        return len(self._events) - self._i

    def step(self, cluster, t: float, on_orphans=None
             ) -> List[Tuple[str, int, float]]:
        applied: List[Tuple[str, int, float]] = []
        while self._i < len(self._events) \
                and self._events[self._i][0] <= t:
            _, kind, idx, arg = self._events[self._i]
            self._i += 1
            if idx >= cluster.m:
                continue            # schedule written for a larger fleet
            if kind == "fail":
                if idx not in cluster.alive():
                    continue        # already down
                orphans = cluster.fail_instance(
                    idx, requeue=(on_orphans is None))
                if on_orphans is not None:
                    on_orphans(orphans)
            elif kind == "recover":
                cluster.recover_instance(idx)
            else:
                cluster.set_speed_factor(idx, arg)
            self.log.append((t, kind, idx, arg))
            applied.append((kind, idx, arg))
        return applied


# -- health tracking ---------------------------------------------------------

class HealthTracker:
    """Per-instance health from *realized* service quality.

    Signal 1 is an EWMA of each completion's mean time-between-tokens,
    computed as ``(finished - first_token) / (decoded - 1)`` -- a pure
    function of bit-equal request fields on every backend.  Signal 2 is
    a decayed count of bad events (client cancels, hedged re-dispatches)
    attributed to the instance.  ``assess`` maps both into a degradation
    score in [0, 1] (0 = at the fleet median, 1 = at the breaker
    threshold) and opens a circuit breaker at score >= 1: the instance
    leaves every policy's candidate set for ``cooldown_s``, after which
    its history is forgotten and fresh samples decide again."""

    def __init__(self, m: int, alpha: float = 0.3,
                 breaker_factor: float = 2.5, min_samples: int = 8,
                 cooldown_s: float = 30.0, bad_weight: float = 0.25,
                 bad_decay: float = 0.995):
        self.alpha = alpha
        self.factor = breaker_factor
        self.min_samples = min_samples
        self.cooldown_s = cooldown_s
        self.bad_weight = bad_weight
        self.bad_decay = bad_decay
        self.m = 0
        self.ewma: List[float] = []
        self.n: List[int] = []
        self.bad: List[float] = []
        self.open_until: List[float] = []
        self.trips = 0
        self.ensure(m)

    def ensure(self, m: int):
        """Grow to ``m`` instances (autoscaling adds healthy nodes)."""
        while self.m < m:
            self.ewma.append(0.0)
            self.n.append(0)
            self.bad.append(0.0)
            self.open_until.append(-float("inf"))
            self.m += 1

    def reset(self, idx: int):
        """Forget an instance's history (it recovered as a fresh node)."""
        self.ewma[idx] = 0.0
        self.n[idx] = 0
        self.bad[idx] = 0.0
        self.open_until[idx] = -float("inf")

    def on_complete(self, idx: int, req: Request):
        if req.first_token is None or req.finished is None \
                or req.decoded < 2:
            return
        x = (req.finished - req.first_token) / (req.decoded - 1)
        if self.n[idx] == 0:
            self.ewma[idx] = x
        else:
            self.ewma[idx] = (self.alpha * x
                              + (1.0 - self.alpha) * self.ewma[idx])
        self.n[idx] += 1

    def on_bad(self, idx: int):
        self.bad[idx] += 1.0

    def assess(self, t: float, alive: Sequence[int]
               ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (healthy mask [m], degradation scores [m] in [0, 1])."""
        m = self.m
        scores = np.zeros(m)
        sampled = [i for i in alive if self.n[i] >= self.min_samples]
        med = (float(np.median([self.ewma[i] for i in sampled]))
               if sampled else 0.0)
        for i in range(m):
            self.bad[i] *= self.bad_decay
            rel = 0.0
            if med > 0.0 and self.n[i] >= self.min_samples:
                rel = (self.ewma[i] / med - 1.0) / (self.factor - 1.0)
            s = rel + self.bad_weight * self.bad[i]
            scores[i] = min(max(s, 0.0), 1.0)
        mask = np.ones(m, bool)
        for i in range(m):
            if t < self.open_until[i]:
                mask[i] = False
            elif scores[i] >= 1.0:
                # trip: open for cooldown_s, then forget and re-probe
                self.open_until[i] = t + self.cooldown_s
                self.ewma[i] = 0.0
                self.n[i] = 0
                self.bad[i] = 0.0
                self.trips += 1
                mask[i] = False
        if len(alive) and not any(mask[i] for i in alive):
            # guarded fallback: never breaker-out the whole alive fleet
            for i in alive:
                mask[i] = True
        return mask, scores
