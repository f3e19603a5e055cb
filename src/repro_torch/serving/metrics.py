"""Streaming SLO metrics for the serving gateway.

An online router cannot wait for the episode to end and run
``summarize()`` over a materialized request list: operators watch
*rolling* latency percentiles and SLO attainment while traffic is
flowing.  This module provides the two streaming estimators the gateway
publishes and the tracker that aggregates them per tenant:

  * ``WindowedReservoir`` -- exact quantiles over a sliding time window
    (the last W seconds of samples); what a dashboard's "P95 over the
    last 5 minutes" panel reads.  Memory is bounded by the arrival rate
    times the window.
  * ``P2Quantile`` -- the P-square algorithm (Jain & Chlamtac 1985):
    a constant-memory estimate of a lifetime quantile over an unbounded
    stream, for long-running deployments where keeping every sample is
    not an option.  Accuracy vs numpy quantiles is covered by
    tests/test_gateway.py.
  * ``StreamMetrics`` -- per-metric (TTFT / TBT / E2E) windowed +
    lifetime percentiles, per-tenant breakdowns, SLO-attainment and
    shed counters, snapshot() for reporting.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import Request


class P2Quantile:
    """P-square single-quantile estimator: O(1) memory, O(1) update.

    Keeps 5 markers whose heights track the quantile ``q`` of everything
    ever added.  Small-n behavior: with fewer than 5 samples ``value()``
    is the exact ``np.quantile`` of what has arrived; from the 5th
    sample on it switches to the marker estimate, which needs on the
    order of tens of samples to converge for tail quantiles (the middle
    marker starts at the sample median and drifts toward ``q``).
    Readers that must be accurate at tiny lifetime counts should keep
    the early samples and use exact quantiles until the estimator has
    warmed up -- ``_MetricTrack.report`` does exactly that (falls back
    to ``np.quantile`` over the first ``_EXACT_KEEP`` samples while the
    lifetime count is still within them)."""

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0,1), got {q}")
        self.q = q
        self._init: list = []          # first 5 samples, sorted lazily
        self.n = 0
        # marker heights / positions / desired positions (after init)
        self._h: Optional[np.ndarray] = None
        self._pos: Optional[np.ndarray] = None
        self._des: Optional[np.ndarray] = None
        self._inc = np.array([0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0])

    def add(self, x: float):
        self.n += 1
        if self._h is None:
            self._init.append(float(x))
            if len(self._init) == 5:
                self._init.sort()
                self._h = np.array(self._init, float)
                self._pos = np.arange(1.0, 6.0)
                self._des = np.array(
                    [1.0, 1.0 + 2.0 * self.q, 1.0 + 4.0 * self.q,
                     3.0 + 2.0 * self.q, 5.0])
            return
        h, pos = self._h, self._pos
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = int(np.searchsorted(h, x, side="right")) - 1
        pos[k + 1:] += 1.0
        self._des += self._inc
        # adjust the three interior markers with the parabolic formula
        for i in (1, 2, 3):
            d = self._des[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or \
                    (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                s = 1.0 if d >= 1.0 else -1.0
                hp = h[i] + s / (pos[i + 1] - pos[i - 1]) * (
                    (pos[i] - pos[i - 1] + s) * (h[i + 1] - h[i])
                    / (pos[i + 1] - pos[i])
                    + (pos[i + 1] - pos[i] - s) * (h[i] - h[i - 1])
                    / (pos[i] - pos[i - 1]))
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:                      # linear fallback
                    j = i + int(s)
                    h[i] = h[i] + s * (h[j] - h[i]) / (pos[j] - pos[i])
                pos[i] += s

    def value(self) -> Optional[float]:
        if self.n == 0:
            return None
        if self._h is None:
            xs = sorted(self._init)
            return float(np.quantile(xs, self.q))
        return float(self._h[2])


class WindowedReservoir:
    """Samples from the last ``window`` seconds; exact quantiles via
    numpy over the retained slice.  ``max_samples`` bounds memory under
    extreme rates (oldest dropped first -- the window shrinks)."""

    def __init__(self, window: float = 300.0, max_samples: int = 65536):
        self.window = window
        self.max_samples = max_samples
        self._buf: deque = deque()     # (t, value)
        self.total = 0                 # lifetime count

    def add(self, t: float, x: float):
        self.total += 1
        self._buf.append((t, float(x)))
        if len(self._buf) > self.max_samples:
            self._buf.popleft()

    def _prune(self, now: float):
        cut = now - self.window
        buf = self._buf
        while buf and buf[0][0] < cut:
            buf.popleft()

    def values(self, now: Optional[float] = None) -> np.ndarray:
        if now is not None:
            self._prune(now)
        return np.array([v for _, v in self._buf])

    def quantile(self, q, now: Optional[float] = None):
        xs = self.values(now)
        if xs.size == 0:
            return None
        out = np.quantile(xs, q)
        return float(out) if np.ndim(out) == 0 else out

    def __len__(self) -> int:
        return len(self._buf)


@dataclass(frozen=True)
class SLO:
    """Per-request latency objectives (seconds); None = not enforced.
    A request attains the SLO iff every configured bound holds."""
    ttft_s: Optional[float] = 10.0
    tbt_s: Optional[float] = 0.5
    e2e_s: Optional[float] = 60.0

    def attained(self, req: Request) -> bool:
        if self.ttft_s is not None and (req.ttft is None
                                        or req.ttft > self.ttft_s):
            return False
        if self.tbt_s is not None and req.tbt is not None \
                and req.tbt > self.tbt_s:
            return False
        if self.e2e_s is not None and (req.e2e is None
                                       or req.e2e > self.e2e_s):
            return False
        return True


METRIC_KEYS = ("ttft", "tbt", "e2e")


_EXACT_KEEP = 64      # early lifetime samples kept for exact small-n quantiles


class _MetricTrack:
    """One latency metric: sliding-window reservoir + lifetime P2 set.

    The first ``_EXACT_KEEP`` lifetime samples are also kept verbatim:
    while the lifetime count is still within that prefix the ``_life``
    quantiles are exact (``np.quantile``) instead of the still-warming
    P-square estimate, whose tail markers are unreliable at tens of
    samples (see ``P2Quantile``)."""

    def __init__(self, window: float, quantiles: Sequence[float]):
        self.win = WindowedReservoir(window)
        self.p2 = {q: P2Quantile(q) for q in quantiles}
        self._exact: list = []

    def add(self, t: float, x: float):
        self.win.add(t, x)
        if len(self._exact) < _EXACT_KEEP:
            self._exact.append(float(x))
        for est in self.p2.values():
            est.add(x)

    def report(self, now: float, quantiles: Sequence[float]) -> Dict:
        out = {}
        for q in quantiles:
            v = self.win.quantile(q, now)
            out[f"p{int(q * 100)}"] = v
        small_n = 0 < self.win.total <= len(self._exact)
        for q, est in self.p2.items():
            out[f"p{int(q * 100)}_life"] = (
                float(np.quantile(self._exact, q)) if small_n
                else est.value())
        out["n_window"] = len(self.win)
        out["n_life"] = self.win.total
        return out


class _TenantStats:
    def __init__(self, window: float, quantiles: Sequence[float]):
        self.metrics = {k: _MetricTrack(window, quantiles)
                        for k in METRIC_KEYS}
        self.completed = 0
        self.shed = 0
        self.cancelled = 0
        self.admitted = 0
        self.slo_attained = 0
        self.orphaned = 0        # routed to an instance that crashed
        self.retried = 0         # bounded-backoff re-admissions
        self.hedged = 0          # hedged re-dispatches (stragglers)


class _Attribution:
    """Joins routing decisions to request actuals.

    At decision time the gateway records, per request: the length
    estimate ``d_hat`` the policy saw, the regret of the chosen
    instance against the r_mixing yardstick (``max(scores) -
    scores[chosen]``, 0 when the policy picked the yardstick's argmax),
    and whether it agreed with that argmax.  At completion the decision
    is joined to the realized decode length, yielding predictor drift
    (|d_hat - d| quantiles, bucket accuracy when the predictor exposes
    ``bucket_of``) and per-policy decision quality in ``report()``.
    Decisions whose request never completes (shed downstream, failed
    instance) stay in ``open`` and are reported as ``unjoined``."""

    def __init__(self, policy: str, bucket_of, window: float,
                 quantiles: Sequence[float]):
        self.policy = policy
        self.bucket_of = bucket_of
        self.quantiles = quantiles
        self.open: Dict[int, Tuple[int, float, bool]] = {}
        self.n_decisions = 0
        self.n_agree = 0
        self.regret = _MetricTrack(window, quantiles)
        self.abs_err = _MetricTrack(window, quantiles)
        self.n_joined = 0
        self.bucket_hits = 0
        self.bucket_total = 0

    def on_decision(self, rid: int, d_hat: int, regret: float,
                    agree: bool, now: float):
        self.n_decisions += 1
        self.n_agree += int(agree)
        self.regret.add(now, max(float(regret), 0.0))
        self.open[rid] = (int(d_hat), float(regret), bool(agree))

    def on_complete(self, req: Request, now: float):
        dec = self.open.pop(req.rid, None)
        if dec is None:
            return
        d_hat, _, _ = dec
        self.n_joined += 1
        actual = int(req.decode_tokens)
        self.abs_err.add(now, abs(d_hat - actual))
        if self.bucket_of is not None:
            self.bucket_total += 1
            self.bucket_hits += int(self.bucket_of(d_hat)
                                    == self.bucket_of(actual))

    def report(self, now: float) -> Dict:
        return {
            "policy": self.policy,
            "decisions": self.n_decisions,
            "agree_rate": (self.n_agree / self.n_decisions
                           if self.n_decisions else None),
            "regret": self.regret.report(now, self.quantiles),
            "drift": {
                "joined": self.n_joined,
                "unjoined": len(self.open),
                "abs_err": self.abs_err.report(now, self.quantiles),
                "bucket_accuracy": (self.bucket_hits / self.bucket_total
                                    if self.bucket_total else None),
            },
        }


@dataclass
class StreamMetrics:
    """Rolling gateway metrics: call ``on_admit`` / ``on_shed`` /
    ``on_complete`` from the serving loop, read ``snapshot(now)``."""

    window: float = 300.0
    quantiles: Tuple[float, ...] = (0.5, 0.95, 0.99)
    slo: SLO = field(default_factory=SLO)

    def __post_init__(self):
        self._all = _TenantStats(self.window, self.quantiles)
        self._tenants: Dict[str, _TenantStats] = {}
        self._attr: Optional[_Attribution] = None

    # -- decision attribution ------------------------------------------
    def enable_attribution(self, policy: str = "?", bucket_of=None):
        """Turn on routing-decision attribution.  ``bucket_of`` is the
        length predictor's realized-length bucketizer (None when the
        predictor has no bucket vocabulary, e.g. the oracle); idempotent
        -- re-enabling keeps the existing join state."""
        if self._attr is None:
            self._attr = _Attribution(policy, bucket_of, self.window,
                                      self.quantiles)

    def on_decision(self, req: Request, d_hat: int, regret: float,
                    agree: bool, now: Optional[float] = None):
        """One routing decision (no-op until ``enable_attribution``)."""
        if self._attr is not None:
            t = now if now is not None else req.arrival
            self._attr.on_decision(req.rid, d_hat, regret, agree, t)

    def _tenant(self, tenant: str) -> _TenantStats:
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantStats(self.window,
                                                      self.quantiles)
        return st

    def on_admit(self, tenant: str = "default"):
        self._all.admitted += 1
        self._tenant(tenant).admitted += 1

    def on_shed(self, tenant: str = "default"):
        self._all.shed += 1
        self._tenant(tenant).shed += 1

    def on_cancel(self, tenant: str = "default"):
        """A deferred request whose client deadline passed was dropped
        from the overflow queue."""
        self._all.cancelled += 1
        self._tenant(tenant).cancelled += 1

    def on_evict(self, tenant: str = "default", shed: bool = True):
        """Weighted-fair eviction pushed an already-admitted request
        back out of the bounded queue.  ``shed=True`` moves it from the
        admitted to the shed column; ``shed=False`` (defer mode: the
        request returns to the client overflow and will be re-admitted)
        only reverses the admit, so offered = admitted + shed keeps
        counting each request exactly once either way."""
        for st in (self._all, self._tenant(tenant)):
            st.admitted -= 1
            if shed:
                st.shed += 1

    def on_orphan(self, tenant: str = "default"):
        """A routed request's instance crashed under it."""
        self._all.orphaned += 1
        self._tenant(tenant).orphaned += 1

    def on_retry(self, tenant: str = "default"):
        """A crash orphan was scheduled for backoff re-admission."""
        self._all.retried += 1
        self._tenant(tenant).retried += 1

    def on_hedge(self, tenant: str = "default"):
        """A stuck request was withdrawn for hedged re-dispatch."""
        self._all.hedged += 1
        self._tenant(tenant).hedged += 1

    def on_complete(self, req: Request, tenant: str = "default"):
        now = req.finished if req.finished is not None else 0.0
        if self._attr is not None:
            self._attr.on_complete(req, now)
        ok = self.slo.attained(req)
        for st in (self._all, self._tenant(tenant)):
            st.completed += 1
            st.slo_attained += int(ok)
            for key, val in (("ttft", req.ttft), ("tbt", req.tbt),
                             ("e2e", req.e2e)):
                if val is not None:
                    st.metrics[key].add(now, val)

    # -- reporting -----------------------------------------------------
    def _report_one(self, st: _TenantStats, now: float) -> Dict:
        offered = st.admitted + st.shed
        return {
            "admitted": st.admitted,
            "shed": st.shed,
            "shed_rate": st.shed / offered if offered else 0.0,
            "cancelled": st.cancelled,
            "completed": st.completed,
            "orphaned": st.orphaned,
            "retried": st.retried,
            "hedged": st.hedged,
            "slo_attained": st.slo_attained,
            "slo_rate": (st.slo_attained / st.completed
                         if st.completed else None),
            **{k: st.metrics[k].report(now, self.quantiles)
               for k in METRIC_KEYS},
        }

    def snapshot(self, now: float) -> Dict:
        out = self._report_one(self._all, now)
        out["tenants"] = {t: self._report_one(st, now)
                          for t, st in sorted(self._tenants.items())}
        # per-tenant shed burden: the tenant's share of all shedding
        # over its share of all offered traffic.  1.0 = sheds in
        # proportion to its traffic; > 1 absorbs more than its share
        # (the weighted-fair queue pushes burden onto over-share
        # tenants and drives protected tenants toward 0).
        tot_shed = sum(st.shed for st in self._tenants.values())
        tot_off = sum(st.admitted + st.shed
                      for st in self._tenants.values())
        for t, st in self._tenants.items():
            offered = st.admitted + st.shed
            if tot_shed and offered and tot_off:
                out["tenants"][t]["shed_burden"] = \
                    (st.shed / tot_shed) / (offered / tot_off)
            else:
                out["tenants"][t]["shed_burden"] = None
        out["shed_fairness"] = self.shed_fairness()
        if self._attr is not None:
            out["attribution"] = self._attr.report(now)
        return out

    def shed_fairness(self) -> Optional[float]:
        """Jain's fairness index over per-tenant admit rates
        (admitted / offered): 1.0 means every tenant saw the same
        admission probability, 1/n means one tenant absorbed all the
        shedding.  The per-tenant shed-fairness signal the weighted-fair
        queue is judged by (None until any tenant has offered load)."""
        rates = []
        for st in self._tenants.values():
            offered = st.admitted + st.shed
            if offered:
                rates.append(st.admitted / offered)
        if not rates:
            return None
        x = np.array(rates, float)
        denom = len(x) * float((x ** 2).sum())
        return float(x.sum()) ** 2 / denom if denom else 1.0


def format_snapshot(snap: Dict) -> str:
    """Human-readable one-table rendering of ``snapshot()``."""
    def row(name, d):
        e2e, ttft = d["e2e"], d["ttft"]

        def f(v):
            return f"{v:7.2f}" if v is not None else "      -"
        slo = d["slo_rate"]
        slo_s = f"{slo:.1%}" if slo is not None else "-"
        return (f"{name:<12s} n={d['completed']:<5d} "
                f"shed={d['shed']:<4d} "
                f"e2e p50/p95/p99={f(e2e.get('p50'))}{f(e2e.get('p95'))}"
                f"{f(e2e.get('p99'))}  ttft p95={f(ttft.get('p95'))}  "
                f"slo={slo_s}")
    lines = [row("ALL", snap)]
    for t, d in snap.get("tenants", {}).items():
        lines.append(row(t, d))
    return "\n".join(lines)
