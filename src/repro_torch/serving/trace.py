"""Cluster-wide request tracing: lifecycle spans with bounded memory.

Aggregate percentiles (``serving.metrics``) say *that* a policy won;
they cannot say *why*.  This module records the per-request lifecycle
event stream -- arrival, admission/backpressure, the routing decision
(with its score breakdown), instance-level prefill/decode progress,
preemption, completion -- as cheap structured records that every
execution backend emits identically:

  * the Python reference stepper (``core.simulator.SimInstance``) and
    the real engine (``serving.engine.LLMInstance``) emit events inline
    at their mutation sites;
  * the vectorized simulator (``core.vecsim``) buffers events as packed
    per-round numpy arrays inside its fused loop and drains them to
    records at span boundaries, so tracing never de-vectorizes the hot
    path; the drained stream is *identical* to the Python stepper's on
    the seeded parity scenarios (tests/test_trace.py);
  * the gateway (``serving.gateway``) emits the admission-side events
    (arrive/admit/shed/defer/evict/cancel) plus one ``route`` event per
    decision carrying the decision attribution.

Cost discipline: the default recorder is :data:`NULL` (a class whose
``enabled`` is False), so every emission site in the hot path pays one
attribute check and nothing else.  A live :class:`TraceRecorder` is a
ring buffer (``capacity`` events, oldest dropped first) with
deterministic head sampling: whether a request is traced is a pure
function of its rid, so the py and vec backends -- and a re-run --
sample the same requests.

Event schema (every event is ``(t, etype, rid, instance, tenant,
data)``; ``data`` is None or a flat dict -- the full field reference
lives in docs/TRACING.md):

  ============== ======================== ==========================
  etype          emitter                  data fields
  ============== ======================== ==========================
  arrive         gateway                  prompt
  admit          gateway                  --
  defer          gateway                  --
  shed           gateway                  --
  evict          gateway                  mode ("shed"|"defer")
  cancel         gateway                  --
  route          gateway                  inst, d_hat, wait, regret,
                                          forced?, + policy explain()
  inst_admit     sim / vecsim / engine    cached (prefix-cache tokens)
  prefill_chunk  sim / vecsim             tokens (chunked prefill only)
  prefill_done   sim / vecsim / engine    --
  first_token    sim / vecsim / engine    --
  preempt        sim / vecsim / engine    lost (progress tokens lost)
  complete       sim / vecsim / engine    --
  fail           sim / vecsim / engine    -- (rid = -1; instance event)
  recover        sim / vecsim / engine    -- (rid = -1; instance event)
  retry          gateway                  retries, due (backoff target)
  hedge          gateway                  inst (instance stolen from)
  ============== ======================== ==========================

Timestamps are simulated seconds on the emitting clock: gateway events
use the cluster clock, instance events the instance's virtual clock
(which may trail the cluster clock -- an ``inst_admit`` can carry a
smaller t than its ``route``).  :func:`canonical` orders a stream by
``(t, rid, etype-rank, instance)``, which is the equality contract the
py-vs-vec parity tests assert: the backends iterate in different orders
(instance-major vs round-major) but produce the same event *set* with
bit-identical timestamps.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

# -- event types ------------------------------------------------------------

EV_ARRIVE = "arrive"
EV_ADMIT = "admit"
EV_DEFER = "defer"
EV_SHED = "shed"
EV_EVICT = "evict"
EV_CANCEL = "cancel"
EV_ROUTE = "route"
EV_INST_ADMIT = "inst_admit"
EV_PREFILL_CHUNK = "prefill_chunk"
EV_PREFILL_DONE = "prefill_done"
EV_FIRST_TOKEN = "first_token"
EV_PREEMPT = "preempt"
EV_COMPLETE = "complete"
EV_FAIL = "fail"
EV_RECOVER = "recover"
EV_RETRY = "retry"
EV_HEDGE = "hedge"

#: canonical intra-timestamp rank (lifecycle order within one request)
EVENT_ORDER: Dict[str, int] = {
    EV_ARRIVE: 0, EV_ADMIT: 1, EV_DEFER: 2, EV_SHED: 3, EV_EVICT: 4,
    EV_CANCEL: 5, EV_ROUTE: 6, EV_INST_ADMIT: 7, EV_PREFILL_CHUNK: 8,
    EV_PREFILL_DONE: 9, EV_FIRST_TOKEN: 10, EV_PREEMPT: 11,
    EV_COMPLETE: 12, EV_FAIL: 13, EV_RECOVER: 14, EV_RETRY: 15,
    EV_HEDGE: 16,
}

EVENT_TYPES: Tuple[str, ...] = tuple(EVENT_ORDER)

#: (t, etype, rid, instance, tenant, data)
Event = Tuple[float, str, int, int, str, Optional[dict]]


def canonical(events) -> List[Event]:
    """Sort an event stream into the canonical order used for parity
    comparison and export: (t, rid, lifecycle rank, instance)."""
    return sorted(events,
                  key=lambda e: (e[0], e[2], EVENT_ORDER[e[1]], e[3]))


# -- recorders --------------------------------------------------------------

class NullRecorder:
    """The default no-trace recorder: emission sites check ``enabled``
    and skip event construction entirely, so an untraced run pays one
    attribute load per site."""

    enabled = False

    def sampled(self, rid: int) -> bool:
        return False

    def emit(self, t: float, etype: str, rid: int, instance: int = -1,
             tenant: str = "", data: Optional[dict] = None):
        pass

    def counter(self, t: float, name: str, value: float,
                instance: int = -1):
        pass

    def __len__(self) -> int:
        return 0


#: process-wide default recorder (shared, stateless)
NULL = NullRecorder()


class TraceRecorder:
    """Bounded-memory lifecycle recorder.

    ``capacity`` bounds the ring buffer (oldest events dropped first;
    ``dropped`` counts the loss).  ``sample`` in [0, 1] head-samples
    whole requests: the decision is a deterministic hash of the rid
    (salted by ``seed``), so every backend -- and every re-run -- traces
    the same subset, and a sampled request keeps its *complete*
    lifecycle.  Events with ``rid < 0`` (instance-scoped, e.g. ``fail``)
    are always recorded -- ``sample=0.0`` traces only those."""

    enabled = True

    def __init__(self, capacity: int = 262_144, sample: float = 1.0,
                 seed: int = 0):
        if not 0.0 <= sample <= 1.0:
            raise ValueError(f"sample must be in [0,1], got {sample}")
        self.capacity = capacity
        self.sample = sample
        self.seed = seed
        # Knuth multiplicative hash threshold in 32-bit space
        self._thresh = int(sample * (1 << 32))
        self._buf: deque = deque(maxlen=capacity)
        self.counters: List[Tuple[float, str, float, int]] = []
        self.n_emitted = 0

    def sampled(self, rid: int) -> bool:
        if self.sample >= 1.0:
            return True
        h = ((rid + self.seed) * 2654435761) & 0xFFFFFFFF
        return h < self._thresh

    def emit(self, t: float, etype: str, rid: int, instance: int = -1,
             tenant: str = "", data: Optional[dict] = None):
        if rid >= 0 and not self.sampled(rid):
            return
        self.n_emitted += 1
        self._buf.append((float(t), etype, int(rid), int(instance),
                          tenant, data))

    def counter(self, t: float, name: str, value: float,
                instance: int = -1):
        """Counter-track sample (queue depth, KV occupancy, backlog):
        kept out of the lifecycle stream so parity comparison and
        sampling never see them."""
        self.counters.append((float(t), name, float(value),
                              int(instance)))

    @property
    def dropped(self) -> int:
        return self.n_emitted - len(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    def events(self) -> List[Event]:
        """The retained stream in canonical order."""
        return canonical(self._buf)

    def raw_events(self) -> List[Event]:
        """The retained stream in emission order (debugging only --
        emission order is backend-dependent)."""
        return list(self._buf)
