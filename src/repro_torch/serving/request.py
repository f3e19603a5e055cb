"""Request objects and lifecycle metrics shared by the engine, the
discrete-event simulator, and the router."""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import List, Optional


class Phase(enum.Enum):
    QUEUED = "queued"          # at the central router
    INSTANCE_QUEUE = "iqueue"  # admitted to an instance's local queue
    PREFILL = "prefill"
    DECODE = "decode"
    PREEMPTED = "preempted"
    DONE = "done"
    SHED = "shed"              # rejected at the gateway (backpressure)
    CANCELLED = "cancelled"    # client deadline passed while deferred


_ids = itertools.count()


@dataclass
class Request:
    prompt_tokens: int
    decode_tokens: int                  # ground-truth output length
    arrival: float = 0.0
    task: str = "unknown"               # sentiment/entity/qna/... (Table 1)
    rid: int = field(default_factory=lambda: next(_ids))
    predicted_bucket: Optional[int] = None   # router's length prediction
    predicted_decode: Optional[int] = None   # d-hat tokens (predictor)
    tenant: str = "default"                  # gateway multi-tenant label
    tokens: Optional[list] = None            # real token ids (engine path)
    deadline: Optional[float] = None         # client gives up after this t
    # prefix-cache identity (core.prefix_cache): per-block hash chain of
    # the prompt, and of the full prompt+response context (inserted at
    # completion so the NEXT turn of the conversation can hit it).
    # ``None`` opts the request out of the cache model entirely.
    prefix_hashes: Optional[tuple] = None
    full_hashes: Optional[tuple] = None

    # lifecycle (filled by engine/simulator)
    phase: Phase = Phase.QUEUED
    instance: Optional[int] = None
    routed_at: Optional[float] = None
    prefill_done: Optional[float] = None
    first_token: Optional[float] = None      # TTFT anchor
    finished: Optional[float] = None
    decoded: int = 0                         # output tokens produced so far
    prefilled: int = 0                       # prompt tokens processed
    admitted_idx: int = -1                   # admission order (eviction)
    token_times: List[float] = field(default_factory=list)
    preemptions: int = 0
    cached_prefix: int = 0                   # prefill tokens served from cache
    retries: int = 0                         # crash-orphan re-admissions
    hedges: int = 0                          # hedged re-dispatches

    # -- metrics -----------------------------------------------------------
    @property
    def e2e(self) -> Optional[float]:
        if self.finished is None:
            return None
        return self.finished - self.arrival

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    @property
    def tbt(self) -> Optional[float]:
        """Mean time between output tokens."""
        if len(self.token_times) < 2:
            return None
        spans = [b - a for a, b in zip(self.token_times, self.token_times[1:])]
        return sum(spans) / len(spans)

    def reset_progress(self):
        """Preemption: work is lost; request restarts its prefill."""
        self.decoded = 0
        self.prefilled = 0
        self.cached_prefix = 0
        self.phase = Phase.PREEMPTED
        self.preemptions += 1

    @property
    def total_context(self) -> int:
        return self.prefilled + self.decoded


def summarize(requests) -> dict:
    done = [r for r in requests if r.finished is not None]
    if not done:
        return {"n": 0}
    e2e = [r.e2e for r in done]
    ttft = [r.ttft for r in done if r.ttft is not None]
    tbt = [r.tbt for r in done if r.tbt is not None]
    mean = lambda xs: sum(xs) / max(len(xs), 1)
    return {
        "n": len(done),
        "e2e_mean": mean(e2e), "e2e_max": max(e2e),
        "ttft_mean": mean(ttft) if ttft else None,
        "tbt_mean": mean(tbt) if tbt else None,
        "makespan": max(r.finished for r in done) - min(r.arrival
                                                        for r in done),
        "preemptions": sum(r.preemptions for r in done),
    }
