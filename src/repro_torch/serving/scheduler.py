"""Instance-level batching schedulers (paper §A.1).

All are non-preemptive in admission order: once a request starts it is
prioritized over ones that have not (the engine enforces that; preemption
for memory is a separate mechanism).  The router is deliberately DISTINCT
from these (paper §5: optimize routing for ANY instance-level scheduler).
"""
from __future__ import annotations

from typing import List, Optional, Protocol

from repro_torch.core.profiles import HardwareProfile
from repro_torch.serving.request import Request


class InstanceScheduler(Protocol):
    name: str

    def pick(self, queue: List[Request], free_tokens: int,
             profile: HardwareProfile) -> Optional[int]:
        """Index into queue of the next request to admit, or None."""


def _admission_tokens(r: Request) -> int:
    """KV needed AT ADMISSION (prompt + any pre-preemption progress) --
    vLLM semantics: decode growth is handled later by preemption, not by
    reserving the (unknown) full output length up front."""
    return r.prompt_tokens + r.decoded


def _predicted_total(r: Request, profile: HardwareProfile) -> int:
    return r.prompt_tokens + r.decode_tokens


class FCFS:
    """First-come-first-served (vLLM default; Yu et al. 2022)."""
    name = "fcfs"

    def pick(self, queue, free_tokens, profile):
        if not queue:
            return None
        if _admission_tokens(queue[0]) <= free_tokens:
            return 0
        return None


class BinPacking:
    """Largest PREDICTED-size request whose admission cost fits
    (S^3-style packing on the predicted output length; Jin et al. 2023).
    Ties broken FCFS."""
    name = "bin_packing"

    def pick(self, queue, free_tokens, profile):
        best, best_size = None, -1
        for i, r in enumerate(queue):
            if _admission_tokens(r) > free_tokens:
                continue
            size = _predicted_total(r, profile)
            if size > best_size:
                best, best_size = i, size
        return best


class LeastWorkLeft:
    """Smallest remaining decode first."""
    name = "least_work_left"

    def pick(self, queue, free_tokens, profile):
        best, best_d = None, None
        for i, r in enumerate(queue):
            if _admission_tokens(r) > free_tokens:
                continue
            if best_d is None or r.decode_tokens < best_d:
                best, best_d = i, r.decode_tokens
        return best


SCHEDULERS = {c.name: c for c in (FCFS, BinPacking, LeastWorkLeft)}


def get_scheduler(name: str) -> InstanceScheduler:
    return SCHEDULERS[name]()
