"""Heuristic routing baselines (paper §A.1-A.2).

Every policy implements ``act(cluster) -> Optional[int]``: an instance index
for the head-of-queue request, ``m`` (or None) to defer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import impact
from repro_torch.core.simulator import Cluster


def _head(cluster: Cluster):
    return cluster.central[0]


class RoundRobin:
    """Alternate over alive instances (paper's primary baseline)."""
    name = "round_robin"

    def __init__(self):
        self._next = 0

    def act(self, cluster: Cluster) -> Optional[int]:
        alive = cluster.alive()
        if not alive:
            return None
        idx = alive[self._next % len(alive)]
        self._next += 1
        return idx


class JoinShortestQueue:
    """Least unprocessed prompt+decode tokens (§A.2.1)."""
    name = "jsq"

    def act(self, cluster: Cluster) -> Optional[int]:
        alive = cluster.alive()
        if not alive:
            return None
        loads = [cluster.instances[i].outstanding_tokens() for i in alive]
        return alive[int(np.argmin(loads))]


class DecodeBalancer:
    """Balance the sum of (oracle) decode tokens per instance (§A.1.6)."""
    name = "decode_balancer"

    def __init__(self):
        self.assigned: dict = {}

    def act(self, cluster: Cluster) -> Optional[int]:
        alive = cluster.alive()
        if not alive:
            return None
        req = _head(cluster)
        loads = []
        for i in alive:
            inst = cluster.instances[i]
            live = sum(max(r.decode_tokens - r.decoded, 0)
                       for r in inst.residents) + \
                sum(r.decode_tokens for r in inst.queue)
            loads.append(live)
        pick = alive[int(np.argmin(loads))]
        return pick


class DedicatedSmallLarge:
    """Half the instances take heavy-decode requests, half take light
    (§A.1.4) -- the paper's example of a severely sub-optimal router."""
    name = "dedicated"

    def __init__(self, profile):
        self.profile = profile
        self._rr = [0, 0]

    def act(self, cluster: Cluster) -> Optional[int]:
        alive = cluster.alive()
        if not alive:
            return None
        req = _head(cluster)
        heavy = self.profile.decode_is_heavy(req.decode_tokens)
        half = max(len(alive) // 2, 1)
        group = alive[:half] if heavy else alive[half:] or alive[:half]
        g = 0 if heavy else 1
        idx = group[self._rr[g] % len(group)]
        self._rr[g] += 1
        return idx


class MaxCapacityUsage:
    """Route to the instance with most free capacity if it fits (§A.2.2)."""
    name = "max_capacity"

    def act(self, cluster: Cluster) -> Optional[int]:
        alive = cluster.alive()
        if not alive:
            return None
        req = _head(cluster)
        frees = [cluster.instances[i].free_tokens() for i in alive]
        best = int(np.argmax(frees))
        if frees[best] < req.prompt_tokens + req.decode_tokens:
            return len(cluster.instances)          # defer
        return alive[best]


class MinMin:
    """Classical min-min (§A.2.3): pick the instance minimizing the
    estimated finish time of the head request (≈ SJF on homogeneous
    instances).  Uses the upper bound of the predicted decode bucket when a
    prediction is attached, else the oracle decode length."""
    name = "min_min"

    def __init__(self, profile):
        self.profile = profile

    def act(self, cluster: Cluster) -> Optional[int]:
        alive = cluster.alive()
        if not alive:
            return None
        req = _head(cluster)
        d_est = req.decode_tokens
        size = req.prompt_tokens + d_est
        finish = []
        for i in alive:
            inst = cluster.instances[i]
            # start immediately if it fits; else wait for the earliest
            # completion.  Light tie-break on outstanding work.
            fits = (inst.free_tokens() >= size
                    and len(inst.residents) < inst.n_slots)
            wait = 0.0 if fits else inst.earliest_completion()
            finish.append(wait + self.profile.request_time(
                req.prompt_tokens, d_est)
                + 1e-6 * inst.outstanding_tokens())
        return alive[int(np.argmin(finish))]


class ImpactGreedy:
    """Pure workload-impact heuristic: route to argmax r_mixing (Eq. 1-2).
    This is the 'lightweight heuristic' the RL variants are guided by."""
    name = "impact_greedy"

    def __init__(self, profile, alpha: float = 0.5):
        self.profile = profile
        self.alpha = alpha

    def act(self, cluster: Cluster) -> Optional[int]:
        alive = cluster.alive()
        if not alive:
            return None
        req = _head(cluster)
        sums = [cluster.instances[i].resident_token_sum() +
                sum(r.prompt_tokens + r.decode_tokens
                    for r in cluster.instances[i].queue)
                for i in alive]
        scores = impact.mixing_per_instance(
            self.profile, req.prompt_tokens, req.decode_tokens, sums,
            self.alpha)
        return alive[int(np.argmax(scores))]


def make_policy(name: str, profile):
    if name == "round_robin":
        return RoundRobin()
    if name == "jsq":
        return JoinShortestQueue()
    if name == "decode_balancer":
        return DecodeBalancer()
    if name == "dedicated":
        return DedicatedSmallLarge(profile)
    if name == "max_capacity":
        return MaxCapacityUsage()
    if name == "min_min":
        return MinMin(profile)
    if name == "impact_greedy":
        return ImpactGreedy(profile)
    raise KeyError(name)
