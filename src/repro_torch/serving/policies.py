"""Pluggable routing policies for the serving gateway.

One ``RoutingPolicy`` protocol unifies the repo's previously scattered
routing paths -- the heuristic baselines in ``core.policies`` (driven
through ``simulator.run_heuristic``), the r_mixing heuristic embedded in
``RoutingEnv.guidance_bonus``, and the trained RL agent driven by
``ManagedCluster.serve`` -- so any of them is a one-line swap in the
gateway / ``launch.serve``:

    route(cluster, req, d_hat) -> Optional[int]

returns an instance index, or ``None`` / ``>= cluster.m`` to defer the
head-of-queue request.  ``d_hat`` is the gateway's decode-length
estimate (the micro-batched learned predictor in production, the oracle
in parity tests); policies never read ``req.decode_tokens`` directly.

In the port the RL policy's Q-network is a torch module
(``repro_torch.core.dqn``) on the agent's device.
"""
from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core import policies as legacy, rl_router as rl
from repro_torch.core import dqn, state as state_lib
from repro_torch.core.prefix_cache import hit_fractions
from repro_torch.serving import trace as tr_lib


def healthy_candidates(cluster):
    """Alive instances minus any the gateway's circuit breaker has
    opened on (``cluster.health_mask``, stamped per tick by the
    gateway's HealthTracker).  Falls back to the full alive set if the
    mask would empty it -- a degraded instance beats no instance."""
    alive = cluster.alive()
    hm = getattr(cluster, "health_mask", None)
    if hm is None:
        return alive
    ok = [i for i in alive if i >= len(hm) or hm[i]]
    return ok or alive


@runtime_checkable
class RoutingPolicy(Protocol):
    """Structural protocol: ``route`` is required.  Policies MAY also
    provide ``explain(cluster, req, d_hat) -> dict`` returning the
    per-instance score breakdown behind the same decision ``route``
    would make (r_mixing terms, loads, cache-hit fractions, Q-values);
    the gateway attaches it to the ``route`` trace event for decision
    attribution.  ``explain`` must be read-only: it is called AFTER
    ``route`` on the same state and must not perturb the decision
    stream (the traced-vs-untraced overhead gate enforces this)."""

    name: str

    def route(self, cluster, req, d_hat: int) -> Optional[int]:
        ...


class RoundRobinPolicy:
    """Alternate over alive (and non-breakered) instances (the paper's
    primary baseline)."""
    name = "rr"

    def __init__(self):
        self._next = 0

    def route(self, cluster, req, d_hat: int) -> Optional[int]:
        alive = healthy_candidates(cluster)
        if not alive:
            return None
        idx = alive[self._next % len(alive)]
        self._next += 1
        return idx


class LeastOutstandingWork:
    """JSQ on estimated outstanding tokens.  Unlike the legacy oracle
    JSQ (§A.2.1) the queue-side estimate uses d_hat bookkeeping per
    routed request, so it works with a learned predictor."""
    name = "jsq"

    def __init__(self):
        self._est: dict = {}           # rid -> d_hat at routing time

    def route(self, cluster, req, d_hat: int) -> Optional[int]:
        alive = healthy_candidates(cluster)
        if not alive:
            return None
        loads = self._loads(cluster, alive)
        pick = alive[int(np.argmin(loads))]
        self._est[req.rid] = d_hat
        return pick

    def _loads(self, cluster, alive):
        loads = []
        for i in alive:
            inst = cluster.instances[i]
            todo = 0.0
            for r in inst.residents:
                todo += (r.prompt_tokens - r.prefilled) + max(
                    self._est.get(r.rid, r.decode_tokens) - r.decoded, 0)
            for r in inst.queue:
                todo += r.prompt_tokens + self._est.get(r.rid,
                                                        r.decode_tokens)
            loads.append(todo)
        return loads

    def explain(self, cluster, req, d_hat: int) -> dict:
        """Estimated outstanding-token load per alive instance (the
        argmin is the pick)."""
        alive = healthy_candidates(cluster)
        return {"loads": [float(x)
                          for x in self._loads(cluster, alive)],
                "alive": list(alive)}


class PrefixAffinityPolicy:
    """Sticky-session baseline (llama-balancer's prompt-cache routing):
    send the request to the alive instance holding its longest cached
    prefix; break ties -- including the all-miss cold path -- by least
    outstanding tokens.  Purely greedy on cache affinity, no workload
    mixing: the baseline the cache-weighted heuristics must beat."""
    name = "sticky"

    def route(self, cluster, req, d_hat: int) -> Optional[int]:
        alive = healthy_candidates(cluster)
        if not alive:
            return None
        fracs = hit_fractions(cluster, req)
        best = max(fracs[i] for i in alive)
        tied = [i for i in alive if fracs[i] == best]
        if len(tied) == 1:
            return tied[0]
        loads = [cluster.instances[i].outstanding_tokens() for i in tied]
        return tied[int(np.argmin(loads))]

    def explain(self, cluster, req, d_hat: int) -> dict:
        """Per-instance cached-prefix hit fraction + the tie-break
        outstanding-token loads."""
        return {"hit_frac": [float(f)
                             for f in hit_fractions(cluster, req)],
                "loads": [float(inst.outstanding_tokens())
                          for inst in cluster.instances]}


class MixingImpactPolicy:
    """The paper's workload-impact heuristic (Eq. 1-2) with the
    capacity-fit defer correction -- exactly the prior that guides the
    RL router, served standalone.  ``cache_weight > 0`` adds the
    per-instance prefix-cache hit fraction to the scores ("mixing+cache"
    in the factory), trading load balance against prefill reuse."""
    name = "mixing"

    def __init__(self, alpha: float = 0.5,
                 defer_prior_bias: float = -0.05,
                 cache_weight: float = 0.0):
        self.alpha = alpha
        self.defer_prior_bias = defer_prior_bias
        self.cache_weight = cache_weight
        if cache_weight:
            self.name = "mixing+cache"

    def route(self, cluster, req, d_hat: int) -> Optional[int]:
        if not cluster.alive():
            return None
        scores = rl.mixing_scores(cluster, req, d_hat, self.alpha,
                                  cache_weight=self.cache_weight)
        bonus = rl.guidance_from_scores(cluster, req, d_hat, scores,
                                        self.defer_prior_bias)
        a = int(np.argmax(bonus))
        return a if a < cluster.m else None

    def explain(self, cluster, req, d_hat: int) -> dict:
        """The r_mixing score vector (with this policy's cache weight)
        and the capacity-corrected guidance bonus whose argmax is the
        decision."""
        scores = rl.mixing_scores(cluster, req, d_hat, self.alpha,
                                  cache_weight=self.cache_weight)
        bonus = rl.guidance_from_scores(cluster, req, d_hat, scores,
                                        self.defer_prior_bias)
        out = {"scores": [float(s) for s in scores],
               "bonus": [float(b) for b in bonus]}
        if self.cache_weight:
            out["hit_frac"] = [float(f)
                               for f in hit_fractions(cluster, req)]
        return out


class RLPolicy:
    """A trained DQN router behind the gateway.  Decision math is
    identical to ``ManagedCluster.serve`` (greedy masked Q + guidance
    prior, decomposed-arch aware), so a gateway with the oracle
    predictor reproduces the closed-loop path decision for decision
    (tests/test_gateway.py::test_policy_parity_with_managed_cluster)."""
    name = "rl"

    def __init__(self, agent, router_cfg: rl.RouterConfig):
        self.agent = agent
        self.cfg = router_cfg

    def hot_swap(self, params, target=None):
        """Atomically publish refreshed Q weights onto the served agent.

        Each swap is a single attribute rebinding (one reference store,
        atomic under the GIL) of a Q-network module the publisher no
        longer mutates: a concurrent ``route`` reads
        ``self.agent.params`` exactly once per decision and sees either
        the old or the new network in full -- never a torn mix of
        layers.  ``target``, when given, replaces the target network the
        same way."""
        self.agent.params = params
        if target is not None:
            self.agent.target = target

    def route(self, cluster, req, d_hat: int) -> Optional[int]:
        with tr_lib.span("repro.route"):
            cfg = self.cfg
            w_sel = cfg.guidance_floor if cfg.variant == "guided" else 0.0
            scored = (self.agent.cfg.q_arch == "decomposed"
                      or cluster.m + 1 == self.agent.cfg.n_actions)
            with tr_lib.span("repro.route.featurize"):
                mask = state_lib.action_mask(cluster)
                scores = rl.mixing_scores(cluster, req, d_hat, cfg.alpha,
                                          cache_weight=cfg.cache_weight)
                bonus = rl.guidance_from_scores(cluster, req, d_hat, scores,
                                                cfg.defer_prior_bias)
                if scored:
                    s = state_lib.featurize(
                        cluster, cluster.profile, n_buckets=cfg.n_buckets,
                        include_impact=cfg.include_impact_features,
                        predict_decode=lambda r: d_hat, alpha=cfg.alpha,
                        include_hardware=cfg.include_hardware_features,
                        include_cache=cfg.include_cache_features,
                        include_health=cfg.include_health_features)
            if scored:
                prior = w_sel * bonus if w_sel else None
                with tr_lib.span("repro.route.act"):
                    return int(self.agent.act(
                        s, mask, epsilon=0.0, prior=prior,
                        q_squash=cfg.q_squash if w_sel else 0.0))
            # fixed-m MLP cannot score a resized cluster: fall back to the
            # guidance heuristic (same degradation as ManagedCluster)
            bonus[~mask] = -np.inf
            return int(np.argmax(bonus))

    def explain(self, cluster, req, d_hat: int) -> dict:
        """Decompose the greedy decision: raw Q-values, the guidance
        prior actually added, and the selection vector ``sel`` whose
        masked argmax is the action ``route`` returns."""
        cfg = self.cfg
        mask = state_lib.action_mask(cluster)
        w_sel = cfg.guidance_floor if cfg.variant == "guided" else 0.0
        scores = rl.mixing_scores(cluster, req, d_hat, cfg.alpha,
                                  cache_weight=cfg.cache_weight)
        bonus = rl.guidance_from_scores(cluster, req, d_hat, scores,
                                        cfg.defer_prior_bias)
        out = {"scores": [float(s) for s in scores],
               "bonus": [float(b) for b in bonus]}
        if not (self.agent.cfg.q_arch == "decomposed"
                or cluster.m + 1 == self.agent.cfg.n_actions):
            sel = np.where(mask, bonus, -np.inf)
            out["sel"] = [float(x) for x in sel]
            out["fallback"] = True
            return out
        s = state_lib.featurize(
            cluster, cluster.profile, n_buckets=cfg.n_buckets,
            include_impact=cfg.include_impact_features,
            predict_decode=lambda r: d_hat, alpha=cfg.alpha,
            include_hardware=cfg.include_hardware_features,
            include_cache=cfg.include_cache_features,
            include_health=cfg.include_health_features)
        q = dqn.q_values(self.agent.params,
                         np.asarray(s, np.float32)[None])[0]
        out["q"] = [float(x) for x in q]
        sel = q.astype(np.float64).copy()
        squash = cfg.q_squash if w_sel else 0.0
        if squash > 0:
            masked = np.where(mask, sel, -np.inf)
            ref = float(masked.max()) if np.isfinite(masked).any() else 0.0
            sel = squash * np.tanh(sel - ref)
        if w_sel:
            prior = w_sel * bonus
            out["prior"] = [float(x) for x in prior]
            sel = sel + prior
        sel[~mask] = -np.inf
        out["sel"] = [float(x) for x in sel]
        return out


class LegacyPolicyAdapter:
    """Wrap a ``core.policies`` heuristic (oracle decode lengths) into
    the gateway protocol -- for baseline comparisons only."""

    def __init__(self, policy):
        self.policy = policy
        self.name = f"legacy:{policy.name}"

    def route(self, cluster, req, d_hat: int) -> Optional[int]:
        return self.policy.act(cluster)


def restore_rl_policy(router_cfg: rl.RouterConfig, checkpoint_dir: str,
                      m: Optional[int] = None, device="cuda") -> RLPolicy:
    """Rebuild the agent for an m-wide action space on ``device`` and
    restore its weights from a ``training.checkpoint`` directory (the
    artifact ``ManagedCluster.save_router`` / the trainers write, in the
    reference's tree layout, so the reference's checkpoints restore
    too)."""
    from repro_torch.training.checkpoint import CheckpointManager
    agent = rl.make_agent(router_cfg, m=m, device=device)
    mgr = CheckpointManager(checkpoint_dir)
    try:
        out = mgr.restore(agent.state_dict())
    finally:
        mgr.close()
    if out is None:
        raise FileNotFoundError(
            f"no router checkpoint under {checkpoint_dir}")
    agent.load_state_dict(out[0])
    return RLPolicy(agent, router_cfg)


def make_gateway_policy(name: str, router_cfg: Optional[rl.RouterConfig]
                        = None, agent=None, profile=None,
                        checkpoint_dir: Optional[str] = None,
                        m: Optional[int] = None):
    """Policy factory: ``rr`` | ``jsq`` | ``mixing`` | ``mixing+cache``
    | ``sticky`` | ``rl`` (needs an ``agent`` or ``checkpoint_dir``),
    or any ``core.policies`` name (oracle-length legacy baselines,
    adapter-wrapped)."""
    cfg = router_cfg or rl.RouterConfig()
    if name in ("rr", "round_robin"):
        return RoundRobinPolicy()
    if name == "jsq":
        return LeastOutstandingWork()
    if name == "sticky":
        return PrefixAffinityPolicy()
    if name == "mixing+cache":
        return MixingImpactPolicy(
            alpha=cfg.alpha, defer_prior_bias=cfg.defer_prior_bias,
            cache_weight=cfg.cache_weight or 0.5)
    if name == "mixing":
        return MixingImpactPolicy(alpha=cfg.alpha,
                                  defer_prior_bias=cfg.defer_prior_bias)
    if name == "rl":
        if agent is not None:
            return RLPolicy(agent, cfg)
        if checkpoint_dir is not None:
            return restore_rl_policy(cfg, checkpoint_dir, m=m)
        raise ValueError("policy 'rl' needs agent= or checkpoint_dir=")
    return LegacyPolicyAdapter(legacy.make_policy(name, profile))
