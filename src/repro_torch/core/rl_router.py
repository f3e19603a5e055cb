"""The intelligent router: heuristic-guided RL (paper §5.3, §6).

Three variants (paper §6 Setup):
  baseline  -- reward = backlog penalty + completion reward (terms 1+2 of
               Eq. 3)
  aware     -- baseline + r_mixing(chosen) added directly to the reward
               ("workload-augmented", fixed weight 1)
  guided    -- heuristic-guided (Cheng et al. 2021): reward +=
               w_k * h(s_t, a) with h = r_mixing(chosen) - max_l r_mixing(l)
               <= 0, w_k = gamma * exp(-beta_d * k) decaying per episode;
               the training discount is gamma_k = gamma - w_k (short horizon
               + strong guidance early; original MDP recovered as k grows).

Sign note: Eq. 3 prints "- (gamma - gamma_k) h"; with the paper's h <= 0
that would *reward* bad placements, contradicting §5.3's own description
("h returns zero when the request is assigned to the model with the least
workload mixing impact" -- i.e. zero is the best case).  We implement the
evidently intended penalty  + w_k * h.

This is the serving half of the port's router: the configuration, the
r_mixing scoring and guidance prior every gateway policy reads, and the
agent factory.  The training half (``BacklogTracker``, ``RoutingEnv``,
``NStepAssembler``, ``train``, ``evaluate``) comes with the training
slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core import impact, prefix_cache, state as state_lib
from repro_torch.core.dqn import DQNAgent, DQNConfig
from repro_torch.serving.request import Request


@dataclass
class RouterConfig:
    """The reference's ``RouterConfig``, cut to the fields its serving
    path reads (policies, featurizer, agent factory, guidance weight);
    the defaults are the reference's.  The training fields (rewards,
    exploration, n-step targets, optimizer) come with the training
    slice of the port."""
    variant: str = "guided"          # baseline | aware | guided
    n_instances: int = 4
    gamma: float = 0.997             # ~7 s credit horizon at dt=0.02
    alpha: float = 0.5               # Eq.(1)/(2) balance (§6 Setup)
    beta_d: float = 0.5              # guidance decay (§6 Setup)
    n_buckets: int = 8
    hidden: tuple = (64, 64)
    include_impact_features: bool = True
    # per-instance hardware block (grad1/grad2/kv-capacity) in the
    # state: lets one agent trained across calibrated + synthetic
    # profiles condition on the hardware itself.  Off by default:
    # existing checkpoints keep their state shape.
    include_hardware_features: bool = False
    # prefix-cache model (core.prefix_cache): with
    # ``include_cache_features`` the head request's prospective
    # per-instance hit fraction joins the state (CACHE_DIMS extra dims
    # per instance); ``cache_weight`` adds the same affinity signal
    # directly to mixing_scores so the guided variant's heuristic prior
    # is cache-aware too.
    include_cache_features: bool = False
    cache_weight: float = 0.0
    # gateway health block (serving.chaos.HealthTracker): per-instance
    # degradation score + straggler slowdown join the state so the agent
    # can route around degraded nodes before the breaker trips.  Off by
    # default: existing checkpoints keep their state shape.
    include_health_features: bool = False
    q_squash: float = 0.05       # bound on Q's selection influence (guided)
    q_arch: str = "mlp"              # "mlp" (paper) | "decomposed" (ours)
    # decision-time guidance floor: actions are selected from
    # Q(s,a) + floor * r_mixing-advantage(a).  With a pure annealed DQN
    # the argmax is dominated by Q noise and collapses to
    # defer-everything / one-instance policies; a strong persistent
    # prior keeps the workload heuristic in charge where Q differences
    # are small and lets the learned values override it where they are
    # confident -- worst case is impact-greedy parity.
    guidance_floor: float = 1.0
    defer_prior_bias: float = -0.05  # slight routing preference in the prior
    seed: int = 0


#: mixing-score penalty for an instance the gateway's circuit breaker
#: has opened on -- large enough to lose every argmax against a healthy
#: candidate, finite so a fully-breakered fleet still routes somewhere
HEALTH_PENALTY = 0.75


def mixing_scores(cluster, req: Request, d_hat: int,
                  alpha: float = 0.5,
                  cache_weight: float = 0.0) -> np.ndarray:
    """Per-instance r_mixing for routing ``req`` onto ``cluster`` now
    (each instance judged by its own profile; failed instances -inf).
    Shared by the RL env, the cluster manager, and the gateway's
    policy layer -- one implementation of the paper's Eq. 1-2 scoring.
    ``cache_weight`` adds the request's prospective prefix-cache hit
    fraction per instance (core.prefix_cache), making the heuristic
    cache-affine; the fractions come from the same shared scalar query
    on both backends, so scores stay bit-identical py-vs-vec."""
    sums = [inst.resident_token_sum() + inst.queued_prompt_sum()
            for inst in cluster.instances]
    scores = impact.mixing_heterogeneous(
        [inst.profile for inst in cluster.instances],
        req.prompt_tokens, d_hat, sums, alpha)
    for i, inst in enumerate(cluster.instances):
        if inst.failed:
            scores[i] = -np.inf
    if cache_weight:
        # failed lanes stay -inf (-inf + finite == -inf)
        scores = scores + cache_weight * np.asarray(
            prefix_cache.hit_fractions(cluster, req))
    hm = getattr(cluster, "health_mask", None)
    if hm is not None:
        # breakered-but-alive instances get a finite penalty (identical
        # np ops on both backends, so scores stay bit-exact py-vs-vec)
        k = min(cluster.m, len(hm))
        scores[:k] = scores[:k] + np.where(
            np.asarray(hm[:k], bool), 0.0, -HEALTH_PENALTY)
    return scores


def guidance_from_scores(cluster, req: Request, d_hat: int,
                         scores: np.ndarray,
                         defer_prior_bias: float = -0.05) -> np.ndarray:
    """Per-action r_mixing advantage for ``req`` given its per-instance
    ``scores`` (route_i: scores_i - max; defer: min - max), with the
    capacity-fit correction of §5.3 goal (c): placements that would
    overflow the KV budget are penalized, and if nothing fits the defer
    action is encouraged instead."""
    out = np.zeros(cluster.m + 1, np.float32)
    need = req.prompt_tokens + d_hat
    fits = np.array([inst.free_tokens() >= need and not inst.failed
                     for inst in cluster.instances])
    scores = scores + np.where(fits, 0.0, -0.3)
    finite = scores[np.isfinite(scores)]
    top = finite.max() if finite.size else 0.0
    out[:cluster.m] = np.where(np.isfinite(scores), scores - top, -1e9)
    defer_bias = 0.2 - top if not fits.any() else defer_prior_bias
    out[cluster.m] = ((finite.min() - top) if finite.size > 1
                      else 0.0) + defer_bias
    return out


def make_agent(cfg: RouterConfig, m: Optional[int] = None,
               device="cuda") -> DQNAgent:
    """Build the DQN agent for an m-instance action space (defaults to
    cfg.n_instances; the batched runner passes its padded width m_max),
    its Q-network on ``device``."""
    m = m or cfg.n_instances
    inst_dims = state_lib.instance_dims(cfg.include_impact_features,
                                        cfg.include_hardware_features,
                                        cfg.include_cache_features,
                                        cfg.include_health_features)
    dcfg = DQNConfig(
        state_dim=state_lib.state_dim(m, cfg.include_impact_features,
                                      cfg.include_hardware_features,
                                      cfg.include_cache_features,
                                      cfg.include_health_features),
        n_actions=m + 1, hidden=cfg.hidden, q_arch=cfg.q_arch,
        inst_dims=inst_dims, router_dims=state_lib.ROUTER_DIMS)
    return DQNAgent(dcfg, seed=cfg.seed, device=device)


def guidance_weight(cfg: RouterConfig, episode: int) -> float:
    if cfg.variant != "guided":
        return 0.0
    return cfg.gamma * float(np.exp(-cfg.beta_d * episode))
