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

This is the port of the router: the configuration, the r_mixing
scoring and guidance prior every gateway policy reads, the agent
factory, and the training half (``BacklogTracker``, ``RoutingEnv``,
``NStepAssembler``, ``train``, ``evaluate``) over the ``py`` and
``vec`` simulators, and the multi-episode ``vec`` pools the batched
trainer (``core.batched_rl``) packs episodes into.
"""
from __future__ import annotations

import copy
import warnings
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.core import impact, prefix_cache, state as state_lib
from repro_torch.core.dqn import DQNAgent, DQNConfig
from repro_torch.core.profiles import HardwareProfile
from repro_torch.core.simulator import Cluster
from repro_torch.serving.request import Request, summarize


@dataclass
class RouterConfig:
    variant: str = "guided"          # baseline | aware | guided
    n_instances: int = 4
    dt: float = 0.02
    gamma: float = 0.997             # ~7 s credit horizon at dt=0.02
    r_w: float = 60.0                # completion reward (§A.9.3)
    alpha: float = 0.5               # Eq.(1)/(2) balance (§6 Setup)
    beta_d: float = 0.5              # guidance decay (§6 Setup)
    scheduler: str = "fcfs"
    chunked_prefill: int = 0
    n_buckets: int = 8
    actions_per_tick: int = 1
    learn_every: int = 4
    eps_start: float = 1.0
    eps_end: float = 0.05
    explore_episodes: int = 20       # §A.9.2: no exploration after ep 20
    n_slots: Optional[int] = None
    max_time: float = 36_000.0
    hidden: tuple = (64, 64)
    lr: float = 3e-4
    include_impact_features: bool = True
    # per-instance hardware block (grad1/grad2/kv-capacity) in the
    # state: lets one agent trained across calibrated +
    # synthetic profiles condition on the hardware itself instead of
    # inferring speed from load dynamics.  Off by default: existing
    # checkpoints keep their state shape.
    include_hardware_features: bool = False
    # prefix-cache model (core.prefix_cache): per-instance KV budget
    # for cached prompt prefixes (0 disables the cache model).  With
    # ``include_cache_features`` the head request's prospective
    # per-instance hit fraction joins the state (CACHE_DIMS extra dims
    # per instance -- existing checkpoints keep their shape while it is
    # off); ``cache_weight`` adds the same affinity signal directly to
    # mixing_scores so the guided variant's heuristic prior is
    # cache-aware too.
    include_cache_features: bool = False
    prefix_cache_tokens: int = 0
    prefix_block: int = 32
    cache_weight: float = 0.0
    # gateway health block (serving.chaos.HealthTracker): per-instance
    # degradation score + straggler slowdown join the state so the agent
    # can route around degraded nodes before the breaker trips.  Off by
    # default: existing checkpoints keep their state shape.
    include_health_features: bool = False
    reward_scale: float = 300.0
    q_squash: float = 0.05       # bound on Q's selection influence (guided)
    q_arch: str = "mlp"              # "mlp" (paper) | "decomposed" (ours)
    # SLA safety valve: if the head request has waited this long at the
    # router, a defer action is overridden with the best-impact placement
    # (a production watchdog; also bounds episode length against
    # defer-forever policies).  Each rescue costs sla_penalty so the agent
    # cannot lean on the watchdog.
    defer_timeout: float = 5.0
    sla_penalty: float = 10.0
    # NOTE: potential-based shaping was tried and REFUTED here: with every
    # episode completing all requests, the telescoped backlog sum is
    # policy-independent and the learning signal vanished.  The raw
    # Eq.(3) backlog integral is the latency signal; reward centering
    # handles its magnitude.
    potential_shaping: bool = False
    r_w_shaped: float = 1.0          # completion bonus under shaping
    # decision-time guidance floor: actions are selected from
    # Q(s,a) + floor * r_mixing-advantage(a).  The paper anneals guidance
    # to exactly zero; with a pure annealed DQN the argmax is dominated
    # by Q noise and collapses to defer-everything / one-instance
    # policies.
    # A strong persistent prior keeps the workload heuristic in charge
    # where Q differences are small and lets the learned values override
    # it where they are confident -- worst case is impact-greedy parity.
    guidance_floor: float = 1.0
    defer_prior_bias: float = -0.05  # slight routing preference in the prior
    # n-step truncated-return targets (no bootstrapping): Q regresses the
    # discounted return over the next `nstep` decisions.  Bootstrapped
    # 1-step DQN (nstep=0, the paper's setup) proved unstable on this MDP
    # (tiny action advantages under a huge action-independent backlog
    # term); truncated Monte-Carlo targets are plain supervised regression
    # and capture placement effects, which materialize within seconds.
    nstep: int = 80
    nstep_gamma: float = 0.97
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
    if getattr(cluster, "is_vec", False):
        # vecsim backend: Eq. 1-2 evaluated in one vector pass over the
        # packed lane arrays (bit-identical to the scalar loop)
        pool, lanes = cluster.pool, cluster.lane_ids
        scores = impact.mixing_vec(
            pool.grad1[lanes], pool.grad2[lanes], pool.eps_lat[lanes],
            float(req.prompt_tokens), d_hat,
            pool.rts[lanes] + pool.qps[lanes], alpha)
        scores[pool.failed[lanes]] = -np.inf
    else:
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
    if getattr(cluster, "is_vec", False):
        pool, lanes = cluster.pool, cluster.lane_ids
        fits = ((pool.cap[lanes] - pool.rts[lanes] - pool.qps[lanes]
                 >= need) & ~pool.failed[lanes])
    else:
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


class BacklogTracker:
    """Incremental Eq.(3) backlog-penalty accumulators over one cluster.

    The penalty is ``-sum_unfinished (1 - frac_r) / t_hat_r`` with
    d-hat/t-hat fixed per request; instead of rescanning every arrived
    request every 0.02 s tick (which dominated episode wall time), we
    maintain S = sum 1/t_hat and T = sum frac/t_hat via arrival /
    decode / preempt / finish events and read ``penalty() = T - S`` in
    O(1).  On the Python stepper the decode/preempt events come from
    SimInstance hooks (installed here); the vec backend maintains the
    same accumulators inside its fused round loop
    (``pool.set_backlog_terms``).  Shared by RoutingEnv and the online
    gateway trainer (training.online) so both compute identical
    reward streams over identical event streams."""

    def __init__(self, cluster, profile, predict_decode):
        self.cluster = cluster
        self.profile = profile
        self.predict_decode = predict_decode
        self.vec = getattr(cluster, "is_vec", False)
        self.S = 0.0
        self.T = 0.0
        self.inv: Dict[int, tuple] = {}      # rid -> (1/d_hat, 1/t_hat)
        if not self.vec:
            for inst in cluster.instances:
                inst.on_token = self.on_token
                inst.on_preempt = self.on_preempt

    def register(self, r) -> None:
        """Account one request that entered the router queue."""
        d_hat = max(self.predict_decode(r), 1)
        inv_t = 1.0 / max(
            self.profile.request_time(r.prompt_tokens, d_hat), 1e-3)
        if self.vec:
            self.cluster.pool.set_backlog_terms(
                self.cluster.gid_of(r), self.cluster.ep, d_hat, inv_t)
        else:
            self.inv[r.rid] = (1.0 / d_hat, inv_t)
            self.S += inv_t

    def on_token(self, r):
        iv = self.inv.get(r.rid)
        if iv is None:
            return
        f0 = (r.decoded - 1) * iv[0]
        if f0 >= 1.0:                 # progress already capped at 1
            return
        self.T += (min(r.decoded * iv[0], 1.0) - f0) * iv[1]

    def on_preempt(self, r):
        # called BEFORE reset_progress: r still holds its progress
        iv = self.inv.get(r.rid)
        if iv is not None and r.decoded:
            self.T -= min(r.decoded * iv[0], 1.0) * iv[1]

    def note_finished(self, done_now):
        if self.vec:
            return            # the pool settles S/T at completion time
        for r in done_now:
            iv = self.inv.pop(r.rid, None)
            if iv is not None:
                self.S -= iv[1]
                self.T -= min(r.decoded * iv[0], 1.0) * iv[1]

    def penalty(self) -> float:
        if self.vec:
            pool = self.cluster.pool
            ep = self.cluster.ep
            return float(pool.bk_t[ep] - pool.bk_s[ep])
        return self.T - self.S


class RoutingEnv:
    """One router action per dt tick (the paper's 0.02 s cadence).

    ``profile`` may be one HardwareProfile (homogeneous, cfg.n_instances
    wide -- the paper's setup) or a sequence of per-instance profiles
    (heterogeneous cluster; its length overrides cfg.n_instances).

    ``backend`` names any ``core.backends`` registry backend:
    ``"vec"`` steps the episode on the vectorized structure-of-arrays
    simulator (`core.vecsim`), ``"jax"`` on the device-resident pool,
    whose round loop is one kernel launch a call (`core.jaxsim`).  Passing a shared ``pool`` +
    ``pool_ep`` instead packs this episode into a multi-episode pool
    so the batched trainer advances all its episodes in fused rounds.
    ``sim_backend=`` is the deprecated pre-registry alias of
    ``backend=``."""

    def __init__(self, cfg: RouterConfig, profile,
                 predict_decode: Optional[Callable] = None,
                 backend: Optional[str] = None,
                 sim_backend: Optional[str] = None,
                 pool=None, pool_ep: int = 0):
        self.cfg = cfg
        if isinstance(profile, HardwareProfile):
            self.profiles = (profile,) * cfg.n_instances
        else:
            self.profiles = tuple(profile)
        self.profile = self.profiles[0]     # router-level reference
        self.m = len(self.profiles)
        if sim_backend is not None:
            warnings.warn(
                "RoutingEnv(sim_backend=...) is deprecated; use "
                "backend=... — backends now resolve through the "
                "core.backends registry", DeprecationWarning,
                stacklevel=2)
            backend = backend or sim_backend
        backend = backend or "py"
        self.sim_backend = "vec" if pool is not None else backend
        self._pool = pool
        self._pool_ep = pool_ep
        # d-hat: estimated decode tokens for a request (predictor hook;
        # oracle fallback)
        self.predict_decode = predict_decode or (
            lambda r: r.decode_tokens)

    def reset(self, requests: Sequence[Request]):
        c = self.cfg
        if self._pool is not None:
            from repro_torch.core.vecsim import VecCluster
            self.cluster = VecCluster(
                self.profiles, self.m, c.scheduler, c.dt,
                c.chunked_prefill, c.n_slots, pool=self._pool,
                ep=self._pool_ep,
                prefix_cache_tokens=c.prefix_cache_tokens,
                prefix_block=c.prefix_block)
        else:
            self.cluster = Cluster(
                self.profiles, self.m, c.scheduler, c.dt,
                c.chunked_prefill, c.n_slots,
                backend=self.sim_backend,
                prefix_cache_tokens=c.prefix_cache_tokens,
                prefix_block=c.prefix_block)
        self._vec = getattr(self.cluster, "is_vec", False)
        self.pending = sorted(requests, key=lambda r: r.arrival)
        self.n_total = len(self.pending)
        # Incremental backlog penalty (Eq. 3 term 1): see BacklogTracker.
        self._bk = BacklogTracker(self.cluster, self.profile,
                                  self.predict_decode)
        self._score_cache = None
        self._i = 0
        self._deliver()
        return self._state()

    def _deliver(self):
        while (self._i < self.n_total
               and self.pending[self._i].arrival <= self.cluster.t):
            r = self.pending[self._i]
            self.cluster.enqueue(r)
            self._bk.register(r)
            self._i += 1

    def _note_finished(self, done_now):
        self._bk.note_finished(done_now)

    def _state(self) -> np.ndarray:
        return state_lib.featurize(
            self.cluster, self.profile, n_buckets=self.cfg.n_buckets,
            include_impact=self.cfg.include_impact_features,
            predict_decode=self.predict_decode, alpha=self.cfg.alpha,
            include_hardware=self.cfg.include_hardware_features,
            include_cache=self.cfg.include_cache_features,
            include_health=self.cfg.include_health_features)

    def mask(self) -> np.ndarray:
        return state_lib.action_mask(self.cluster)

    def _scores(self, req) -> np.ndarray:
        """Per-instance r_mixing for routing ``req`` now (each instance
        judged by its own profile; failed instances -inf).  Cached per
        (request, tick): act-time guidance and the step() reward both need
        the same scores and the cluster cannot change in between."""
        cluster = self.cluster
        key = (req.rid, cluster.t)
        if self._score_cache is not None and self._score_cache[0] == key:
            return self._score_cache[1]
        d_hat = max(self.predict_decode(req), 1)
        scores = mixing_scores(cluster, req, d_hat, self.cfg.alpha,
                               cache_weight=self.cfg.cache_weight)
        self._score_cache = (key, scores)
        return scores

    def guidance_bonus(self) -> np.ndarray:
        """Per-action r_mixing advantage for the current head request
        (route_i: scores_i - max; defer: min - max), zeros if no request."""
        cluster = self.cluster
        if not cluster.central:
            return np.zeros(cluster.m + 1, np.float32)
        req = cluster.central[0]
        d_hat = max(self.predict_decode(req), 1)
        return guidance_from_scores(cluster, req, d_hat,
                                    self._scores(req),
                                    self.cfg.defer_prior_bias)

    def _backlog_penalty(self) -> float:
        return self._bk.penalty()

    def _apply_action(self, action: int, guide_w: float = 0.0) -> float:
        """Apply one routing decision (SLA watchdog included); returns
        the immediate mixing-term reward.  Factored out of step() so
        the batched trainer's fused multi-episode stepping can apply
        all episodes' actions before one fused advance."""
        c = self.cfg
        cluster = self.cluster
        mix_term = 0.0
        scores = None
        if cluster.central:
            scores = self._scores(cluster.central[0])
        if (action >= cluster.m and scores is not None
                and cluster.t - cluster.central[0].arrival
                > c.defer_timeout):
            # SLA watchdog: force the best-impact placement, at a price
            action = int(np.argmax(scores))
            mix_term -= c.sla_penalty
        if action < cluster.m and cluster.central:
            if c.variant == "aware":
                mix_term += float(scores[action])
            elif c.variant == "guided":
                mix_term += guide_w * float(scores[action] - scores.max())
            cluster.route(action)
        elif scores is not None and c.variant == "guided":
            # deferring forfeits the currently-best placement; under the
            # guiding heuristic ("route to argmax r_mixing now") that costs
            # the quality spread it gives up.  (Strategic delay can still
            # be learned once the guidance anneals away.)
            finite = scores[np.isfinite(scores)]
            if finite.size > 1:
                mix_term += guide_w * float(finite.min() - finite.max())
        return mix_term

    def _after_tick(self, done_now) -> tuple:
        """Per-tick bookkeeping after a cluster advance: -> (reward
        delta, done flag).  Shared by step() and the fused stepping."""
        c = self.cfg
        self._note_finished(done_now)
        self._deliver()
        if not c.potential_shaping:
            delta = (self._backlog_penalty() * c.dt
                     + c.r_w * len(done_now))
        else:
            delta = c.r_w_shaped * len(done_now)
        done = (len(self.cluster.completed) >= self.n_total
                or self.cluster.t > c.max_time)
        return delta, done

    def _span_bounds(self, cap: int = 256) -> list:
        """Tick boundaries (sequential ``t += dt``, bit-matching the
        per-tick stepper) from now until the next arrival, past
        ``max_time``, or ``cap`` ticks -- the window the fused batched
        stepper may advance in one shot: no arrivals can land inside
        it, so no decision point can be crossed.  A non-empty router
        queue is already a decision point after one tick (the per-tick
        stepper re-decides immediately on a deferred head), so the
        span is a single tick then."""
        c = self.cfg
        t = self.cluster.t
        if self.cluster.central:
            return [t + c.dt]
        na = (self.pending[self._i].arrival
              if self._i < self.n_total else None)
        bounds = []
        while len(bounds) < cap:
            t = t + c.dt
            bounds.append(t)
            if (na is not None and t >= na) or t > c.max_time:
                break
        return bounds

    def _after_span(self, done_now, bk_reward: float) -> tuple:
        """Span-level bookkeeping: -> (reward delta, done flag).
        ``bk_reward`` is the pool-reconstructed per-tick backlog
        integral over the span (zero-length contribution under
        potential shaping, which rewards completions only)."""
        c = self.cfg
        pool, ep = self.cluster.pool, self.cluster.ep
        s_before = float(pool.bk_s[ep])
        self._deliver()
        if not c.potential_shaping:
            # the per-tick stepper samples the backlog AFTER the
            # arrival tick's deliveries; fold the new arrivals' S into
            # the span's final sample
            delta_s = float(pool.bk_s[ep]) - s_before
            delta = (bk_reward - delta_s * c.dt
                     + c.r_w * len(done_now))
        else:
            delta = c.r_w_shaped * len(done_now)
        done = (len(self.cluster.completed) >= self.n_total
                or self.cluster.t > c.max_time)
        return delta, done

    def step(self, action: int, guide_w: float = 0.0):
        """One DECISION: apply the action, then advance dt ticks until the
        next decision point (non-empty router queue) or episode end,
        accumulating the Eq.(3) reward.  Ticks with an empty queue have no
        choice to make (forced defer), so they are not decision states --
        this keeps the replay buffer full of actual decisions while
        preserving the paper's 0.02 s simulation cadence."""
        c = self.cfg
        cluster = self.cluster
        reward = self._apply_action(action, guide_w)
        completed = 0
        phi_before = self._backlog_penalty()
        while True:
            done_now = cluster.advance()
            delta, done = self._after_tick(done_now)
            completed += len(done_now)
            reward += delta
            if done or cluster.central:
                break
        if c.potential_shaping:
            # potential-based shaping on the backlog level: the raw Eq.(3)
            # backlog integral has a huge action-independent component that
            # drowns action advantages in the TD signal; telescoping the
            # potential keeps the optimal policy (Ng et al. 1999) while the
            # per-step reward tracks backlog CHANGES.
            phi_after = self._backlog_penalty()
            reward += (c.gamma * phi_after - phi_before)
        return self._state(), reward, done, {"completed": completed}


def make_agent(cfg: RouterConfig, m: Optional[int] = None,
               device="cuda") -> DQNAgent:
    """Build the DQN agent for an m-instance action space (defaults to
    cfg.n_instances; the batched runner passes its padded width m_max),
    its networks on ``device``."""
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
        n_actions=m + 1, hidden=cfg.hidden,
        gamma=cfg.gamma, lr=cfg.lr, q_arch=cfg.q_arch,
        inst_dims=inst_dims, router_dims=state_lib.ROUTER_DIMS,
        center_rewards=not cfg.potential_shaping)
    return DQNAgent(dcfg, seed=cfg.seed, device=device)


def guidance_weight(cfg: RouterConfig, episode: int) -> float:
    if cfg.variant != "guided":
        return 0.0
    return cfg.gamma * float(np.exp(-cfg.beta_d * episode))


class NStepAssembler:
    """Truncated n-step Monte-Carlo return assembly (RouterConfig.nstep):
    every decision's span reward is appended to all open windows, and a
    window that has collected ``nstep`` rewards matures into a training
    tuple (s0, a0, discounted return).  Shared by the offline ``train``
    loop and the online gateway trainer so both emit identical targets
    for identical decision/reward streams."""

    def __init__(self, nstep: int, gamma: float):
        self.nstep = nstep
        self.g = gamma
        self.window: deque = deque()

    def add(self, s, a: int, r: float):
        """Record one decision + its span reward; returns the (0 or 1)
        matured (s0, a0, ret) tuples this decision flushed."""
        for _, _, rs in self.window:
            rs.append(r)
        self.window.append((s, a, [r]))
        if len(self.window) > self.nstep:
            return (self._pop(),)
        return ()

    def _pop(self):
        s0, a0, rs = self.window.popleft()
        ret = 0.0
        for i, ri in enumerate(rs):
            ret += (self.g ** i) * ri
        return s0, a0, ret

    def drain(self):
        """Flush every open window (episode / stream end)."""
        while self.window:
            yield self._pop()


def train(cfg: RouterConfig, profile: HardwareProfile,
          workload_fn: Callable[[int], Sequence[Request]],
          n_episodes: int, agent: Optional[DQNAgent] = None,
          predict_decode: Optional[Callable] = None,
          valid_fn: Optional[Callable[[], Sequence[Request]]] = None,
          verbose: bool = False, device="cuda") -> Dict:
    """Train the RL router; returns {agent, history}.  Without an
    ``agent`` a fresh one is built on ``device``.

    valid_fn: workload for periodic GREEDY validation; the best-validating
    snapshot is restored at the end (protects against the well-known
    late-training DQN collapse when epsilon hits zero)."""
    agent = agent or make_agent(cfg, device=device)
    env = RoutingEnv(cfg, profile, predict_decode)
    history = []
    best = None
    for ep in range(n_episodes):
        requests = workload_fn(ep)
        s = env.reset(requests)
        w_k = guidance_weight(cfg, ep)
        # training discount: gamma_k = gamma - w_k (guided); else gamma
        gamma_k = cfg.gamma - w_k if cfg.variant == "guided" else cfg.gamma
        frac = min(ep / max(cfg.explore_episodes, 1), 1.0)
        eps = cfg.eps_start + (cfg.eps_end - cfg.eps_start) * frac
        if ep >= cfg.explore_episodes:
            eps = 0.0               # §A.9.2: exploit after episode 20
        # per-episode discount (heuristic-guided horizon shortening).
        # With n-step Monte-Carlo targets (nstep>0, observe() passes
        # done=1) gamma never enters the TD target, so it is only
        # applied in bootstrapped (nstep=0) mode, as in the reference.
        if cfg.nstep == 0 and agent.cfg.gamma != gamma_k:
            agent.cfg = replace(agent.cfg, gamma=round(gamma_k, 3))
        w_sel = max(w_k, cfg.guidance_floor) \
            if cfg.variant == "guided" else 0.0
        scale = 1.0 if cfg.potential_shaping else cfg.reward_scale
        ep_reward, ticks, done = 0.0, 0, False
        asm = NStepAssembler(cfg.nstep, cfg.nstep_gamma)
        while not done:
            mask = env.mask()
            prior = w_sel * env.guidance_bonus() if w_sel else None
            a = agent.act(s, mask, epsilon=eps, prior=prior,
                          q_squash=cfg.q_squash if w_sel else 0.0)
            s2, r, done, _ = env.step(a, guide_w=w_k)
            if cfg.nstep > 0:
                # NOTE: matured windows bootstrap on the PRE-step state +
                # post-step mask; both are dead values under done=1.0 MC
                # targets (kept for byte-stable replay rows).
                for s0, a0, ret in asm.add(s, a, r / scale):
                    agent.observe(s0, a0, ret, s, 1.0, env.mask())
            else:
                agent.observe(s, a, r / scale, s2, float(done), env.mask())
            if ticks % cfg.learn_every == 0:
                agent.learn()
            s = s2
            ep_reward += r
            ticks += 1
        for s0, a0, ret in asm.drain():
            agent.observe(s0, a0, ret, s, 1.0, env.mask())
        stats = summarize(requests)
        stats.update({"episode": ep, "reward": ep_reward, "ticks": ticks,
                      "epsilon": eps, "guide_w": w_k})
        # greedy-validation snapshot selection
        if valid_fn is not None and eps <= 0.6:
            v = evaluate(cfg, profile, agent, valid_fn(),
                         predict_decode)
            stats["valid_e2e"] = v["e2e_mean"]
            if best is None or v["e2e_mean"] < best[0]:
                # a clone: the live network keeps learning in place
                best = (v["e2e_mean"], copy.deepcopy(agent.params))
        history.append(stats)
        if verbose:
            print(f"ep {ep:3d} eps={eps:.2f} w_k={w_k:.3f} "
                  f"reward={ep_reward:10.1f} e2e={stats['e2e_mean']:.2f}"
                  + (f" valid={stats['valid_e2e']:.2f}"
                     if "valid_e2e" in stats else ""))
    if best is not None:
        agent.params = best[1]
        agent.target = copy.deepcopy(best[1])
    return {"agent": agent, "history": history}


def evaluate(cfg: RouterConfig, profile: HardwareProfile, agent: DQNAgent,
             requests: Sequence[Request],
             predict_decode: Optional[Callable] = None,
             backend: str = "py") -> Dict:
    """Greedy (epsilon=0, no learning) episode on any registry
    ``backend``; the request stats plus spikes and the router wait."""
    env = RoutingEnv(cfg, profile, predict_decode, backend=backend)
    s = env.reset(requests)
    done = False
    w_sel = cfg.guidance_floor if cfg.variant == "guided" else 0.0
    while not done:
        prior = w_sel * env.guidance_bonus() if w_sel else None
        a = agent.act(s, env.mask(), epsilon=0.0, prior=prior,
                      q_squash=cfg.q_squash if w_sel else 0.0)
        s, _, done, _ = env.step(a)
    if getattr(env.cluster, "is_vec", False):
        env.cluster.sync_all()       # in-flight requests on truncation
    stats = summarize(requests)
    stats["spikes"] = sum(len(i.spikes) for i in env.cluster.instances)
    stats["router_wait_mean"] = float(np.mean(
        [r.routed_at - r.arrival for r in requests
         if r.routed_at is not None])) if requests else 0.0
    return stats
