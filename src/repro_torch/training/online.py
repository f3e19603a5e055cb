"""Online continual learning in the live gateway (Lodestar-style): the
port of ``repro.training.online`` with both Q-networks in torch on the
learner's device.

The offline trainers freeze a Q-head behind ``RLPolicy``; production
traffic drifts (diurnal mix shifts, tenant churn, instances failing and
recovering), exactly the regime where a frozen head degrades while the
heuristics stay merely mediocre.  ``OnlineTrainer`` closes the loop on
the gateway's OWN serving stream:

  * every routing decision is recorded with the same state/action/
    reward semantics as ``RoutingEnv`` (Eq. 3 backlog integral via the
    shared ``BacklogTracker``, completion bonus, SLA-watchdog penalty),
    assembled into truncated n-step Monte-Carlo returns by the shared
    ``NStepAssembler``, and bulk-inserted into the learner's
    ``ReplayBuffer`` through the packed ``add_rows`` path;
  * learner steps are dispatched without a read-back
    (``learn(sync=False)``, as ``batched_rl`` does) between arrival
    windows; on the card they run while the host ticks the gateway (no
    thread is started);
  * refreshed weights are published to the SERVING agent at a bounded
    cadence via ``RLPolicy.hot_swap`` -- one atomic reference store of
    a SNAPSHOT (a copy of the learner's network on its device: the
    learner updates its own network in place, so handing it over would
    let every later learn step change the served Q-head), so admission
    never pauses and readers never see a torn network;
  * guided epsilon-exploration samples from a softmax over the
    r_mixing guidance bonus (never uniformly over bad placements);
  * a SAFE FALLBACK guardrail watches the Q-head's windowed divergence
    from the r_mixing yardstick and the windowed SLO attainment: past
    either threshold the gateway routes by the guidance argmax (the
    exact ``MixingImpactPolicy`` decision rule) for a cooldown while
    learning continues on the recorded stream -- worst case is
    impact-heuristic parity, never an unhinged Q-head.

With ``learn=False``, ``eps=0`` and the guardrail off, the decision
path is identical to a frozen ``RLPolicy`` (pinned by
tests/test_online.py and tests/test_torch_online.py), so the recorder
can shadow any frozen deployment at zero behavioral cost.
"""
from __future__ import annotations

import copy
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core import rl_router as rl
from repro_torch.core import state as state_lib
from repro_torch.core.dqn import DQNAgent
from repro_torch.core.rl_router import BacklogTracker, NStepAssembler
from repro_torch.serving.policies import RLPolicy


@dataclass
class OnlineConfig:
    # -- learning loop --------------------------------------------------
    learn: bool = True              # False = pure shadow recorder
    learn_every: int = 4            # ticks between async learner steps
    publish_every: int = 25         # ticks between weight publishes
    flush_rows: int = 64            # pack-buffer size forcing add_rows
    # guided exploration: with prob eps a decision is sampled from a
    # softmax over the r_mixing guidance bonus (temperature
    # explore_temp) instead of the greedy Q pick
    eps: float = 0.05
    explore_temp: float = 0.05
    # reward-side guidance weight (RoutingEnv's guide_w).  0 by
    # default: continual adaptation must come from the latency signal,
    # not from agreeing with a heuristic that may be wrong under drift.
    guide_w: float = 0.0
    # -- safe-fallback guardrail ---------------------------------------
    guard: bool = True
    guard_window: int = 48          # decisions in the regret window
    guard_regret: float = 0.12      # mean r_mixing regret tripping it
    guard_slo: float = 0.0          # SLO attainment floor (0 = off)
    guard_min_slo_n: int = 24       # completions before SLO judging
    guard_cooldown: float = 20.0    # seconds routed by r_mixing per trip
    # -- persistence ----------------------------------------------------
    warm_start: Optional[str] = None   # checkpoint dir (full or params)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0       # learner steps between saves (0=off)
    seed: int = 0


class OnlinePolicy(RLPolicy):
    """The gateway-facing shim: an ``RLPolicy`` (same serving agent,
    same ``hot_swap`` surface, same ``explain``) whose decisions and
    tick callbacks route through the trainer."""
    name = "online"

    def __init__(self, agent, router_cfg: rl.RouterConfig, trainer):
        super().__init__(agent, router_cfg)
        self.trainer = trainer

    def bind(self, gateway):
        self.trainer.bind(gateway)

    def on_pre_route(self, cluster):
        self.trainer.on_pre_route(cluster)

    def on_tick(self, cluster, done_now):
        self.trainer.on_tick(cluster, done_now)

    def on_forced(self, action: int):
        self.trainer.on_forced(action)

    def on_run_end(self):
        self.trainer.on_run_end()

    def route(self, cluster, req, d_hat: int) -> Optional[int]:
        return self.trainer.decide(cluster, req, d_hat)


class OnlineTrainer:
    """Streams the gateway's own (s, a, r, s') transitions into the
    replay buffer and keeps the served Q-head fresh.  Attach via
    ``trainer.policy`` (the gateway resolves ``bind`` / ``on_pre_route``
    / ``on_tick`` / ``on_forced`` / ``on_run_end`` by getattr).

    Without an ``agent`` a fresh learner is built on ``device``; the
    serving twin always lives on the learner's device.  With a
    ``checkpoint_dir``, the run must reach ``on_run_end`` (the gateway
    calls it) or ``close()``, which stops the checkpoint writer."""

    def __init__(self, router_cfg: rl.RouterConfig,
                 cfg: Optional[OnlineConfig] = None,
                 agent: Optional[DQNAgent] = None,
                 m: Optional[int] = None, device="cuda"):
        self.rcfg = router_cfg
        self.cfg = cfg or OnlineConfig()
        self.m = m or router_cfg.n_instances
        # the LEARNER agent: owns the replay buffer, optimizer, RNG
        self.agent = agent or rl.make_agent(router_cfg, m=self.m,
                                            device=device)
        self.warm_started_step: Optional[int] = None
        if self.cfg.warm_start:
            from repro_torch.training.checkpoint import restore_learner
            self.warm_started_step = restore_learner(self.cfg.warm_start,
                                                     self.agent)
        # the SERVING twin: decisions read only its published params;
        # it never observes or learns, so it shares the learner's
        # buffer storage instead of allocating its own
        self.serve_agent = DQNAgent(self.agent.cfg, seed=self.cfg.seed,
                                    device=self.agent.device)
        self.serve_agent.buffer = self.agent.buffer
        self.policy = OnlinePolicy(self.serve_agent, router_cfg, self)
        self._hot_swap_snapshot()
        self.rng = np.random.default_rng(self.cfg.seed)
        self.asm = NStepAssembler(router_cfg.nstep, router_cfg.nstep_gamma)
        self.scale = (1.0 if router_cfg.potential_shaping
                      else router_cfg.reward_scale)
        # transition assembly state
        self._pending: Optional[tuple] = None     # (s, a) awaiting span r
        self._span_r = 0.0
        self._rows: list = []
        self._seen: set = set()
        self._bk: Optional[BacklogTracker] = None
        self._slo_fn = None
        self.gateway = None
        self._cluster = None
        self._tick = 0
        # guardrail state
        self.mode = "rl"
        self._until = 0.0
        self._regret: deque = deque(maxlen=self.cfg.guard_window)
        self._slo: deque = deque(maxlen=self.cfg.guard_window)
        # persistence
        self._mgr = None
        self._last_ckpt = 0
        self._pub_step = -1
        # counters
        self.decisions = 0
        self.explored = 0
        self.fallback_decisions = 0
        self.fallback_entries = 0
        self.transitions = 0
        self.publishes = 0
        self.forced = 0

    # -- gateway hooks --------------------------------------------------
    def bind(self, gateway):
        cluster = gateway.cluster
        if not getattr(cluster, "is_vec", False):
            insts = getattr(cluster, "instances", ())
            if not all(hasattr(i, "on_token") for i in insts):
                raise ValueError(
                    "OnlineTrainer needs the py or vec simulator "
                    "backend (the engine adapter fires no decode/"
                    "preempt events for the backlog reward)")
        self.gateway = gateway
        self._cluster = cluster
        est = gateway.length.estimate
        self._bk = BacklogTracker(cluster, cluster.profile,
                                  lambda r: max(int(est(r)), 1))
        self._slo_fn = gateway.cfg.slo.attained
        if self.cfg.checkpoint_dir and self.cfg.checkpoint_every:
            from repro_torch.training.checkpoint import CheckpointManager
            self._mgr = CheckpointManager(self.cfg.checkpoint_dir)

    def on_pre_route(self, cluster):
        """Register every request newly enqueued this tick with the
        backlog tracker (runs after admission/retries/hedges, before
        routing -- everything new is still in ``cluster.central``).
        Re-entries (crash orphans, hedged re-dispatches) keep their
        original terms, exactly like RoutingEnv's persistent S/T
        entries."""
        seen = self._seen
        for r in cluster.central:
            if r.rid not in seen:
                seen.add(r.rid)
                self._bk.register(r)

    def on_forced(self, action: int):
        """The gateway's SLA watchdog overrode our defer: charge the
        deferring decision RoutingEnv's sla_penalty."""
        self._span_r -= self.rcfg.sla_penalty
        self.forced += 1

    def on_tick(self, cluster, done_now):
        """Per-tick reward accrual + the background learner cadence
        (between arrival windows, off the routing critical path)."""
        c = self.rcfg
        self._bk.note_finished(done_now)
        if c.potential_shaping:
            self._span_r += c.r_w_shaped * len(done_now)
        else:
            self._span_r += (self._bk.penalty() * c.dt
                             + c.r_w * len(done_now))
        if done_now and self._slo_fn is not None:
            for r in done_now:
                self._slo.append(1.0 if self._slo_fn(r) else 0.0)
        self._tick += 1
        if not self.cfg.learn:
            return
        flush_due = self._tick % self.cfg.learn_every == 0
        if self._rows and (flush_due
                           or len(self._rows) >= self.cfg.flush_rows):
            self.agent.buffer.add_rows(np.stack(self._rows))
            self._rows.clear()
        if flush_due:
            self.agent.learn(sync=False)
        if (self._tick % self.cfg.publish_every == 0
                and self.agent.steps > max(self._pub_step, 0)):
            self._publish()
        if (self._mgr is not None and self.agent.steps
                >= self._last_ckpt + self.cfg.checkpoint_every):
            self._last_ckpt = self.agent.steps
            tree, extra = self.agent.full_state()
            self._mgr.save(self.agent.steps, tree, extra)

    def on_run_end(self):
        """Stream over: close the last span, drain open n-step windows
        on the final state, flush rows, publish, checkpoint."""
        cluster = self._cluster
        s = self._featurize(cluster, self._head_dhat(cluster))
        mask = state_lib.action_mask(cluster)
        self._close_span(s, mask)
        for t in self.asm.drain():
            self._pack(t, s, mask)
        if self._rows:
            self.agent.buffer.add_rows(np.stack(self._rows))
            self._rows.clear()
        if self.cfg.learn:
            self._publish()
        if self._mgr is not None:
            tree, extra = self.agent.full_state()
            self._mgr.save(self.agent.steps, tree, extra, sync=True)
        self.close()

    def close(self):
        """Stop the checkpoint writer thread (after pending saves)."""
        if self._mgr is not None:
            self._mgr.close()
            self._mgr = None

    # -- the decision path ---------------------------------------------
    def decide(self, cluster, req, d_hat: int) -> Optional[int]:
        """One routing decision: RLPolicy-identical math (mask, scores,
        bonus, featurize, guided Q argmax), plus transition recording,
        guided exploration, and the guardrail."""
        rcfg = self.rcfg
        ccfg = self.cfg
        mask = state_lib.action_mask(cluster)
        w_sel = rcfg.guidance_floor if rcfg.variant == "guided" else 0.0
        scores = rl.mixing_scores(cluster, req, d_hat, rcfg.alpha,
                                  cache_weight=rcfg.cache_weight)
        bonus = rl.guidance_from_scores(cluster, req, d_hat, scores,
                                        rcfg.defer_prior_bias)
        decomposed = (self.serve_agent.cfg.q_arch == "decomposed"
                      or cluster.m + 1 == self.serve_agent.cfg.n_actions)
        if not decomposed:
            # fixed-m MLP on a resized cluster: guidance fallback, no
            # recording (the state no longer fits the network)
            b = np.where(mask, bonus, -np.inf)
            self.decisions += 1
            a = int(np.argmax(b))
            return a if a < cluster.m else None
        s = self._featurize(cluster, d_hat)
        self._close_span(s, mask)          # previous decision's span ends
        now = cluster.t
        if self.mode == "fallback" and now >= self._until:
            self.mode = "rl"               # cooldown over: re-probe Q
            self._regret.clear()
        if self.mode == "fallback":
            b = np.where(mask, bonus, -np.inf)
            a = int(np.argmax(b))
            self.fallback_decisions += 1
        else:
            explored = (ccfg.learn and ccfg.eps > 0
                        and self.rng.random() < ccfg.eps)
            if explored:
                a = self._sample_guided(bonus, mask)
                self.explored += 1
            else:
                prior = w_sel * bonus if w_sel else None
                a = int(self.serve_agent.act(
                    s, mask, epsilon=0.0, prior=prior,
                    q_squash=rcfg.q_squash if w_sel else 0.0))
            if ccfg.guard:
                fin = np.where(mask, bonus, -np.inf)
                gap = float(fin.max() - fin[a])
                self._regret.append(gap if np.isfinite(gap) else 0.0)
                self._check_guard(now)
        if ccfg.guide_w and a < cluster.m and np.isfinite(scores[a]):
            self._span_r += ccfg.guide_w * float(scores[a] - scores.max())
        self._pending = (s, a)
        self.decisions += 1
        return a if a < cluster.m else None

    def _sample_guided(self, bonus: np.ndarray, mask: np.ndarray) -> int:
        """Exploration draw ~ softmax(bonus / temp) over valid actions:
        biased toward good placements instead of uniform over bad
        ones."""
        valid = np.flatnonzero(mask)
        z = bonus[valid].astype(np.float64) \
            / max(self.cfg.explore_temp, 1e-6)
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(valid[self.rng.choice(len(valid), p=p)])

    def _check_guard(self, now: float):
        c = self.cfg
        trip = (len(self._regret) >= c.guard_window
                and float(np.mean(self._regret)) > c.guard_regret)
        if not trip and c.guard_slo > 0 \
                and len(self._slo) >= c.guard_min_slo_n:
            trip = float(np.mean(self._slo)) < c.guard_slo
        if trip:
            self.mode = "fallback"
            self._until = now + c.guard_cooldown
            self.fallback_entries += 1
            self._regret.clear()
            self._slo.clear()

    # -- transition assembly --------------------------------------------
    def _close_span(self, s2: np.ndarray, mask2: np.ndarray):
        """The span between the previous decision and this one is over:
        feed (s, a, span_reward) into the n-step assembler and pack any
        matured windows (``s2``/``mask2`` are the dead done=1.0
        bootstrap columns, mirroring the offline loop)."""
        if self._pending is None:
            self._span_r = 0.0
            return
        s0, a0 = self._pending
        r = self._span_r / self.scale
        self._pending = None
        self._span_r = 0.0
        if self.rcfg.nstep > 0:
            for t in self.asm.add(s0, a0, r):
                self._pack(t, s2, mask2)
        else:
            self._pack((s0, a0, r), s2, mask2, done=0.0)

    def _pack(self, t: tuple, s2: np.ndarray, mask2: np.ndarray,
              done: float = 1.0):
        """Replicate DQNAgent.observe (reward-centering EMA included --
        ``add_rows`` bypasses it) into a packed replay row."""
        s0, a0, r = t
        agent = self.agent
        if agent.cfg.center_rewards:
            if not agent._r_init:
                agent.r_mean, agent._r_init = float(r), True
            else:
                agent.r_mean += agent.cfg.center_beta * (r - agent.r_mean)
            r = r - agent.r_mean
        d = agent.cfg.state_dim
        row = np.empty(2 * d + 4 + agent.cfg.n_actions, np.float32)
        row[:d] = s0
        row[d:2 * d] = s2
        row[2 * d] = a0
        row[2 * d + 1] = r
        row[2 * d + 2] = done
        row[2 * d + 3:-1] = mask2
        row[-1] = 1.0
        self._rows.append(row)
        self.transitions += 1

    # -- helpers --------------------------------------------------------
    def _featurize(self, cluster, d_hat: int) -> np.ndarray:
        rcfg = self.rcfg
        return state_lib.featurize(
            cluster, cluster.profile, n_buckets=rcfg.n_buckets,
            include_impact=rcfg.include_impact_features,
            predict_decode=lambda r: d_hat, alpha=rcfg.alpha,
            include_hardware=rcfg.include_hardware_features,
            include_cache=rcfg.include_cache_features,
            include_health=rcfg.include_health_features)

    def _head_dhat(self, cluster) -> int:
        if self.gateway is not None and cluster.central:
            return max(int(self.gateway.length.estimate(
                cluster.central[0])), 1)
        return 1

    def _hot_swap_snapshot(self):
        """Hand the serving twin copies of the learner's networks (on
        its device): the learner's Adam and polyak steps write its own
        modules in place, and must not reach the served Q-head."""
        self.policy.hot_swap(copy.deepcopy(self.agent.params),
                             copy.deepcopy(self.agent.target))

    def _publish(self):
        self._hot_swap_snapshot()
        self.publishes += 1
        self._pub_step = self.agent.steps

    def telemetry(self) -> dict:
        out = self.agent.telemetry()
        out.update({
            "decisions": float(self.decisions),
            "explored": float(self.explored),
            "forced": float(self.forced),
            "fallback_decisions": float(self.fallback_decisions),
            "fallback_entries": float(self.fallback_entries),
            "transitions": float(self.transitions),
            "publishes": float(self.publishes),
            "mode": self.mode,
        })
        return out
