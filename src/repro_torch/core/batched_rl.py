"""Batched multi-episode RL training (the router-training scale-up),
the port of ``repro.core.batched_rl`` with the Q-network in torch on
the agent's device.

The sequential trainer (`rl_router.train`, the paper-faithful loop)
interleaves one Python-simulator episode with one Q-network pass per
decision and one synchronous gradient step every few decisions -- the
DQN learner is starved and the accelerator dispatch overhead is paid
per request.  This module runs N independent episodes in lockstep
"rounds" instead:

  * one `DQNAgent.act_batch` call selects actions for all N episodes
    (one Q-network pass per round instead of per decision);
  * every transition feeds ONE shared replay buffer, so the learner
    sees N-fold experience throughput;
  * learn steps are dispatched without a read-back
    (`learn(sync=False)`) once per `learn_every_rounds` rounds: on the
    card the step's kernels stay queued behind the host's simulator
    work until the next act reads the parameters (the host still
    issues every launch; no thread is started);
  * episodes draw from a *scenario stream* (`workload.make_scenario`):
    heterogeneous hardware mixes, bursty/diurnal arrivals, and varying
    cluster widths.  States, masks, and guidance priors are padded to
    the widest cluster `m_max` (padding encodes exactly like a failed
    instance, and the defer action moves to the last slot), so all
    episodes share one Q network and one buffer.

A 1-episode batched run reproduces the sequential path decision for
decision (tests/test_batched_rl.py, tests/test_torch_batched_rl.py).
Replay rows are packed on the host in float32 (``_pack_rows``), so a
round's insert makes no trip through the device.
"""
from __future__ import annotations

import copy
import dataclasses
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import rl_router as rl
from repro_torch.core import state as state_lib
from repro_torch.core.workload import Scenario
from repro_torch.serving.request import summarize


@dataclass
class BatchedRLConfig:
    n_envs: int = 8
    # padded instance width shared by every episode; None = max of
    # cfg.n_instances and the widest scenario seen at start time is NOT
    # knowable, so scenarios wider than m_max raise.
    m_max: Optional[int] = None
    # learn cadence in rounds (a round = one decision on each of n_envs
    # episodes); every 2 rounds x 256-sample batches trains to parity
    # with the sequential loop (validated in
    # benchmarks/bench_batched_rl.py).
    learn_every_rounds: int = 2
    updates_per_learn: int = 1
    # gradient-batch size for the shared learner.  Smaller than the
    # sequential default (512) on purpose: the higher update frequency
    # compensates the smaller batch.
    learn_batch_size: int = 256
    sync_learn: bool = False         # True: read each step's loss back
    valid_every: int = 4             # validate every k completed episodes
    # prioritized replay over the SHARED buffer: |TD| priorities with
    # IS-weight correction (the packed-row weight column).  Uniform
    # sampling (False) remains the validated default.
    prioritized: bool = False
    # simulator backend, resolved through the ``core.backends``
    # registry: "py" steps each episode's SimInstances in Python;
    # "vec" packs ALL episodes' instances into one shared vecsim pool
    # and advances every instance of every episode in fused vector
    # rounds (decision-for-decision identical; see core.vecsim).
    backend: str = "py"
    # extra kwargs for the backend's ``make_pool``
    pool_kwargs: Optional[Dict] = None
    # DEPRECATED alias for ``backend`` (pre-registry spelling); when
    # set it wins, with a DeprecationWarning.
    sim_backend: Optional[str] = None

    def __post_init__(self):
        if self.sim_backend is not None:
            warnings.warn(
                "BatchedRLConfig.sim_backend is deprecated; use "
                "BatchedRLConfig(backend=...) — backends now resolve "
                "through the core.backends registry",
                DeprecationWarning, stacklevel=3)
            self.backend = self.sim_backend


class _Slot:
    """One concurrent episode: env + its schedule point and bookkeeping."""

    __slots__ = ("env", "ep", "scenario", "w_k", "w_sel", "eps", "window",
                 "rew", "s", "s_pad", "mask_pad", "reward", "ticks",
                 "done", "pool_ep")

    def __init__(self, cfg: rl.RouterConfig, scenario: Scenario, ep: int,
                 m_max: int, predict_decode, explore: bool,
                 pool=None, pool_ep: int = 0):
        if scenario.m > m_max:
            raise ValueError(
                f"scenario {scenario.name} has m={scenario.m} > "
                f"m_max={m_max}; raise BatchedRLConfig.m_max")
        self.pool_ep = pool_ep
        self.env = rl.RoutingEnv(cfg, scenario.profiles, predict_decode,
                                 pool=pool, pool_ep=pool_ep)
        self.ep = ep
        self.scenario = scenario
        self.w_k = rl.guidance_weight(cfg, ep)
        self.w_sel = (max(self.w_k, cfg.guidance_floor)
                      if cfg.variant == "guided" else 0.0)
        if explore:
            frac = min(ep / max(cfg.explore_episodes, 1), 1.0)
            eps = cfg.eps_start + (cfg.eps_end - cfg.eps_start) * frac
            self.eps = 0.0 if ep >= cfg.explore_episodes else eps
        else:
            self.eps = 0.0
        self.window: deque = deque()   # (s_pad, a_pad, index into rew)
        self.rew = []                  # scaled per-decision rewards
        self.reward = 0.0
        self.ticks = 0
        self.done = False
        s = self.env.reset(scenario.requests)
        self._set_state(s, m_max, cfg)

    def _set_state(self, s: np.ndarray, m_max: int,
                   cfg: rl.RouterConfig):
        self.s = s
        m = self.env.m
        self.s_pad = state_lib.pad_state(
            s, m, m_max, cfg.include_impact_features,
            cfg.include_hardware_features, cfg.include_cache_features,
            cfg.include_health_features)
        self.mask_pad = state_lib.pad_mask(self.env.mask(), m, m_max)

    def prior_pad(self, m_max: int) -> Optional[np.ndarray]:
        if not self.w_sel:
            return None
        bonus = self.env.guidance_bonus()
        m = self.env.m
        if m == m_max:
            return self.w_sel * bonus
        out = np.zeros(m_max + 1, np.float32)
        out[:m] = bonus[:m]
        out[m_max] = bonus[m]
        return self.w_sel * out

    def unpad_action(self, a: int, m_max: int) -> int:
        return self.env.m if a == m_max else a


def _act_padded(agent, cfg, slots, b_full: int, m_max: int,
                skip=None) -> np.ndarray:
    """One Q-network pass for the live slots, batch-padded to
    ``b_full`` rows, as the reference pads its one compiled shape (the
    slot pool shrinks in the drain phase).  Padding rows are
    all-masked and their argmax is discarded.  ``skip[i]`` rows
    (exploring slots) get no guidance prior."""
    b = len(slots)
    d = slots[0].s_pad.shape[0]
    states = np.zeros((b_full, d), np.float32)
    masks = np.zeros((b_full, m_max + 1), bool)
    for i, sl in enumerate(slots):
        states[i] = sl.s_pad
        masks[i] = sl.mask_pad
    priors = None
    if cfg.variant == "guided":
        priors = np.zeros((b_full, m_max + 1), np.float64)
        for i, sl in enumerate(slots):
            if skip is not None and skip[i]:
                continue
            p = sl.prior_pad(m_max)
            if p is not None:
                priors[i] = p
    acts = agent.act_batch(
        states, masks, epsilon=None, prior=priors,
        q_squash=cfg.q_squash if cfg.variant == "guided" else 0.0)
    return acts[:b]


def _flush_one(agent, slot: _Slot, gp: np.ndarray, nstep: int,
               out: Optional[list] = None):
    """Emit the oldest window entry's truncated n-step return.  Rewards
    live in one per-episode log (`slot.rew`) indexed by decision, so a
    decision costs one append instead of one append per window entry.
    With ``out`` the transition is collected for one batched insert at
    the end of the round (``_observe_packed``) instead of observed
    immediately; insertion order is preserved either way."""
    s0, a0, t0 = slot.window.popleft()
    rs = slot.rew[t0:t0 + nstep]
    ret = float(np.asarray(rs, np.float64) @ gp[:len(rs)])
    if out is None:
        agent.observe(s0, a0, ret, slot.s_pad, 1.0, slot.mask_pad)
    else:
        out.append((s0, a0, ret, slot.s_pad, 1.0, slot.mask_pad))


def _pack_rows(trans: list) -> np.ndarray:
    """A round's transitions [(s, a, r, s2, done, mask2), ...] as
    ``ReplayBuffer`` rows [s | s2 | a | r | done | mask2 | 1.0], packed
    on the host in float32: each column takes the float32 rounding that
    ``ReplayBuffer.add`` gives it (``r`` and ``done`` from float64)."""
    f32 = np.float32
    n = len(trans)
    return np.concatenate(
        [np.stack([t[0] for t in trans]).astype(f32),
         np.stack([t[3] for t in trans]).astype(f32),
         np.asarray([t[1] for t in trans], np.int32).astype(f32)[:, None],
         np.asarray([t[2] for t in trans], np.float64).astype(f32)[:, None],
         np.asarray([t[4] for t in trans], np.float64).astype(f32)[:, None],
         np.stack([t[5] for t in trans]).astype(f32),
         np.ones((n, 1), f32)], axis=1)


def _observe_packed(agent, trans: list):
    """Insert a round's transitions [(s, a, r, s2, done, mask2), ...]
    via ``_pack_rows`` + ``ReplayBuffer.add_rows`` -- bit-identical to
    per-transition ``agent.observe`` calls in the same order.  Reward
    centering is an order-dependent EMA folded into ``r`` at observe
    time, so that configuration keeps the sequential path."""
    if not trans:
        return
    if agent.cfg.center_rewards:
        for t in trans:
            agent.observe(*t)
        return
    agent.buffer.add_rows(_pack_rows(trans))


def _step_fused(slots: List[_Slot], actions: List[int], pool,
                cfg: rl.RouterConfig):
    """One decision on every live episode with FUSED simulator
    stepping: apply each episode's action, then advance all episodes'
    instances together in shared vecsim rounds until every episode
    reaches its next decision point (non-empty router queue) or ends.
    Reward semantics are identical to per-slot ``RoutingEnv.step``
    (same ticks, same per-tick accrual); only the wall-clock cost
    changes -- O(rounds) instead of O(episodes x instances)."""
    n = len(slots)
    shaping = cfg.potential_shaping
    phi0 = ([sl.env._backlog_penalty() for sl in slots] if shaping
            else None)
    rewards = [sl.env._apply_action(actions[i], guide_w=sl.w_k)
               for i, sl in enumerate(slots)]
    dones = [False] * n
    pending = list(range(n))
    while pending:
        # each episode advances to its next possible decision point
        # (its next arrival) -- or a bounded drain window -- in ONE
        # pool call, so lanes at staggered iteration phases coincide
        # in the same fused rounds
        spans = {i: (slots[i].env.cluster.ep,
                     slots[i].env._span_bounds()) for i in pending}
        out = pool.advance_span(list(spans.values()))
        nxt = []
        for i in pending:
            env = slots[i].env
            ep, bounds = spans[i]
            gids, bk_rew = out[ep]
            done_now = env.cluster.collect_span(gids, len(bounds))
            delta, done = env._after_span(done_now, bk_rew)
            rewards[i] += delta
            if done:
                dones[i] = True
            elif not env.cluster.central:
                nxt.append(i)
        pending = nxt
    if shaping:
        for i, sl in enumerate(slots):
            rewards[i] += (cfg.gamma * sl.env._backlog_penalty()
                           - phi0[i])
    return rewards, dones


def train_batched(cfg: rl.RouterConfig,
                  scenario_fn: Callable[[int], Scenario],
                  n_episodes: int,
                  bcfg: Optional[BatchedRLConfig] = None,
                  agent=None,
                  predict_decode: Optional[Callable] = None,
                  valid_fn: Optional[Callable[[], Scenario]] = None,
                  verbose: bool = False,
                  registry=None, device="cuda") -> Dict:
    """Train the RL router over ``n_episodes`` scenarios, ``bcfg.n_envs``
    at a time; returns {agent, history} like `rl_router.train`.

    ``scenario_fn(ep)`` must return a FRESH Scenario per call (the
    simulation consumes its request objects).  ``valid_fn`` (optional)
    returns a validation Scenario; every ``bcfg.valid_every`` completed
    episodes the current greedy policy is scored on it and the best
    snapshot (a copy: the live network keeps learning in place) is
    restored at the end, as in the sequential trainer.  Without an
    ``agent`` a fresh one is built on ``device``.

    ``registry`` (optional ``serving.obs.MetricsRegistry``) receives
    training telemetry after every finished episode: the episode's
    epsilon / reward / mean latencies under ``rl_episode_*`` and the
    agent's learner internals (loss, |TD|, replay priorities) from
    ``agent.telemetry()`` under ``rl_*`` -- the same scrape target the
    gateway publishes serving metrics to."""
    bcfg = bcfg or BatchedRLConfig()
    m_max = bcfg.m_max or cfg.n_instances
    agent = agent or rl.make_agent(cfg, m=m_max, device=device)
    if bcfg.learn_batch_size and \
            agent.cfg.batch_size != bcfg.learn_batch_size:
        agent.cfg = dataclasses.replace(agent.cfg,
                                        batch_size=bcfg.learn_batch_size)
    if bcfg.prioritized and not agent.cfg.prioritized:
        agent.cfg = dataclasses.replace(agent.cfg, prioritized=True)
    scale = 1.0 if cfg.potential_shaping else cfg.reward_scale
    gp = cfg.nstep_gamma ** np.arange(max(cfg.nstep, 1), dtype=np.float64)
    history: List[Dict] = []
    best = None
    started = 0
    pool = None
    if bcfg.backend != "py":
        from repro_torch.core.backends import make_backend
        pool = make_backend(bcfg.backend).make_pool(
            min(bcfg.n_envs, n_episodes), **(bcfg.pool_kwargs or {}))
    slots: List[_Slot] = []
    while started < min(bcfg.n_envs, n_episodes):
        slots.append(_Slot(cfg, scenario_fn(started), started, m_max,
                           predict_decode, explore=True,
                           pool=pool, pool_ep=started))
        started += 1
    round_i = 0
    since_valid = 0
    b_full = len(slots)      # the slot pool only ever shrinks
    while slots:
        b = len(slots)
        # exploration draws first: exploring slots need neither Q values
        # nor guidance priors (mirrors the sequential act() early-out),
        # and an all-exploring round skips the Q pass entirely
        explore = agent.rng.random(b) < np.array([sl.eps for sl in slots])
        if explore.all():
            acts = np.array([agent.rng.choice(np.flatnonzero(sl.mask_pad))
                             for sl in slots], np.int64)
        else:
            acts = _act_padded(agent, cfg, slots, b_full, m_max,
                               skip=explore)
            for i in np.flatnonzero(explore):
                acts[i] = agent.rng.choice(
                    np.flatnonzero(slots[i].mask_pad))
        # dispatch the gradient step(s) NOW, right after the params were
        # consumed by act_batch, in the reference's draw order: with
        # sync_learn=False nothing is read back, so on the card the
        # update runs while the Python below steps the N simulators
        # (the next round's act_batch waits for the new params)
        round_i += 1
        if round_i % bcfg.learn_every_rounds == 0:
            for _ in range(bcfg.updates_per_learn):
                agent.learn(sync=bcfg.sync_learn)
        finished: List[_Slot] = []
        if pool is not None:
            fused_r, fused_done = _step_fused(
                slots, [sl.unpad_action(int(acts[i]), m_max)
                        for i, sl in enumerate(slots)], pool, cfg)
            fused_s2 = state_lib.featurize_vec_many(
                [sl.env.cluster for sl in slots],
                [sl.env.profile for sl in slots],
                [sl.env.predict_decode for sl in slots],
                n_buckets=cfg.n_buckets,
                include_impact=cfg.include_impact_features,
                alpha=cfg.alpha,
                include_hardware=cfg.include_hardware_features,
                include_cache=cfg.include_cache_features,
                include_health=cfg.include_health_features)
        flush: List[tuple] = []
        for i, sl in enumerate(slots):
            a_pad = int(acts[i])
            s_prev_pad = sl.s_pad
            if pool is not None:
                r, done = fused_r[i], fused_done[i]
                s2 = fused_s2[i]
            else:
                s2, r, done, _ = sl.env.step(
                    sl.unpad_action(a_pad, m_max), guide_w=sl.w_k)
            sl._set_state(s2, m_max, cfg)
            if cfg.nstep > 0:
                sl.window.append((s_prev_pad, a_pad, len(sl.rew)))
                sl.rew.append(r / scale)
                if len(sl.window) > cfg.nstep:
                    _flush_one(agent, sl, gp, cfg.nstep, out=flush)
            else:
                flush.append((s_prev_pad, a_pad, r / scale, sl.s_pad,
                              float(done), sl.mask_pad))
            sl.reward += r
            sl.ticks += 1
            if done:
                sl.done = True
                finished.append(sl)
        for sl in finished:
            while sl.window:
                _flush_one(agent, sl, gp, cfg.nstep, out=flush)
        # one packed insert per round; the learner only reads the
        # buffer at the NEXT round's learn call, so deferring to here
        # is invisible to training (order within the round preserved)
        _observe_packed(agent, flush)
        for sl in finished:
            if pool is not None:
                sl.env.cluster.sync_all()     # max_time stragglers
            stats = summarize(sl.scenario.requests)
            stats.update({"episode": sl.ep, "reward": sl.reward,
                          "ticks": sl.ticks, "epsilon": sl.eps,
                          "guide_w": sl.w_k,
                          "scenario": sl.scenario.name,
                          "pattern": sl.scenario.pattern,
                          "m": sl.scenario.m})
            since_valid += 1
            if (valid_fn is not None and sl.eps <= 0.6
                    and since_valid >= bcfg.valid_every):
                since_valid = 0
                v = evaluate_scenarios(cfg, agent, [valid_fn()],
                                       predict_decode, m_max=m_max)[0]
                stats["valid_e2e"] = v["e2e_mean"]
                if best is None or v["e2e_mean"] < best[0]:
                    best = (v["e2e_mean"], copy.deepcopy(agent.params))
            history.append(stats)
            if registry is not None:
                registry.ingest(
                    {"index": float(sl.ep), "epsilon": sl.eps,
                     "reward": sl.reward, "guide_w": sl.w_k,
                     "e2e_mean": stats.get("e2e_mean"),
                     "ttft_mean": stats.get("ttft_mean")},
                    prefix="rl_episode")
                registry.ingest_rl(agent.telemetry())
            if verbose:
                print(f"ep {sl.ep:3d} [{sl.scenario.name:>20s}] "
                      f"eps={sl.eps:.2f} reward={sl.reward:10.1f} "
                      f"e2e={stats.get('e2e_mean', float('nan')):.2f}")
            idx = slots.index(sl)
            if started < n_episodes:
                # a replacement episode reuses the finished slot's pool
                # episode (its lanes are reconfigured for the new shape)
                slots[idx] = _Slot(cfg, scenario_fn(started), started,
                                   m_max, predict_decode, explore=True,
                                   pool=pool, pool_ep=sl.pool_ep)
                started += 1
            else:
                slots.pop(idx)
    if best is not None:
        agent.params = best[1]
        agent.target = copy.deepcopy(best[1])
    history.sort(key=lambda h: h["episode"])
    return {"agent": agent, "history": history}


def evaluate_scenarios(cfg: rl.RouterConfig, agent,
                       scenarios: Sequence[Scenario],
                       predict_decode: Optional[Callable] = None,
                       m_max: Optional[int] = None,
                       backend: str = "py",
                       sim_backend: Optional[str] = None) -> List[Dict]:
    """Greedy (epsilon=0, no learning) batched evaluation; one stats dict
    per scenario, same fields as `rl_router.evaluate`.  With a single
    homogeneous scenario of width cfg.n_instances this reproduces the
    sequential evaluate decision for decision (on any registry
    backend).  ``sim_backend=`` is the deprecated alias of
    ``backend=``."""
    if sim_backend is not None:
        warnings.warn(
            "evaluate_scenarios(sim_backend=...) is deprecated; use "
            "backend=...", DeprecationWarning, stacklevel=2)
        backend = sim_backend
    m_max = m_max or max([cfg.n_instances] + [s.m for s in scenarios])
    pool = None
    if backend != "py":
        from repro_torch.core.backends import make_backend
        pool = make_backend(backend).make_pool(len(scenarios))
    slots = [_Slot(cfg, s, ep=0, m_max=m_max,
                   predict_decode=predict_decode, explore=False,
                   pool=pool, pool_ep=i)
             for i, s in enumerate(scenarios)]
    for sl in slots:
        sl.w_sel = cfg.guidance_floor if cfg.variant == "guided" else 0.0
    live = [sl for sl in slots if not sl.done]
    b_full = max(len(live), 1)
    while live:
        acts = _act_padded(agent, cfg, live, b_full, m_max)
        for i, sl in enumerate(live):
            a = sl.unpad_action(int(acts[i]), m_max)
            s2, _, done, _ = sl.env.step(a)
            sl._set_state(s2, m_max, cfg)
            sl.done = done
        live = [sl for sl in live if not sl.done]
    out = []
    for sl in slots:
        if getattr(sl.env.cluster, "is_vec", False):
            sl.env.cluster.sync_all()     # truncated-run stragglers
        stats = summarize(sl.scenario.requests)
        stats["spikes"] = sum(len(i.spikes)
                              for i in sl.env.cluster.instances)
        routed = [r.routed_at - r.arrival for r in sl.scenario.requests
                  if r.routed_at is not None]
        stats["router_wait_mean"] = (float(np.mean(routed))
                                     if routed else 0.0)
        stats["scenario"] = sl.scenario.name
        out.append(stats)
    return out
