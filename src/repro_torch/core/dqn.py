"""Double DQN in PyTorch (paper §A.9.3): MLP (state,64),(64,64),(64,m+1),
ReLU, replay buffer, target network, masked epsilon-greedy.

The port of ``repro.core.dqn``: the configuration, the Q-network for
both ``q_arch="mlp"`` and ``q_arch="decomposed"``, the double-DQN
train step (``train_batch``: autograd, the reference's inline Adam and
the fused polyak target update), the host-side ``ReplayBuffer`` with
prioritized replay, and ``DQNAgent`` (acting, ``observe``, ``learn``,
``telemetry`` and checkpointable state in the reference's tree layout).

``jax.random`` initialisation cannot be reproduced from a seed in torch,
so a network is He-normal initialised from an explicit
``torch.Generator``, and :meth:`DQNAgent.from_reference` carries the
reference's trees (numpy arrays) over by value.  Everything the
reference draws with numpy (exploration, replay sampling) uses the same
``np.random.default_rng(seed)`` stream in the same order.  Parameter
names follow the reference's tree: ``w0``/``b0``... for the MLP,
``trunk``/``route_head``/``defer_head`` sub-trees for the decomposed
network.
"""
from __future__ import annotations

import copy
import json
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.common.device import resolve_device
from repro_torch.serving import trace as tr_lib


@dataclass(frozen=True)
class DQNConfig:
    state_dim: int
    n_actions: int
    hidden: Tuple[int, ...] = (64, 64)
    gamma: float = 0.99
    lr: float = 1e-3
    batch_size: int = 512
    buffer_size: int = 200_000
    tau: float = 0.005              # polyak target averaging per learn step
    huber_delta: float = 1.0
    # average-reward centering: the routing MDP carries a large
    # action-independent per-step backlog penalty; centering rewards by a
    # running mean (differential Q-learning) removes the constant component
    # so the TD signal is dominated by action ADVANTAGES.
    center_rewards: bool = True
    center_beta: float = 0.005
    # q_arch "mlp": the paper's fixed-m MLP (27ish,64),(64,64),(64,m+1).
    # q_arch "decomposed": beyond-paper permutation-equivariant network --
    # a shared trunk scores each instance from (instance block, router
    # block); defer is scored from the pooled embedding.  Equivariance
    # removes the all-to-one-instance greedy degeneracy and lets m change
    # at runtime (elastic scaling).
    q_arch: str = "mlp"
    inst_dims: int = 0
    router_dims: int = 0
    # prioritized experience replay (Schaul et al. 2015), proportional
    # variant.  Default OFF: uniform sampling with unit IS weights (the
    # packed row always carries a weight column, so both modes share one
    # train_batch).  Priorities are |TD error| + per_eps; new
    # transitions enter at the current max priority.
    prioritized: bool = False
    per_alpha: float = 0.6          # priority exponent
    per_beta: float = 0.4           # IS-correction exponent (fixed)
    per_eps: float = 1e-3


class MLP(nn.Module):
    """Dense layers ``w{i}`` [in, out] / ``b{i}`` [out] with ReLU between
    them (none after the last), He-normal weights and zero biases."""

    def __init__(self, dims: Sequence[int], generator: torch.Generator,
                 device):
        super().__init__()
        self.n = len(dims) - 1
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            w = torch.randn((a, b), generator=generator, device=device)
            self.register_parameter(
                f"w{i}", nn.Parameter(w * math.sqrt(2.0 / a)))
            self.register_parameter(
                f"b{i}", nn.Parameter(torch.zeros((b,), device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            w, b = getattr(self, f"w{i}"), getattr(self, f"b{i}")
            if w.shape[1] == 1:
                # a one-column layer as a row-wise dot product: torch's
                # CPU matrix-vector product rounds identical rows
                # differently by their position, which would break the
                # ties between identical instances that the reference
                # keeps bit for bit (argmax then picks another instance)
                x = (x * w[:, 0]).sum(-1, keepdim=True) + b
            else:
                x = x @ w + b
            if i < self.n - 1:
                x = torch.relu(x)
        return x


def nest(named: Dict[str, object]) -> Dict:
    """Torch parameter names (``net.w0``, ``trunk.b1``) -> the
    reference's nested tree (``w0``, ``trunk/b1``)."""
    tree: Dict = {}
    for name, val in named.items():
        parts = name.split(".")
        if parts[0] == "net":
            parts = parts[1:]
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = val
    return tree


def _unnest(tree: Dict, prefix: str) -> Dict[str, object]:
    flat: Dict[str, object] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            flat.update(_unnest(val, prefix + key + "."))
        else:
            flat[prefix + key] = val
    return flat


def _as_tensor(val, dtype=torch.float32) -> torch.Tensor:
    if isinstance(val, torch.Tensor):
        return val.detach()
    return torch.tensor(np.asarray(val), dtype=dtype)


class QNetwork(nn.Module):
    """x [batch, state_dim] -> q [batch, n_actions] (last action =
    defer), for either ``cfg.q_arch``."""

    def __init__(self, cfg: DQNConfig, generator: torch.Generator,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        if cfg.q_arch == "mlp":
            self.net = MLP((cfg.state_dim,) + tuple(cfg.hidden)
                           + (cfg.n_actions,), generator, device)
            return
        if cfg.q_arch != "decomposed":
            raise ValueError(f"unknown q_arch {cfg.q_arch!r}")
        h = cfg.hidden[0]
        self.trunk = MLP((cfg.inst_dims + cfg.router_dims, h, h),
                         generator, device)
        self.route_head = MLP((h, 1), generator, device)
        self.defer_head = MLP((h + cfg.router_dims, h, 1), generator,
                              device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.q_arch == "mlp":
            return self.net(x)
        b = x.shape[0]
        n_inst = (x.shape[-1] - cfg.router_dims) // cfg.inst_dims
        inst = x[:, :n_inst * cfg.inst_dims].reshape(b, n_inst,
                                                     cfg.inst_dims)
        router = x[:, n_inst * cfg.inst_dims:]
        router_b = router[:, None].expand(b, n_inst, cfg.router_dims)
        h = torch.relu(self.trunk(torch.cat([inst, router_b], -1)))
        q_route = self.route_head(h)[..., 0]                # [b, n_inst]
        pooled = torch.mean(h, dim=1)
        q_defer = self.defer_head(torch.cat([pooled, router], -1))
        return torch.cat([q_route, q_defer], dim=-1)

    def _prefix(self) -> str:
        return "net." if self.cfg.q_arch == "mlp" else ""

    def tree(self) -> Dict:
        """The parameters as the reference's tree of detached copies."""
        return nest({name: p.detach().clone()
                     for name, p in self.named_parameters()})

    def reference_tree(self) -> Dict:
        """The parameters as the reference's tree of numpy arrays."""
        return nest({name: p.detach().cpu().numpy()
                     for name, p in self.named_parameters()})

    def load_reference(self, tree: Dict):
        """Copy a parameter tree in the reference's layout
        (``dqn.init_q`` / ``DQNAgent.params``; numpy arrays or tensors)
        into this network, on its own device."""
        self.load_state_dict({k: _as_tensor(v) for k, v in
                              _unnest(tree, self._prefix()).items()},
                             strict=True)


def q_values(net: QNetwork, state) -> np.ndarray:
    """Q-values of a [batch, state_dim] numpy batch, computed on the
    network's device in float32 and returned as a float32 numpy array."""
    dev = next(net.parameters()).device
    with torch.no_grad():
        x = torch.as_tensor(np.asarray(state, np.float32), device=dev)
        q = net(x)
    with tr_lib.sync("route_q"):
        return q.cpu().numpy()


def _huber(x, delta):
    a = torch.abs(x)
    return torch.where(a <= delta, 0.5 * x * x, delta * (a - 0.5 * delta))


def adam_step(named_params, grads, opt: Dict, lr: float):
    """The reference's inline Adam, in place: ``opt`` holds ``m`` and
    ``v`` (dicts keyed like ``named_params``) and an int32 0-d ``step``
    whose float32 cast gives the bias corrections."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    step = opt["step"] + 1
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    for (name, p), g in zip(named_params, grads):
        m = b1 * opt["m"][name] + (1 - b1) * g
        v = b2 * opt["v"][name] + (1 - b2) * g * g
        p.copy_(p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
        opt["m"][name].copy_(m)
        opt["v"][name].copy_(v)
    opt["step"].copy_(step)


def zeros_opt(net: nn.Module) -> Dict:
    """Adam state for ``net``: zero moments and an int32 0-d step."""
    dev = next(net.parameters()).device
    return {"m": {n: torch.zeros_like(p).detach()
                  for n, p in net.named_parameters()},
            "v": {n: torch.zeros_like(p).detach()
                  for n, p in net.named_parameters()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def train_batch(cfg: DQNConfig, params: QNetwork, opt: Dict,
                target: QNetwork, batch: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Adam step on the double-DQN TD loss + fused polyak target
    update, in place on ``params``, ``opt`` and ``target``; returns
    (loss, td_abs) as device tensors (no read-back).

    ``batch`` is one packed [B, 2*state_dim + 4 + n_actions] float32
    tensor ([s | s2 | a | r | done | mask2 | w]), so learn() pays a
    single host->device transfer instead of seven.  ``w`` is the
    prioritized replay importance weight (1.0 under uniform sampling);
    the returned ``td_abs`` feeds the priority update."""
    d = cfg.state_dim
    s = batch[:, :d]
    s2 = batch[:, d:2 * d]
    a = batch[:, 2 * d].to(torch.int64)
    r = batch[:, 2 * d + 1]
    done = batch[:, 2 * d + 2]
    mask2 = batch[:, 2 * d + 3:2 * d + 3 + cfg.n_actions] > 0.5
    w = batch[:, 2 * d + 3 + cfg.n_actions]
    with torch.no_grad():
        # double DQN: the online network picks a*, the target values it
        q2_online = params(s2).masked_fill(~mask2, -1e9)
        a_star = torch.argmax(q2_online, dim=1)
        q2 = target(s2).gather(1, a_star[:, None])[:, 0]
        y = r + cfg.gamma * (1.0 - done) * q2
    q_sa = params(s).gather(1, a[:, None])[:, 0]
    td = q_sa - y
    loss = torch.mean(w * _huber(td, cfg.huber_delta))
    named = list(params.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    with torch.no_grad():
        adam_step(named, grads, opt, cfg.lr)
        for t, p in zip(target.parameters(), params.parameters()):
            t.copy_((1.0 - cfg.tau) * t + cfg.tau * p)
    return loss.detach(), td.detach().abs()


class ReplayBuffer:
    """Ring buffer with PACKED rows [s | s2 | a | r | done | mask2 | w]:
    one contiguous float32 matrix, so sampling is a single gather and
    the learner a single host->device transfer.  The trailing column is
    the importance weight consumed by the weighted TD loss -- 1.0 at
    insert; prioritized sampling overwrites it in the sampled COPY, so
    the stored rows stay weight-neutral."""

    def __init__(self, cfg: DQNConfig):
        n, d, a = cfg.buffer_size, cfg.state_dim, cfg.n_actions
        self.d = d
        self.data = np.zeros((n, 2 * d + 4 + a), np.float32)
        self.prio = np.zeros((n,), np.float64)
        # per-slot write sequence: a deferred priority update for a slot
        # the ring has since overwritten must be dropped, or the fresh
        # transition loses its max-priority first-replay guarantee
        self.write_seq = np.zeros((n,), np.int64)
        self.seq = 0
        self.max_prio = 1.0
        self.size = 0
        self.ptr = 0
        self.cap = n

    def add(self, s, a, r, s2, done, mask2):
        row = self.data[self.ptr]
        d = self.d
        row[:d] = s
        row[d:2 * d] = s2
        row[2 * d] = a
        row[2 * d + 1] = r
        row[2 * d + 2] = done
        row[2 * d + 3:-1] = mask2
        row[-1] = 1.0
        # new experience enters at max priority so it is seen at least
        # once before its TD error is known (Schaul et al. 2015)
        self.prio[self.ptr] = self.max_prio
        self.seq += 1
        self.write_seq[self.ptr] = self.seq
        self.ptr = (self.ptr + 1) % self.cap
        self.size = min(self.size + 1, self.cap)

    def add_rows(self, rows: np.ndarray):
        """Bulk-insert pre-packed rows (layout exactly as ``add``).
        Equivalent to n sequential ``add`` calls: priorities only move
        in ``update_priorities``, so every row enters at the same
        ``max_prio``, and the ring pointer / write sequence advance row
        by row."""
        rows = np.asarray(rows, np.float32)
        n = len(rows)
        if n == 0:
            return
        if n > self.cap:          # only the last ``cap`` rows survive
            rows = rows[-self.cap:]
            self.seq += n - self.cap
            n = self.cap
        idx = (self.ptr + np.arange(n)) % self.cap
        self.data[idx] = rows
        self.prio[idx] = self.max_prio
        self.write_seq[idx] = self.seq + 1 + np.arange(n)
        self.seq += n
        self.ptr = int((self.ptr + n) % self.cap)
        self.size = min(self.size + n, self.cap)

    def sample(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        idx = rng.integers(0, self.size, size=batch)
        return self.data[idx]

    def sample_prioritized(self, rng: np.random.Generator, batch: int,
                           alpha: float, beta: float
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Proportional PER draw; returns (rows, idx) with the rows'
        weight column set to the normalized IS correction.  O(size) per
        draw (powered priorities + weighted choice)."""
        p = self.prio[:self.size] ** alpha
        p /= p.sum()
        idx = rng.choice(self.size, size=batch, p=p)
        rows = self.data[idx]                     # fancy index = copy
        w = (self.size * p[idx]) ** -beta
        rows[:, -1] = w / w.max()
        return rows, idx

    def update_priorities(self, idx: np.ndarray, td_abs: np.ndarray,
                          eps: float = 1e-3,
                          expect_seq: Optional[np.ndarray] = None):
        """Set |TD|-based priorities.  ``expect_seq`` (the slots'
        ``write_seq`` captured at sample time) drops updates for slots
        the ring has overwritten since."""
        idx = np.asarray(idx)
        pr = np.abs(np.asarray(td_abs, np.float64)) + eps
        if expect_seq is not None:
            live = self.write_seq[idx] == expect_seq
            idx, pr = idx[live], pr[live]
            if idx.size == 0:
                return
        self.prio[idx] = pr
        self.max_prio = max(self.max_prio, float(pr.max()))


class DQNAgent:
    """The reference's ``DQNAgent`` with its networks on ``device`` (the
    card unless asked otherwise): the online Q-network ``params``, the
    polyak-averaged ``target``, Adam state ``opt`` (moments keyed by the
    torch parameter names, an int32 0-d ``step``), and the host-side
    replay buffer and numpy RNG."""

    def __init__(self, cfg: DQNConfig, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = QNetwork(cfg, gen, self.device)
        self.target = copy.deepcopy(self.params)
        self.opt = zeros_opt(self.params)
        self.buffer = ReplayBuffer(cfg)
        self.rng = np.random.default_rng(seed)
        self.steps = 0
        self.r_mean = 0.0
        self._r_init = False
        self._pending_prio = None      # (idx, td device tensor, stamps)
        # last learn step's loss/|TD| as DEVICE tensors: telemetry()
        # pays the read-back only when somebody reads them
        self.last_loss = None
        self.last_td = None

    def from_reference(self, params: Dict, target: Optional[Dict] = None,
                       opt: Optional[Dict] = None):
        """Load the reference agent's trees of numpy arrays: ``params``,
        and ``target`` (a copy of ``params`` when not given, as a fresh
        reference agent has) and ``opt`` (``{"m", "v", "step"}``) when
        given."""
        self.params.load_reference(params)
        self.target.load_reference(params if target is None else target)
        if opt is not None:
            self._load_opt(opt)

    def _load_opt(self, opt: Dict):
        prefix = self.params._prefix()
        with torch.no_grad():
            for key in ("m", "v"):
                for name, val in _unnest(opt[key], prefix).items():
                    self.opt[key][name].copy_(_as_tensor(val))
            self.opt["step"].copy_(_as_tensor(opt["step"], torch.int32))

    def act(self, state: np.ndarray, mask: np.ndarray,
            epsilon: float = 0.0,
            prior: Optional[np.ndarray] = None,
            q_squash: float = 0.0) -> int:
        """Masked epsilon-greedy; ``prior`` is an optional per-action bonus
        added to Q at selection time (decision-time guidance).  q_squash>0
        bounds Q's influence to +-q_squash (advantages tanh-squashed), so a
        strong prior cannot be overruled by unbounded value noise."""
        valid = np.flatnonzero(mask)
        if epsilon > 0 and self.rng.random() < epsilon:
            return int(self.rng.choice(valid))
        a = self.act_batch(state[None], mask[None],
                           prior=None if prior is None else prior[None],
                           q_squash=q_squash)
        return int(a[0])

    def act_batch(self, states: np.ndarray, masks: np.ndarray,
                  epsilon: Optional[np.ndarray] = None,
                  prior: Optional[np.ndarray] = None,
                  q_squash: float = 0.0) -> np.ndarray:
        """Vectorized ``act`` over a batch of independent states
        ([B, state_dim] -> [B] actions): one Q-network pass for the
        batch.  The selection arithmetic runs on the host in float64, as
        in the reference."""
        q = q_values(self.params, states).astype(np.float64)
        if q_squash > 0:
            qm = np.where(masks, q, -np.inf)
            ref = np.max(qm, axis=1)
            ref = np.where(np.isfinite(ref), ref, 0.0)
            q = q_squash * np.tanh(q - ref[:, None])
        if prior is not None:
            q = q + prior
        q[~masks] = -np.inf
        acts = np.argmax(q, axis=1).astype(np.int64)
        if epsilon is not None and np.any(epsilon > 0):
            explore = self.rng.random(len(acts)) < epsilon
            for i in np.flatnonzero(explore):
                acts[i] = int(self.rng.choice(np.flatnonzero(masks[i])))
        return acts

    def observe(self, s, a, r, s2, done, mask2):
        if self.cfg.center_rewards:
            if not self._r_init:
                self.r_mean, self._r_init = float(r), True
            else:
                self.r_mean += self.cfg.center_beta * (r - self.r_mean)
            r = r - self.r_mean
        self.buffer.add(s, a, r, s2, done, mask2)

    def _resolve_priorities(self):
        """Apply the TD-error priorities of the previous prioritized
        step (deferred one learn call, so an asynchronous caller reads
        back a finished result)."""
        if self._pending_prio is None:
            return
        idx, td, stamps = self._pending_prio
        self._pending_prio = None
        self.buffer.update_priorities(idx, td.cpu().numpy(),
                                      eps=self.cfg.per_eps,
                                      expect_seq=stamps)

    def learn(self, sync: bool = True) -> Optional[float]:
        """One gradient step.  ``sync=False`` skips the loss read-back,
        so on the card the step stays queued behind the caller's host
        work until something reads the parameters."""
        if self.buffer.size < self.cfg.batch_size:
            return None
        self._resolve_priorities()
        if self.cfg.prioritized:
            rows, idx = self.buffer.sample_prioritized(
                self.rng, self.cfg.batch_size,
                self.cfg.per_alpha, self.cfg.per_beta)
        else:
            rows, idx = self.buffer.sample(self.rng,
                                           self.cfg.batch_size), None
        batch = torch.from_numpy(rows).to(self.device)
        loss, td_abs = train_batch(self.cfg, self.params, self.opt,
                                   self.target, batch)
        self.last_loss = loss
        self.last_td = td_abs
        if idx is not None:
            self._pending_prio = (idx, td_abs,
                                  self.buffer.write_seq[idx].copy())
            if sync:
                self._resolve_priorities()
        self.steps += 1
        return loss.item() if sync else None

    def telemetry(self) -> Dict[str, float]:
        """Training telemetry snapshot for the metrics registry: last
        TD loss / |TD| stats, replay occupancy, priority distribution.
        Reading the stashed device tensors synchronizes with the
        learner -- call between learn bursts, not inside them."""
        out: Dict[str, float] = {
            "learn_steps": float(self.steps),
            "replay_size": float(self.buffer.size),
            "reward_mean": float(self.r_mean),
        }
        if self.last_loss is not None:
            out["loss"] = float(self.last_loss)
            td = self.last_td.cpu().numpy()
            out["td_abs_mean"] = float(td.mean())
            out["td_abs_max"] = float(td.max())
        if self.cfg.prioritized and self.buffer.size:
            pr = self.buffer.prio[:self.buffer.size]
            out["replay_prio_mean"] = float(pr.mean())
            out["replay_prio_max"] = float(self.buffer.max_prio)
        return out

    # checkpointable state (router fault tolerance), in the reference's
    # tree layout: {"params", "target", "opt": {"m", "v", "step"}}; the
    # leaves are detached copies, so later learn steps cannot reach them
    def state_dict(self):
        return {"params": self.params.tree(), "target": self.target.tree(),
                "opt": {"m": nest({k: v.clone() for k, v
                                   in self.opt["m"].items()}),
                        "v": nest({k: v.clone() for k, v
                                   in self.opt["v"].items()}),
                        "step": self.opt["step"].clone()}}

    def load_state_dict(self, st):
        """Copy a state tree (tensors or numpy arrays, the reference's
        layout) into this agent's networks and optimizer."""
        self.from_reference(st["params"], st["target"], st["opt"])

    # FULL learner state: everything a mid-stream resume needs to
    # continue bit-exactly -- networks + optimizer + replay-buffer
    # contents + reward-centering EMA + the numpy RNG.  The array-valued
    # parts go in the tree (checksummed leaves); scalars and the 128-bit
    # PCG64 state ride in ``extra`` (JSON keeps the big ints exact,
    # msgpack caps at 64 bits).
    def full_state(self) -> Tuple[Dict, Dict]:
        buf = self.buffer
        tree = dict(self.state_dict(),
                    replay={"data": buf.data, "prio": buf.prio,
                            "write_seq": buf.write_seq})
        extra = {"replay_ptr": buf.ptr, "replay_size": buf.size,
                 "replay_seq": buf.seq,
                 "replay_max_prio": buf.max_prio,
                 "steps": self.steps, "r_mean": self.r_mean,
                 "r_init": bool(self._r_init),
                 "rng_state": json.dumps(self.rng.bit_generator.state)}
        return tree, extra

    def load_full_state(self, tree: Dict, extra: Dict):
        self.load_state_dict(tree)
        buf = self.buffer
        rp = tree["replay"]
        # copy: deserialize hands out read-only np.frombuffer views
        buf.data = np.array(rp["data"], np.float32)
        buf.prio = np.array(rp["prio"], np.float64)
        buf.write_seq = np.array(rp["write_seq"], np.int64)
        buf.ptr = int(extra["replay_ptr"])
        buf.size = int(extra["replay_size"])
        buf.seq = int(extra["replay_seq"])
        buf.max_prio = float(extra["replay_max_prio"])
        self.steps = int(extra["steps"])
        self.r_mean = float(extra["r_mean"])
        self._r_init = bool(extra["r_init"])
        self.rng.bit_generator.state = json.loads(extra["rng_state"])
        self._pending_prio = None      # sampled-slot stamps are stale
