"""The router's DQN Q-network in PyTorch (paper §A.9.3): MLP
(state,64),(64,64),(64,m+1), ReLU, and masked greedy action selection
with the decision-time guidance prior.

This is the serving half of ``repro.core.dqn``: the configuration, the
Q-network for both ``q_arch="mlp"`` and ``q_arch="decomposed"``, and
``DQNAgent.act`` / ``act_batch``.  The learning half (``train_batch``,
``ReplayBuffer``, ``learn``, ``observe``, ``telemetry``, ``full_state``)
comes with the training slice of the port.

``jax.random`` initialisation cannot be reproduced from a seed in torch,
so a network is He-normal initialised from an explicit
``torch.Generator``, and :meth:`DQNAgent.from_reference` carries the
reference's parameter tree (numpy arrays) over by value.  Parameter
names follow the reference's tree: ``w0``/``b0``... for the MLP,
``trunk``/``route_head``/``defer_head`` sub-trees for the decomposed
network.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.common.device import resolve_device


@dataclass(frozen=True)
class DQNConfig:
    """The reference's ``DQNConfig``, cut to the fields that build the
    Q-network; the learning fields (discount, optimizer, replay, reward
    centering) come with the training slice."""
    state_dim: int
    n_actions: int
    hidden: Tuple[int, ...] = (64, 64)
    # q_arch "mlp": the paper's fixed-m MLP (27ish,64),(64,64),(64,m+1).
    # q_arch "decomposed": beyond-paper permutation-equivariant network --
    # a shared trunk scores each instance from (instance block, router
    # block); defer is scored from the pooled embedding.  Equivariance
    # removes the all-to-one-instance greedy degeneracy and lets m change
    # at runtime (elastic scaling).
    q_arch: str = "mlp"
    inst_dims: int = 0
    router_dims: int = 0


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

    def reference_tree(self) -> Dict:
        """The parameters as the reference's tree of numpy arrays."""
        tree: Dict = {}
        for name, p in self.state_dict().items():
            node = tree
            parts = name.split(".")
            if parts[0] == "net":
                parts = parts[1:]
            for key in parts[:-1]:
                node = node.setdefault(key, {})
            node[parts[-1]] = p.detach().cpu().numpy()
        return tree

    def load_reference(self, tree: Dict):
        """Copy the reference's parameter tree (``dqn.init_q`` /
        ``DQNAgent.params``, as numpy arrays) into this network."""
        flat: Dict[str, torch.Tensor] = {}

        def walk(node, prefix):
            for key, val in node.items():
                if isinstance(val, dict):
                    walk(val, prefix + key + ".")
                else:
                    flat[prefix + key] = torch.tensor(
                        np.asarray(val, np.float32))
        walk(tree, "net." if self.cfg.q_arch == "mlp" else "")
        self.load_state_dict(flat, strict=True)


def q_values(net: QNetwork, state) -> np.ndarray:
    """Q-values of a [batch, state_dim] numpy batch, computed on the
    network's device in float32 and returned as a float32 numpy array."""
    dev = next(net.parameters()).device
    with torch.no_grad():
        x = torch.as_tensor(np.asarray(state, np.float32), device=dev)
        return net(x).cpu().numpy()


class DQNAgent:
    """The serving side of the reference's ``DQNAgent``: the online
    Q-network on ``device`` (the card unless asked otherwise) and masked
    greedy / epsilon-greedy action selection.  The target network comes
    with the learning half."""

    def __init__(self, cfg: DQNConfig, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = QNetwork(cfg, gen, self.device)
        self.rng = np.random.default_rng(seed)

    def from_reference(self, params: Dict):
        """Load the reference agent's ``params`` tree of numpy arrays."""
        self.params.load_reference(params)

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

    # checkpointable state (target and optimizer come with the learning
    # half)
    def state_dict(self):
        return {"params": self.params.state_dict()}

    def load_state_dict(self, st):
        self.params.load_state_dict(st["params"])
