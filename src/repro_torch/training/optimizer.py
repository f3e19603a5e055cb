"""AdamW with gradient clipping and LR schedules on torch tensors (the
port of ``repro.training.optimizer``).

The reference's arithmetic, leaf by leaf, in f32: the schedule and the
bias corrections are computed as f32 tensors, and nothing is read back
to the host (``lr``, ``grad_norm`` and ``step`` stay tensors).  Weight
decay applies where ``p.ndim >= 2``, as the reference's rule does on its
stacked layout: a norm weight stacked over ``n_periods`` (``ln1 [n, d]``)
is decayed and ``final_norm [d]`` is not.

:func:`update` works in place: the parameters and both moments are
overwritten (the parameters under ``torch.no_grad``), and the returned
trees are the ones passed in, with a fresh ``step`` tensor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.params import leaves, tree_map


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in f32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init(params) -> Dict[str, Any]:
    """f32 zero moments shaped like ``params`` and an int32 step."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.float())) for x in leaves(tree)])))


@torch.no_grad()
def update(cfg: OptimizerConfig, grads, opt_state, params
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, opt_state, metrics
    {"grad_norm", "lr"})."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), device=gnorm.device)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    for g, m, v, p in zip(leaves(grads), leaves(opt_state["mu"]),
                          leaves(opt_state["nu"]), leaves(params)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay > 0 and p.ndim >= 2:   # no decay on norms/bias
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
