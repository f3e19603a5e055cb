"""Step builders (the port of ``repro.launch.steps``):

  train    -> build_train_step(cfg, optimizer)(params, opt_state, batch)
  prefill  -> build_prefill_step(cfg, shape)(params, batch)
  decode   -> build_serve_step(cfg)(params, cache, batch)

and Adafactor, the optimizer whose factored second moments keep
full-width training of a 7 B model on one 80 GB card (falcon-mamba-7b:
14.5 GB of bf16 parameters, 14.5 GB of gradients, a few MB of moments).

Adafactor works in place, and a leaf with a leading stacked axis
(``ndim >= 3``: the factored axes are the last two) is processed one
slice along that axis at a time: the reference casts a whole leaf to f32,
which for falcon-mamba-7b's stacked ``in_proj [64, 4096, 16384]`` is
17 GB.  The update's RMS clip stays over the whole leaf: the first pass
updates the moments and sums the squared update over the slices, the
second recomputes each slice's update and applies it clipped.  The math
is the reference's; the temporaries are one slice.

The reference's shape stand-ins for the dry-run (``input_specs``,
``cache_specs``, ``param_specs``, ``opt_specs``,
``adafactor_init_abstract``) belong to ``launch/dryrun.py``, which the
port does not have yet (ROADMAP §2 item 6).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.common.config import ModelConfig, ShapeConfig
from repro_torch.models import model as model_lib
from repro_torch.models.params import leaves, tree_map
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_loop import (loss_and_grads,
                                             make_train_step,
                                             symmetrize_ep_grads)


# -- Adafactor -----------------------------------------------------------------

def adafactor_init(params):
    """Factored f32 second moments: ``vr`` (last axis reduced) and ``vc``
    (second-to-last reduced) for a leaf of 2 or more dims, ``v`` for the
    rest; an int32 step."""
    def one(p):
        kw = dict(dtype=torch.float32, device=p.device)
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], **kw),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
        return {"v": torch.zeros(p.shape, **kw)}
    dev = leaves(params)[0].device
    return {"v": tree_map(one, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _factored(g, vr, vc, beta2, eps):
    """One factored leaf (or slice): updates vr, vc in place and returns
    the unclipped update, f32."""
    g = g.float()
    g2 = g * g + eps
    vr.mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-1))
    vc.mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-2))
    return _factored_update(g, vr, vc, eps)


def _factored_update(g, vr, vc, eps):
    denom = torch.sqrt(
        vr[..., None] * vc[..., None, :]
        / torch.clamp(torch.mean(vr, dim=-1, keepdim=True)[..., None],
                      min=eps))
    return g.float() / torch.clamp(denom, min=1e-12)


@torch.no_grad()
def adafactor_update(lr: float, grads, opt_state, params, eps: float = 1e-30,
                     clip: float = 1.0):
    """One Adafactor step, in place: returns (params, opt_state), the
    trees passed in with a fresh ``step``."""
    step = opt_state["step"] + 1
    beta2 = 1.0 - torch.pow(step.float(), -0.8)
    for g, st, p in zip(leaves(grads),
                        _state_leaves(params, opt_state["v"]),
                        leaves(params)):
        if p.ndim >= 3:
            # pass 1: the moments, and the update's sum of squares
            sq = torch.zeros((), dtype=torch.float32, device=p.device)
            for i in range(p.shape[0]):
                upd = _factored(g[i], st["vr"][i], st["vc"][i], beta2, eps)
                sq = sq + torch.sum(upd * upd)
            rms = torch.sqrt(sq / p.numel() + 1e-12)
            div = torch.clamp(rms / clip, min=1.0)
            # pass 2: each slice's update again, clipped and applied
            for i in range(p.shape[0]):
                upd = _factored_update(g[i], st["vr"][i], st["vc"][i], eps)
                p[i].copy_(p[i].float() - lr * (upd / div))
            continue
        if p.ndim == 2:
            upd = _factored(g, st["vr"], st["vc"], beta2, eps)
        else:
            gf = g.float()
            st["v"].mul_(beta2).add_((1 - beta2) * (gf * gf + eps))
            upd = gf / torch.sqrt(st["v"] + 1e-12)
        rms = torch.sqrt(torch.mean(upd * upd) + 1e-12)
        upd = upd / torch.clamp(rms / clip, min=1.0)
        p.copy_(p.float() - lr * upd)
    opt_state["step"] = step
    return params, opt_state


def _state_leaves(params, state):
    """Adafactor's per-leaf state dicts, in the parameters' leaf order."""
    if isinstance(params, dict):
        return [x for k in sorted(params)
                for x in _state_leaves(params[k], state[k])]
    if isinstance(params, (list, tuple)):
        return [x for p, st in zip(params, state)
                for x in _state_leaves(p, st)]
    return [state]


# -- step functions -----------------------------------------------------------

def build_train_step(cfg: ModelConfig, optimizer: str = "adamw") -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): AdamW at ``OptimizerConfig()``'s defaults, or Adafactor at
    lr 1e-3 (metrics "loss", "lm_loss", "moe_aux").  Both update in
    place; ``params`` are leaves requiring grad."""
    if optimizer == "adafactor":
        def train_step(params, opt_state, batch):
            loss, aux, grads = loss_and_grads(cfg, params, batch)
            grads = symmetrize_ep_grads(cfg, grads)
            params, opt_state = adafactor_update(1e-3, grads, opt_state,
                                                 params)
            return params, opt_state, {"loss": loss, **aux}
        return train_step
    return make_train_step(cfg, opt_lib.OptimizerConfig())


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig) -> Callable:
    def prefill_step(params, batch):
        return model_lib.prefill(params, cfg, cache_len=shape.seq_len,
                                 **batch)
    return prefill_step


def build_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, cache, batch):
        return model_lib.decode_step(params, cfg, cache, **batch)
    return serve_step
