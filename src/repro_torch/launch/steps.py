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

The dry-run's shape stand-ins (``input_specs``, ``cache_specs``,
``param_specs``, ``opt_specs``, ``adafactor_init_abstract``) are tensors
on the ``meta`` device: the reference's shapes and dtypes, nothing
allocated.  The shape kinds map to the step each feeds:

  train    -> train_step(params, opt_state, batch)
  prefill  -> prefill_step(params, batch)       (builds the KV cache)
  decode   -> serve_step(params, cache, batch)  (one token vs a full cache)
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.common.config import ModelConfig, ShapeConfig
from repro_torch.models import model as model_lib
from repro_torch.models import params as params_lib
from repro_torch.models.params import leaves, torch_dtype, tree_map
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_loop import (loss_and_grads,
                                             make_train_step,
                                             symmetrize_ep_grads)


# -- shape stand-ins (meta tensors) ------------------------------------------

def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """The step's data inputs: tokens (or embeds), labels for training,
    vision inputs where the model has cross layers; decode takes one
    token a row."""
    b, s = shape.global_batch, shape.seq_len
    act = torch_dtype(cfg.dtype)
    batch = {}
    if shape.kind == "decode":
        if cfg.input_mode == "tokens":
            batch["tokens"] = _struct((b,), torch.int32)
        else:
            batch["embeds"] = _struct((b, 1, cfg.d_model), act)
        return batch
    if cfg.input_mode == "tokens":
        batch["tokens"] = _struct((b, s), torch.int32)
    else:
        batch["embeds"] = _struct((b, s, cfg.d_model), act)
    if shape.kind == "train":
        batch["labels"] = _struct((b, s), torch.int32)
    if cfg.vision_tokens:
        batch["vision"] = _struct((b, cfg.vision_tokens, cfg.vision_dim),
                                  act)
    return batch


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """The decode cache of the shape's batch and length, as ``init_cache``
    lays it out under the current parallel context (expanded KV heads
    under a model axis that divides H but not KV)."""
    return model_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                device="meta")


def param_specs(cfg: ModelConfig, data_shards: int) -> Dict:
    return params_lib.abstract_params(cfg, data_shards)


def opt_specs(cfg: ModelConfig, data_shards: int,
              optimizer: str = "adamw") -> Dict:
    """The optimizer state: AdamW's f32 moments and int32 step, or
    Adafactor's factored moments."""
    p = param_specs(cfg, data_shards)
    if optimizer == "adafactor":
        return adafactor_init_abstract(p)

    def f32(x):
        return _struct(x.shape, torch.float32)
    return {"mu": tree_map(f32, p), "nu": tree_map(f32, p),
            "step": _struct((), torch.int32)}


def adafactor_init_abstract(params) -> Dict:
    """Adafactor's state for a tree of (meta) parameters, on their
    device."""
    return adafactor_init(params)


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
