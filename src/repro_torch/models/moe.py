"""Mixture-of-Experts layer: routed top-k experts plus optional shared
experts (PyTorch twin of ``repro.models.moe``).

Three interchangeable implementations, each returning ``(y, aux)`` as the
reference's do:

  dense   -- every expert on every token, gate-combined over all E (the
             oracle).
  ragged  -- (token, expert) pairs sorted by expert, one ``torch.matmul``
             per non-empty group: the plain counterpart of
             ``jax.lax.ragged_dot``.  The group sizes are read to the host
             once per call.
  gather  -- the tiny-batch path: every expert on the call's few rows,
             then each token takes and combines its top-k outputs (no
             weight copies, no host sync).

The reference's expert-parallel ``moe_ep`` (``shard_map`` over a mesh) is
not ported: the port has no mesh, so ``impl="ep"`` runs ``ragged``, as the
reference does without one.  Routing is the reference's: f32 logits from
an f32 router, softmax before top-k, weights renormalised by
``max(sum, 1e-9)``, and ties broken to the lower expert index, as
``jax.lax.top_k`` breaks them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import ops


def _router(p: Dict, x: torch.Tensor, cfg: ModelConfig):
    """x [T,d] -> (probs [T,E] f32, topk_idx [T,k], topk_w [T,k] f32)."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower index first among equal
    # probabilities (torch.topk promises no order among ties)
    topk_w, topk_idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    topk_w = topk_w[:, :cfg.moe.top_k]
    topk_idx = topk_idx[:, :cfg.moe.top_k]
    topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)
    return probs, topk_idx, topk_w


def aux_loss(probs: torch.Tensor, topk_idx: torch.Tensor,
             n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    sel = torch.nn.functional.one_hot(topk_idx, n_experts).float()
    f = torch.mean(torch.sum(sel, dim=1), dim=0)    # fraction routed * k
    p_mean = torch.mean(probs, dim=0)
    return n_experts * torch.sum(f * p_mean) / topk_idx.shape[1]


def _all_experts(p: Dict, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """Every expert on every row: x [T,d] -> [E,T,d], one batched matmul
    over the stacked experts a weight matrix (``[E,T,d] @ [E,d,f]``), so
    each expert's weights are read once and never copied."""
    act = ops.activation(cfg.activation)
    xe = x[None].expand(p["w_up"].shape[0], -1, -1)
    h = xe @ p["w_up"]
    if cfg.gated_mlp:
        h = act(xe @ p["w_gate"]) * h
    else:
        h = act(h)
    return h @ p["w_down"]


def moe_dense(p: Dict, cfg: ModelConfig, x_flat: torch.Tensor):
    probs, topk_idx, topk_w = _router(p, x_flat, cfg)
    y_all = _all_experts(p["routed"], cfg, x_flat)           # [E,T,d]
    comb = torch.zeros(probs.shape, dtype=torch.float32,
                       device=x_flat.device)
    comb.scatter_(1, topk_idx, topk_w)
    y = torch.einsum("te,etd->td", comb.to(x_flat.dtype), y_all)
    return y, aux_loss(probs, topk_idx, cfg.moe.n_experts)


def _expert_ffn(p: Dict, cfg: ModelConfig, e: int,
                x: torch.Tensor) -> torch.Tensor:
    """Expert e on its rows x [n,d] -> [n,d]."""
    act = ops.activation(cfg.activation)
    h = x @ p["w_up"][e]
    if cfg.gated_mlp:
        h = act(x @ p["w_gate"][e]) * h
    else:
        h = act(h)
    return h @ p["w_down"][e]


def moe_ragged(p: Dict, cfg: ModelConfig, x_flat: torch.Tensor):
    """Sort by expert, one matmul chain per non-empty group (exact
    FLOPs).  The weighted combine casts ``topk_w`` to the experts'
    output dtype before the k-sum, as the reference does."""
    m = cfg.moe
    t = x_flat.shape[0]
    probs, topk_idx, topk_w = _router(p, x_flat, cfg)
    flat_expert = topk_idx.reshape(-1)                       # [T*k]
    order = torch.argsort(flat_expert, stable=True)
    token_of_pair = torch.arange(t * m.top_k, device=x_flat.device) \
        // m.top_k
    x_sorted = x_flat[token_of_pair[order]]
    sizes = torch.bincount(flat_expert, minlength=m.n_experts).tolist()
    outs, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            outs.append(_expert_ffn(p["routed"], cfg, e,
                                    x_sorted[start:start + n]))
            start += n
    y_sorted = torch.cat(outs)
    y_pairs = torch.empty_like(y_sorted)
    y_pairs[order] = y_sorted                                # unsort
    y_pairs = y_pairs.reshape(t, m.top_k, -1)
    y = torch.sum(y_pairs * topk_w[..., None].to(y_pairs.dtype), dim=1)
    return y.to(x_flat.dtype), aux_loss(probs, topk_idx, m.n_experts)


def moe_gather(p: Dict, cfg: ModelConfig, x_flat: torch.Tensor):
    """Tiny-batch path (the engine's gang decode of 8 slots): every
    expert runs on the call's few rows (``_all_experts``), and each row
    takes its top-k experts' outputs and combines them as the reference
    does.  The reference gathers ``[T,k,d,f]`` copies of the chosen
    experts' weights instead; each selected (row, expert) pair's math is
    the same, but here no weight is copied and no host sync is taken
    (``chip_smoke.py`` phase 9c times both ways on the card: at
    deepseek-moe-16b's 8-row decode the copies alone cost several times
    this path)."""
    probs, topk_idx, topk_w = _router(p, x_flat, cfg)
    y_all = _all_experts(p["routed"], cfg, x_flat)           # [E,T,d]
    rows = torch.arange(x_flat.shape[0], device=x_flat.device)
    y = y_all[topk_idx, rows[:, None]]                       # [T,k,d]
    y = torch.sum(y * topk_w[..., None].to(y.dtype), dim=1)
    return y.to(x_flat.dtype), aux_loss(probs, topk_idx, cfg.moe.n_experts)


IMPLS = {"dense": moe_dense, "ragged": moe_ragged, "gather": moe_gather}


def moe_layer(p: Dict, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full MoE block.  x [B,S,d] -> (y [B,S,d], aux_loss scalar).

    The reference's dispatch without a mesh: ``ep`` runs ``ragged``, and
    a call of 8 tokens or fewer runs ``gather`` (the engine's gang decode
    of 8 slots); ``dense`` only where the config asks for it."""
    from repro_torch.models.model import ffn_forward
    m = cfg.moe
    shape = x.shape
    x_flat = x.reshape(-1, shape[-1])
    impl = "ragged" if m.impl == "ep" else m.impl
    if x_flat.shape[0] <= 8:
        impl = "gather"
    if impl not in IMPLS:
        raise ValueError(impl)
    y, aux = IMPLS[impl](p, cfg, x_flat)
    if m.n_shared:
        y = y + ffn_forward(p["shared"], cfg, x_flat)
    return y.reshape(shape), aux
