"""The plain PyTorch attention math that both kernels' plain versions
share (the JAX model's ``gqa_core``, ``repro/models/attention.py``)."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def gqa_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped-query attention in f32.

    q: [B, Sq, H, hd];  k/v: [B, Skv, KV, hd];  mask: [B, Sq, Skv] (or
    broadcastable) or None; q-head h reads kv-head h // (H/KV).  Masked
    scores are ``-1e30``, not ``-inf``, as in the reference.
    Returns [B, Sq, H, hd] in q's dtype."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) / math.sqrt(float(hd))
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores,
                             torch.tensor(NEG_INF, device=q.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)
