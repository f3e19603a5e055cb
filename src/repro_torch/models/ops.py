"""Primitive neural ops shared across the model zoo (PyTorch twins of
``repro.models.ops``, same numeric conventions)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 that scales by ``1 + w`` (zero-initialised w)."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + w.float())).to(dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": _gelu_tanh,
        "relu": F.relu,
    }[name]


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings (half the head dim)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half rotary position embedding.

    x: [..., seq, n_heads, head_dim]; positions: [..., seq] (int).
    """
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)   # [hd/2]
    angles = positions[..., None].float() * freqs           # [..,S,hd/2]
    angles = angles[..., None, :]                           # [..,S,1,hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def causal_mask(q_len: int, kv_len: int, q_offset=0,
                device=None) -> torch.Tensor:
    """Boolean mask [q_len, kv_len]; True where attention is allowed.

    q_offset: absolute position of the first query (tensor or int).
    """
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross entropy in f32.  logits [..., V], labels
    [...]; ``mask`` weights the tokens (mean over the mask's sum, at
    least 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _ce_block(h: torch.Tensor, w_head: torch.Tensor, y: torch.Tensor,
              softcap_val: float) -> torch.Tensor:
    logits = softcap((h @ w_head).float(), softcap_val)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def chunked_cross_entropy(hidden: torch.Tensor, w_head: torch.Tensor,
                          labels: torch.Tensor, softcap_val: float = 0.0,
                          block: int = 512) -> torch.Tensor:
    """Sequence-chunked CE: the logits exist one [B, block, V] f32 slab
    at a time, each block under ``torch.utils.checkpoint`` (recomputed in
    the backward, as the reference's ``jax.checkpoint`` body is), so the
    full [B, S, V] f32 logits -- 5 GB at qwen3-0.6b's 151,936-token
    vocabulary and 8 x 1024 tokens -- never exist.

    hidden [B,S,d] (already final-normed); w_head [d,V]; labels [B,S].
    The block sums are added in order and divided by B * S."""
    b, s, _ = hidden.shape
    block = min(block, s)
    assert s % block == 0
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, block):
        total = total + checkpoint(_ce_block, hidden[:, i:i + block], w_head,
                                   labels[:, i:i + block], softcap_val,
                                   use_reentrant=False)
    return total / (b * s)
