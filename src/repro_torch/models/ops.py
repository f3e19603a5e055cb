"""Primitive neural ops shared across the model zoo (PyTorch twins of
``repro.models.ops``, same numeric conventions)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
