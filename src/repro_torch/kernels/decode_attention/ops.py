"""Single-token GQA decode attention: the CUDA kernel's wrapper and its
plain PyTorch version.

``decode_attention`` dispatches on the tensors' device: CPU tensors go to
:func:`decode_attention_plain`, CUDA tensors to the hand-written kernel in
``csrc/decode_attention.cu`` (built on first use), anything else raises.
There is no fallback from the kernel to the plain version.  Float32 and
bfloat16 caches only: the int8-cache mode of the Pallas kernel is not
ported yet (the model dequantizes before the call, as the JAX model does).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.plain import gqa_core

SUPPORTED_HEAD_DIMS = (32, 64, 128)
SUPPORTED_GROUPS = (1, 2, 4, 8)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (the plain version never counts)
launches = 0


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """q [B,1,H,hd]; k/v [B,S,KV,hd]; kv_len [B] valid prefix lengths
    -> [B,1,H,hd] (f32 math).  The same function as
    ``repro.kernels.decode_attention.ref``: positions ``< kv_len`` are
    valid, so a kv_len above S leaves all S valid."""
    pos = torch.arange(k.shape[1], device=q.device)
    mask = (pos[None, :] < kv_len[:, None])[:, None, :]       # [B,1,S]
    return gqa_core(q, k, v, mask)


def _check_cuda_inputs(q, k, v, kv_len):
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_len", kv_len)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous"
                             " and 16-byte aligned")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: q/k/v are {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes one of float32 or "
                        "bfloat16")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"decode_attention: kv_len must be int32, got "
                        f"{kv_len.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} must be "
                         f"[B,1,H,hd], k {tuple(k.shape)} [B,S,KV,hd]")
    b, _, h, hd = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd
            or tuple(kv_len.shape) != (b,)):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, kv_len "
                         f"{tuple(kv_len.shape)}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {hd} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if h % k.shape[2] or h // k.shape[2] not in SUPPORTED_GROUPS:
        raise ValueError(f"decode_attention: {h} q heads over {k.shape[2]} "
                         f"kv heads; group size must be in "
                         f"{SUPPORTED_GROUPS}")
    if b <= 0 or k.shape[1] <= 0:
        raise ValueError("decode_attention: empty input")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """q [B,1,H,hd]; k/v [B,S,KV,hd]; kv_len [B] int32 -> [B,1,H,hd] in
    q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device "
                         f"{q.device}")
    _check_cuda_inputs(q, k, v, kv_len)
    b, _, h, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.library().repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), b, k.shape[1], h, k.shape[2], hd, _DTYPES[q.dtype],
        stream)
    build.check(err, "decode_attention")
    global launches
    launches += 1
    return out
