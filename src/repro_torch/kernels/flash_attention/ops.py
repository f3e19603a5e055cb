"""Causal GQA flash attention: the CUDA kernel's wrapper and its plain
PyTorch version.

``flash_attention`` dispatches on the tensors' device: CPU tensors go to
:func:`flash_attention_plain`, CUDA tensors to the hand-written kernel in
``csrc/flash_attention.cu`` (built on first use), anything else raises.
There is no fallback from the kernel to the plain version.  A bf16 call
runs ``fa_fwd_tc`` (tensor cores; P is rounded to bf16 before P V), an
f32 call ``fa_fwd`` (CUDA cores, full f32); one launch per call either way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.plain import gqa_core

SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (the plain version never counts)
launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          q_offset: int = 0) -> torch.Tensor:
    """q [B,Sq,H,hd]; k/v [B,Skv,KV,hd] -> [B,Sq,H,hd] (f32 math).

    The same function as ``repro.kernels.flash_attention.ref``: query row
    i sits at position i + q_offset and sees keys j <= i + q_offset."""
    mask = None
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device) + q_offset
        kv_pos = torch.arange(k.shape[1], device=q.device)
        mask = (kv_pos[None, :] <= q_pos[:, None])[None]
    return gqa_core(q, k, v, mask)


def _check_cuda_inputs(q, k, v, q_offset):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, "
                            f"q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-d, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             "and 16-byte aligned")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    b, sq, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} q heads not a multiple of "
                         f"{k.shape[2]} kv heads")
    if min(q.shape[:3]) <= 0 or k.shape[1] <= 0:
        raise ValueError("flash_attention: empty input")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q [B,Sq,H,hd]; k/v [B,Skv,KV,hd] -> [B,Sq,H,hd] in q's dtype.
    Any Sq and Skv (ragged tails are masked in the kernel)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device "
                         f"{q.device}")
    _check_cuda_inputs(q, k, v, q_offset)
    b, sq, h, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
        k.shape[1], h, k.shape[2], hd, _DTYPES[q.dtype], int(causal),
        int(q_offset), stream)
    build.check(err, "flash_attention")
    global launches
    launches += 1
    return out
