"""Single-token GQA decode attention: the CUDA kernel's wrapper and its
plain PyTorch version.

``decode_attention`` dispatches on the tensors' device: CPU tensors go to
:func:`decode_attention_plain`, CUDA tensors to the hand-written kernel in
``csrc/decode_attention.cu`` (built on first use), anything else raises.
There is no fallback from the kernel to the plain version.

Both modes of the Pallas kernel are here: float32/bfloat16 caches, and
int8 caches with per-token-per-head bf16 scales ``k_scale``/``v_scale``
[B,S,KV], dequantized in f32 inside the kernel (``kernel.py:41-43``,
``:98-111``).  The int8 mode returns q's dtype: for a bf16 q that is the
Pallas kernel's bf16 output; for an f32 q the Pallas kernel also rounds
through bf16, which this port leaves out so that the model's f32 decode
matches the JAX model's (see ``csrc/decode_attention.cu``).  The
float-cache and int8-cache modes count their launches apart; each call
is one launch (for bf16 and int8 caches, the split of S over a cluster
of 8 blocks merges inside that launch; f32 caches take one block per
(b, kv-head)).

On the ``meta`` device (the dry-run) :func:`decode_attention` returns an
empty result of the plain version's shape and adds :func:`cost` to
``kernels.meta.tally``, counting every cached position valid (a meta
``kv_len`` has no values); the card's head-dim and group limits are not
applied there.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import meta
from repro_torch.kernels.meta import KernelCost
from repro_torch.kernels.plain import gqa_core

SUPPORTED_HEAD_DIMS = (32, 64, 128)
SUPPORTED_GROUPS = (1, 2, 4, 8)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (the plain version never counts):
#: the float32/bfloat16-cache mode and the int8-cache mode
launches = 0
launches_int8 = 0


def valid_positions(kv_lens, s: int) -> int:
    """The cached positions a call reads: each slot's ``kv_len`` clipped
    to [0, S], summed over the slots."""
    return sum(min(max(int(n), 0), s) for n in kv_lens)


def cost(b: int, h: int, kvh: int, hd: int, valid: int,
         itemsize: int = 2, int8: bool = False) -> KernelCost:
    """The work of one call over ``valid`` cached positions in all (see
    :func:`valid_positions`): two products of 2 hd FLOPs a (head,
    position); K and V read (``itemsize`` bytes an element, or int8 with
    bf16 scales a (position, kv-head)), q read and the output written in
    ``itemsize`` bytes, the int32 kv_len read."""
    kv = (2 * valid * kvh * hd + 2 * 2 * valid * kvh if int8
          else itemsize * 2 * valid * kvh * hd)
    return KernelCost(4 * hd * h * valid,
                      kv + itemsize * 2 * b * h * hd + 4 * b)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_len: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q [B,1,H,hd]; k/v [B,S,KV,hd]; kv_len [B] valid prefix lengths
    -> [B,1,H,hd] (f32 math).  The same function as
    ``repro.kernels.decode_attention.ref``: positions ``< kv_len`` are
    valid, so a kv_len above S leaves all S valid.

    With ``k_scale``/``v_scale`` [B,S,KV] (bf16) the cache is int8: it is
    dequantized in f32 (``k * k_scale``) before the same f32 attention."""
    pos = torch.arange(k.shape[1], device=q.device)
    mask = (pos[None, :] < kv_len[:, None])[:, None, :]       # [B,1,S]
    if k_scale is None:
        return gqa_core(q, k, v, mask)
    return gqa_core(q, k.float() * k_scale.float()[..., None],
                    v.float() * v_scale.float()[..., None], mask)


def _check_cuda_inputs(q, k, v, kv_len, k_scale, v_scale):
    int8 = k_scale is not None
    scales = (("k_scale", k_scale), ("v_scale", v_scale)) if int8 else ()
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_len", kv_len)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous"
                             " and 16-byte aligned")
    for name, t in scales:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be "
                             f"contiguous on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention: {name} must be bfloat16, "
                            f"got {t.dtype}")
    if k.dtype == torch.int8 and not int8:
        raise ValueError("decode_attention: an int8 cache needs its "
                         "k_scale and v_scale")
    cache_dtype = torch.int8 if int8 else q.dtype
    if q.dtype not in _DTYPES or k.dtype != cache_dtype \
            or v.dtype != cache_dtype:
        raise TypeError(f"decode_attention: q/k/v are {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes a float32 or bfloat16"
                        " q with a cache of q's dtype or of int8 (with "
                        "scales)")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"decode_attention: kv_len must be int32, got "
                        f"{kv_len.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} must be "
                         f"[B,1,H,hd], k {tuple(k.shape)} [B,S,KV,hd]")
    b, _, h, hd = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd
            or tuple(kv_len.shape) != (b,)
            or any(t.shape != k.shape[:3] for _, t in scales)):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, kv_len "
                         f"{tuple(kv_len.shape)}, scales "
                         f"{[tuple(t.shape) for _, t in scales]}")
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
                     kv_len: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """q [B,1,H,hd]; k/v [B,S,KV,hd]; kv_len [B] int32 -> [B,1,H,hd] in
    q's dtype.  An int8 cache comes with its bf16 scales ``k_scale`` /
    ``v_scale`` [B,S,KV] and goes to the kernel's int8 mode."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention: pass both k_scale and v_scale "
                         "or neither")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len, k_scale, v_scale)
    if meta.is_meta(q):
        b, _, h, hd = q.shape
        int8 = k_scale is not None
        meta.record("decode_attention_int8" if int8 else "decode_attention",
                    cost(b, h, k.shape[2], hd, b * k.shape[1],
                         q.element_size(), int8))
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device "
                         f"{q.device}")
    _check_cuda_inputs(q, k, v, kv_len, k_scale, v_scale)
    b, _, h, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    global launches, launches_int8
    if k_scale is None:
        err = build.library().repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), b, k.shape[1], h, k.shape[2], hd,
            _DTYPES[q.dtype], stream)
        build.check(err, "decode_attention")
        launches += 1
    else:
        err = build.library().repro_decode_attention_int8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), kv_len.data_ptr(), out.data_ptr(), b,
            k.shape[1], h, k.shape[2], hd, _DTYPES[q.dtype], stream)
        build.check(err, "decode_attention (int8)")
        launches_int8 += 1
    return out
