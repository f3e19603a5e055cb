"""Causal GQA flash attention: the CUDA kernel's wrapper and its plain
PyTorch version.

``flash_attention`` dispatches on the tensors' device: CPU tensors go to
:func:`flash_attention_plain`, CUDA tensors to the hand-written kernel in
``csrc/flash_attention.cu`` (built on first use), anything else raises.
There is no fallback from the kernel to the plain version.  A bf16 call
runs ``fa_fwd_tc`` (tensor cores; P is rounded to bf16 before P V), an
f32 call ``fa_fwd`` (CUDA cores, full f32); one launch per call either way.

Training: when a CUDA input requires grad, ``flash_attention`` goes
through :class:`FlashAttentionFn`, whose forward runs the same kernels
with the row log-sum-exp written beside the output and whose backward is
the hand-written ``repro_flash_attention_bwd`` (FlashAttention-2's split:
D, dQ, then dK/dV summing each kv-head's group; in bf16 on Hopper's
warpgroup products fed by TMA, D inside the dQ kernel).  Gradients exist
only for what training calls -- ``causal=True``, ``q_offset=0``, Sq = Skv
-- and anything else with grad raises.  On the CPU autograd differentiates
the plain version; :func:`flash_attention_bwd_plain` writes the same
backward formula out in PyTorch, the kernel's yardstick on the card.

On the ``meta`` device (the dry-run) every wrapper returns empty results
of the plain version's shapes and adds :func:`cost` (or
:func:`cost_bwd`, from the backward under autograd) to
``kernels.meta.tally``; the card's head-dim limits are not applied there.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import meta
from repro_torch.kernels.meta import KernelCost
from repro_torch.kernels.plain import NEG_INF, gqa_core

SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (the plain version never counts):
#: forwards (serving and training alike), and backwards (one a call,
#: whichever kernels it runs)
launches = 0
launches_bwd = 0


def cost(b: int, sq: int, skv: int, h: int, kvh: int, hd: int,
         itemsize: int = 2, causal: bool = True, q_offset: int = 0,
         lse: bool = False) -> KernelCost:
    """The forward's work: two products of 2 hd FLOPs a (q, k) pair a
    head (causal pairs only); q and k, v read, the output written, in
    ``itemsize`` bytes an element; with ``lse`` (training) the f32 row
    log-sum-exp written too."""
    pairs = meta.causal_pairs(sq, skv, q_offset) if causal else sq * skv
    nbytes = itemsize * (2 * b * sq * h * hd + 2 * b * skv * kvh * hd)
    return KernelCost(4 * hd * h * pairs * b,
                      nbytes + (4 * b * h * sq if lse else 0))


def cost_bwd(b: int, s: int, h: int, kvh: int, hd: int,
             itemsize: int = 2) -> KernelCost:
    """The backward's work (causal, q_offset 0, Sq = Skv): S and dP
    recomputed, dV, dQ, dK -- five products of 2 hd FLOPs a causal (q, k)
    pair a head; q, k, v, o, do read and dq, dk, dv written in
    ``itemsize`` bytes, the f32 lse read."""
    pairs = meta.causal_pairs(s, s)
    q_el, kv_el = b * s * h * hd, b * s * kvh * hd
    nbytes = (itemsize * (3 * q_el + 2 * kv_el)
              + itemsize * (q_el + 2 * kv_el) + 4 * b * h * s)
    return KernelCost(5 * 2 * hd * h * pairs * b, nbytes)


def _cost_of(q, k, causal=True, q_offset=0, lse=False) -> KernelCost:
    b, sq, h, hd = q.shape
    return cost(b, sq, k.shape[1], h, k.shape[2], hd, q.element_size(),
                causal, q_offset, lse)


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


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward's plain version (causal, q_offset 0):
    (o [B,S,H,hd] in q's dtype, lse [B,H,S] f32), lse the natural
    log-sum-exp of each row's scaled, masked scores."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) \
        / math.sqrt(float(hd))
    pos = torch.arange(s, device=q.device)
    scores = scores.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    lse = torch.logsumexp(scores, dim=-1).reshape(b, h, s)
    return flash_attention_plain(q, k, v), lse


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward of causal attention (q_offset 0, Sq = Skv) in f32,
    written out: P = exp(scale * Q K^T - lse) under the mask, D =
    rowsum(dO * O), dS = P * (dO V^T - D), dQ = scale * dS K, dK =
    scale * dS^T Q and dV = P^T dO, each kv-head summed over its group.
    q/o/do [B,S,H,hd], k/v [B,S,KV,hd], lse [B,H,S] -> (dq, dk, dv) in
    the inputs' dtypes."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    grp = h // kvh
    scale = 1.0 / math.sqrt(float(hd))

    def grouped(t):      # [B,S,H,hd] -> [B,KV,G,S,hd] f32
        return t.float().reshape(b, s, kvh, grp, hd).permute(0, 2, 3, 1, 4)
    qg, og, dog = grouped(q), grouped(o), grouped(do)
    kf = k.float().permute(0, 2, 1, 3)                   # [B,KV,S,hd]
    vf = v.float().permute(0, 2, 1, 3)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    sc = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * scale
    p = torch.exp(sc.masked_fill(~mask, NEG_INF)
                  - lse.reshape(b, kvh, grp, s, 1))
    dsum = torch.sum(dog * og, dim=-1, keepdim=True)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dog, vf) - dsum)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


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


def _check_grad_call(q, k, causal, q_offset):
    if not causal or q_offset != 0 or q.shape[1] != k.shape[1]:
        raise ValueError(
            "flash_attention: gradients are taken only for causal "
            "attention with q_offset=0 and Sq == Skv (training); got "
            f"causal={causal}, q_offset={q_offset}, Sq={q.shape[1]}, "
            f"Skv={k.shape[1]}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q [B,Sq,H,hd]; k/v [B,Skv,KV,hd] -> [B,Sq,H,hd] in q's dtype.
    Any Sq and Skv (ragged tails are masked in the kernel).  A CUDA call
    whose inputs require grad goes through :class:`FlashAttentionFn`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    if meta.is_meta(q):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            _check_grad_call(q, k, causal, q_offset)
            return FlashAttentionFn.apply(q, k, v)
        meta.record("flash_attention", _cost_of(q, k, causal, q_offset))
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device "
                         f"{q.device}")
    _check_cuda_inputs(q, k, v, q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        _check_grad_call(q, k, causal, q_offset)
        return FlashAttentionFn.apply(q, k, v)
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


def flash_attention_train_fwd(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward on the card (causal, q_offset 0): (o, lse
    [B,H,S] f32), one launch of ``fa_fwd_tc`` / ``fa_fwd`` with the row
    log-sum-exp written."""
    if meta.is_meta(q):
        meta.record("flash_attention", _cost_of(q, k, lse=True))
        b, s, h, _ = q.shape
        return (torch.empty_like(q), torch.empty(
            (b, h, s), dtype=torch.float32, device=q.device))
    _check_cuda_inputs(q, k, v, 0)
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.library().repro_flash_attention_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, k.shape[1], h, k.shape[2], hd,
        _DTYPES[q.dtype], 1, 0, stream)
    build.check(err, "flash_attention_fwd_lse")
    global launches
    launches += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """The hand-written backward on the card: (dq, dk, dv) in the inputs'
    dtype for causal attention with q_offset 0 and Sq = Skv."""
    if meta.is_meta(q):
        b, s, h, hd = q.shape
        meta.record("flash_attention_bwd", cost_bwd(
            b, s, h, k.shape[2], hd, q.element_size()))
        return tuple(torch.empty_like(t) for t in (q, k, v))
    _check_cuda_inputs(q, k, v, 0)
    b, s, h, hd = q.shape
    if k.shape[1] != s:
        raise ValueError(f"flash_attention_bwd: Sq {s} != Skv "
                         f"{k.shape[1]}")
    for name, t, dtype in (("o", o, q.dtype), ("do", do, q.dtype),
                           ("lse", lse, torch.float32)):
        if t.device != q.device or t.dtype != dtype \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous, 16-byte aligned {dtype} tensor "
                             f"on {q.device}")
    if o.shape != q.shape or do.shape != q.shape \
            or tuple(lse.shape) != (b, h, s):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} for "
                         f"q {tuple(q.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.library().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, s, h, k.shape[2], hd,
        _DTYPES[q.dtype], stream)
    build.check(err, "flash_attention_bwd")
    global launches_bwd
    launches_bwd += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Causal attention (q_offset 0) on the card with the hand-written
    backward; the forward saves q, k, v, o and the row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_train_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, out, lse, do.contiguous())
