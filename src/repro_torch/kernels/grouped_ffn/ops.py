"""The MoE layer's grouped expert FFN: the CUDA kernels' wrapper and its
plain PyTorch version.

The (token, expert) pairs' rows come sorted by expert, ``x_sorted [P,
d]``, with the group offsets ``[E + 1]`` int32 on the same device (rows
``offsets[e] .. offsets[e+1] - 1`` go to expert e; ``offsets[0]`` is 0
and ``offsets[E]`` is P).  Each row goes through its expert's FFN:
``act(x w_gate[e]) * (x w_up[e])`` (or ``act(x w_up[e])`` without a
gate), then ``w_down[e]``.  This stands for the reference's chain of
``jax.lax.ragged_dot`` calls (``repro/models/moe.py::_grouped_ffn``),
an XLA program and no Pallas kernel.

``grouped_ffn`` dispatches on the device: CPU tensors go to
:func:`grouped_ffn_plain` (a loop over the groups, which autograd
differentiates), CUDA tensors to the hand-written kernels in
``csrc/grouped_ffn.cu`` (built on first use), anything else raises.
There is no fallback from the kernels to the plain version.  On the card
a call is two launches that read the offsets there, so nothing is read
to the host: bf16 at widths ``d`` and ``f`` that are multiples of 64
(every MoE model of the port) runs ``grouped_ffn_gemm`` (warpgroup
products fed by TMA), f32 or bf16 at other widths ``grouped_ffn_simt``
(the CUDA cores: an f32 product on the tensor cores would be TF32).
Both versions sum in f32 and round the hidden activation to the input's
dtype once.  An expert's weights are a matrix with unit column stride;
the experts and the rows may lie further apart (replicated storage's
``w[::R]``, a tensor-parallel block of f).

Training: when a CUDA input requires grad, ``grouped_ffn`` goes through
:class:`GroupedFFNFn`, whose forward is the same two launches and whose
backward, :func:`grouped_ffn_bwd`, is hand-written too: u, g and h again,
dh = dy w_down^T with the activation's derivative in its epilogue, dx,
then each expert's three weight gradients, six launches on the CUDA
cores that follow autograd's arithmetic on the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.meta import KernelCost
from repro_torch.models.ops import activation as _activation

#: the kernels' activation codes
ACTIVATIONS = {"silu": 0, "gelu": 1, "relu": 2}
#: experts the kernels' shared tables hold
MAX_EXPERTS = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (the plain version never counts):
#: forwards, two a call, and backwards, one a call (its six launches)
launches = 0
launches_bwd = 0


def cost(pairs: int, d: int, f: int, n_active: int, gated: bool = True,
         itemsize: int = 2) -> KernelCost:
    """The function's work: 2 d f FLOPs a pair for each of its 3 weight
    matrices (2 without a gate); the weights of the ``n_active`` experts
    that some pair reaches read once, the rows read and the output
    written once, in ``itemsize`` bytes (the hidden activation between
    the two products is the kernel's own and not counted, nor the E + 1
    offsets)."""
    mats = 3 if gated else 2
    return KernelCost(2 * pairs * d * f * mats,
                      itemsize * (n_active * mats * d * f + 2 * pairs * d))


def grouped_ffn_plain(x_sorted: torch.Tensor, offsets: torch.Tensor,
                      w_up: torch.Tensor, w_gate: Optional[torch.Tensor],
                      w_down: torch.Tensor, act: str) -> torch.Tensor:
    """The kernels' arithmetic, a group at a time: f32 products of each
    group's rows with its expert's weights, the hidden activation rounded
    to ``x_sorted``'s dtype once, y rounded once.  -> [P, d]."""
    fn = _activation(act)
    dtype = x_sorted.dtype
    y = x_sorted.new_zeros(x_sorted.shape[0], w_down.shape[2])
    bounds = [int(b) for b in offsets]
    for e, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        if hi == lo:
            continue
        x = x_sorted[lo:hi].float()
        u = x @ w_up[e].float()
        h = fn(x @ w_gate[e].float()) * u if w_gate is not None else fn(u)
        y[lo:hi] = (h.to(dtype).float() @ w_down[e].float()).to(dtype)
    return y


def _check_cuda_inputs(x_sorted, offsets, w_up, w_gate, w_down, act):
    if x_sorted.dtype not in _DTYPES:
        raise TypeError(f"grouped_ffn: dtype {x_sorted.dtype} not supported "
                        "(float32 or bfloat16)")
    named = [("w_up", w_up), ("w_down", w_down)]
    if w_gate is not None:
        named.append(("w_gate", w_gate))
    for name, t in [("x_sorted", x_sorted)] + named:
        if t.device != x_sorted.device or t.dtype != x_sorted.dtype:
            raise TypeError(f"grouped_ffn: {name} must be {x_sorted.dtype} "
                            f"on {x_sorted.device}, got {t.dtype} on "
                            f"{t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"grouped_ffn: {name} must be 16-byte aligned")
    if x_sorted.dim() != 2 or not x_sorted.is_contiguous():
        raise ValueError("grouped_ffn: x_sorted must be a contiguous matrix, "
                         f"got {tuple(x_sorted.shape)}")
    for name, t in named:
        if t.dim() != 3 or t.stride(2) != 1:
            raise ValueError(f"grouped_ffn: {name} must be [E, rows, cols] "
                             "with unit column stride, got shape "
                             f"{tuple(t.shape)}, strides {t.stride()}")
    e, d, f = w_up.shape
    if x_sorted.shape[1] != d or tuple(w_down.shape) != (e, f, d) or (
            w_gate is not None and w_gate.shape != w_up.shape):
        raise ValueError(
            f"grouped_ffn: x_sorted {tuple(x_sorted.shape)}, w_up "
            f"{tuple(w_up.shape)}, w_down {tuple(w_down.shape)}, w_gate "
            f"{None if w_gate is None else tuple(w_gate.shape)}")
    if not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"grouped_ffn: {e} experts (at most "
                         f"{MAX_EXPERTS})")
    if (offsets.device != x_sorted.device or offsets.dtype != torch.int32
            or tuple(offsets.shape) != (e + 1,)
            or not offsets.is_contiguous()):
        raise ValueError(f"grouped_ffn: offsets must be a contiguous int32 "
                         f"[{e + 1}] on {x_sorted.device}, got "
                         f"{offsets.dtype} {tuple(offsets.shape)} on "
                         f"{offsets.device}")
    if act not in ACTIVATIONS:
        raise ValueError(f"grouped_ffn: activation {act!r} not in "
                         f"{sorted(ACTIVATIONS)}")


def _strides(w_up, w_gate, w_down):
    """The weights' (expert, row) strides in elements, as the C entry
    points read them."""
    g = w_up if w_gate is None else w_gate
    return (ctypes.c_longlong * 6)(w_up.stride(0), w_up.stride(1),
                                   g.stride(0), g.stride(1),
                                   w_down.stride(0), w_down.stride(1))


def _forward(x_sorted, offsets, w_up, w_gate, w_down, act):
    p = x_sorted.shape[0]
    e, d, f = w_up.shape
    y = torch.empty_like(x_sorted)
    if p == 0:
        return y
    h = torch.empty((p, f), dtype=x_sorted.dtype, device=x_sorted.device)
    stream = torch.cuda.current_stream(x_sorted.device).cuda_stream
    err = build.library().repro_grouped_ffn(
        x_sorted.data_ptr(), offsets.data_ptr(), w_up.data_ptr(),
        (w_up if w_gate is None else w_gate).data_ptr(), w_down.data_ptr(),
        h.data_ptr(), y.data_ptr(), p, d, f, e,
        _strides(w_up, w_gate, w_down), int(w_gate is not None),
        ACTIVATIONS[act], _DTYPES[x_sorted.dtype], stream)
    build.check(err, "grouped_ffn")
    global launches
    launches += 2
    return y


def grouped_ffn_bwd(x_sorted: torch.Tensor, offsets: torch.Tensor,
                    w_up: torch.Tensor, w_gate: Optional[torch.Tensor],
                    w_down: torch.Tensor, dy: torch.Tensor, act: str
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor], torch.Tensor]:
    """The backward on the card: -> (dx [P,d], dw_up, dw_gate (None
    ungated), dw_down), each weight's gradient contiguous in its shape and
    dtype, zero for an expert that no pair reaches."""
    _check_cuda_inputs(x_sorted, offsets, w_up, w_gate, w_down, act)
    dy = dy.contiguous()
    if dy.shape != x_sorted.shape or dy.dtype != x_sorted.dtype:
        raise ValueError(f"grouped_ffn_bwd: dy {dy.dtype} "
                         f"{tuple(dy.shape)} against x_sorted "
                         f"{x_sorted.dtype} {tuple(x_sorted.shape)}")
    p = x_sorted.shape[0]
    e, d, f = w_up.shape
    dev, dtype = x_sorted.device, x_sorted.dtype
    dx = torch.empty_like(x_sorted)
    dw_up = torch.zeros(w_up.shape, dtype=dtype, device=dev)
    dw_gate = None if w_gate is None else torch.zeros_like(dw_up)
    dw_down = torch.zeros(w_down.shape, dtype=dtype, device=dev)
    if p == 0:
        return dx, dw_up, dw_gate, dw_down
    u = torch.empty((p, f), dtype=torch.float32, device=dev)
    g = u if w_gate is None else torch.empty_like(u)
    h = torch.empty((p, f), dtype=dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.library().repro_grouped_ffn_bwd(
        x_sorted.data_ptr(), offsets.data_ptr(), w_up.data_ptr(),
        (w_up if w_gate is None else w_gate).data_ptr(), w_down.data_ptr(),
        dy.data_ptr(), u.data_ptr(), g.data_ptr(), h.data_ptr(),
        dx.data_ptr(), dw_up.data_ptr(),
        (dw_up if dw_gate is None else dw_gate).data_ptr(),
        dw_down.data_ptr(), p, d, f, e, _strides(w_up, w_gate, w_down),
        int(w_gate is not None), ACTIVATIONS[act], _DTYPES[dtype], stream)
    build.check(err, "grouped_ffn_bwd")
    global launches_bwd
    launches_bwd += 1
    return dx, dw_up, dw_gate, dw_down


class GroupedFFNFn(torch.autograd.Function):
    """``grouped_ffn`` on the card under autograd: the kernels' forward,
    :func:`grouped_ffn_bwd` backward (no gradient for the offsets)."""

    @staticmethod
    def forward(ctx, x_sorted, offsets, w_up, w_gate, w_down, act):
        ctx.act = act
        ctx.save_for_backward(x_sorted, offsets, w_up, w_gate, w_down)
        return _forward(x_sorted, offsets, w_up, w_gate, w_down, act)

    @staticmethod
    def backward(ctx, dy):
        x_sorted, offsets, w_up, w_gate, w_down = ctx.saved_tensors
        dx, dw_up, dw_gate, dw_down = grouped_ffn_bwd(
            x_sorted, offsets, w_up, w_gate, w_down, dy, ctx.act)
        return dx, None, dw_up, dw_gate, dw_down, None


def grouped_ffn(x_sorted: torch.Tensor, offsets: torch.Tensor,
                w_up: torch.Tensor, w_gate: Optional[torch.Tensor],
                w_down: torch.Tensor, act: str) -> torch.Tensor:
    """x_sorted [P,d] grouped by expert, offsets [E+1] int32, w_up and
    w_gate [E,d,f] (w_gate None: ungated), w_down [E,f,d] -> [P,d] in
    x_sorted's dtype."""
    if x_sorted.device.type == "cpu":
        return grouped_ffn_plain(x_sorted, offsets, w_up, w_gate, w_down,
                                 act)
    if x_sorted.device.type != "cuda":
        raise ValueError(f"grouped_ffn: no kernel for device "
                         f"{x_sorted.device}")
    _check_cuda_inputs(x_sorted, offsets, w_up, w_gate, w_down, act)
    inputs = [t for t in (x_sorted, w_up, w_gate, w_down) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return GroupedFFNFn.apply(x_sorted, offsets, w_up, w_gate, w_down,
                                  act)
    return _forward(x_sorted, offsets, w_up, w_gate, w_down, act)
