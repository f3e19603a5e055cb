"""Mamba-1 selective scan: the CUDA kernel's wrapper and its plain
PyTorch version.

``mamba_scan`` dispatches on the tensors' device: CPU tensors go to
:func:`mamba_scan_plain`, CUDA tensors to the hand-written kernel in
``csrc/mamba_scan.cu`` (built on first use), anything else raises.
There is no fallback from the kernel to the plain version.

The state starts at zero, as in the Pallas kernel (``kernel.py:29-31``),
so there is no ``h0``.  Any S runs: there is no chunk to divide it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

SUPPORTED_D_STATE = (4, 8, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (the plain version never counts)
launches = 0


def mamba_scan_plain(xc: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor, a_log: torch.Tensor, d: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc, dt [B,S,di]; b, c [B,S,ds]; a_log [di,ds]; d [di] -> (y
    [B,S,di] in xc's dtype, h_final [B,di,ds] f32).  The sequential
    recurrence of ``repro.kernels.mamba_scan.ref`` with ``h0 = 0``, step
    for step in f32."""
    bsz, s, di = xc.shape
    a = -torch.exp(a_log.float())                          # [di,ds]
    xf, dtf, bf, cf = (t.float() for t in (xc, dt, b, c))
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                    device=xc.device)
    ys = []
    for t in range(s):
        x_t, dt_t = xf[:, t], dtf[:, t]                    # [B,di]
        h = torch.exp(dt_t[..., None] * a) * h \
            + (dt_t * x_t)[..., None] * bf[:, t, None, :]
        ys.append(torch.sum(h * cf[:, t, None, :], -1) + x_t * d)
    return torch.stack(ys, 1).to(xc.dtype), h


def _check_cuda_inputs(xc, dt, b, c, a_log, d):
    named = (("xc", xc), ("dt", dt), ("b", b), ("c", c), ("a_log", a_log),
             ("d", d))
    for name, t in named:
        if t.device != xc.device:
            raise ValueError(f"mamba_scan: {name} on {t.device}, xc on "
                             f"{xc.device}")
        if not t.is_contiguous():
            raise ValueError(f"mamba_scan: {name} must be contiguous")
    for name, t in named[:4]:
        if t.dtype not in _DTYPES:
            raise TypeError(f"mamba_scan: {name} must be float32 or "
                            f"bfloat16, got {t.dtype}")
    for name, t in named[4:]:
        if t.dtype != torch.float32:
            raise TypeError(f"mamba_scan: {name} must be float32, got "
                            f"{t.dtype}")
    if xc.dim() != 3 or b.dim() != 3:
        raise ValueError(f"mamba_scan: xc {tuple(xc.shape)} must be "
                         f"[B,S,di], b {tuple(b.shape)} [B,S,ds]")
    bsz, s, di = xc.shape
    ds = b.shape[2]
    if (dt.shape != xc.shape or c.shape != b.shape
            or b.shape[:2] != xc.shape[:2]
            or tuple(a_log.shape) != (di, ds) or tuple(d.shape) != (di,)):
        raise ValueError(f"mamba_scan: shapes xc {tuple(xc.shape)}, dt "
                         f"{tuple(dt.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, a_log {tuple(a_log.shape)}, "
                         f"d {tuple(d.shape)}")
    if ds not in SUPPORTED_D_STATE:
        raise ValueError(f"mamba_scan: d_state {ds} not in "
                         f"{SUPPORTED_D_STATE}")
    if bsz <= 0 or s <= 0 or di <= 0 or bsz > 65535:
        raise ValueError(f"mamba_scan: B={bsz}, S={s}, di={di} out of "
                         "range")


def mamba_scan(xc: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, a_log: torch.Tensor, d: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc, dt [B,S,di]; b, c [B,S,ds] (each float32 or bfloat16); a_log
    [di,ds], d [di] float32 -> (y [B,S,di] in xc's dtype, h_final
    [B,di,ds] float32)."""
    if xc.device.type == "cpu":
        return mamba_scan_plain(xc, dt, b, c, a_log, d)
    if xc.device.type != "cuda":
        raise ValueError(f"mamba_scan: no kernel for device {xc.device}")
    _check_cuda_inputs(xc, dt, b, c, a_log, d)
    bsz, s, di = xc.shape
    ds = b.shape[2]
    y = torch.empty_like(xc)
    h_final = torch.empty((bsz, di, ds), dtype=torch.float32,
                          device=xc.device)
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    err = build.library().repro_mamba_scan(
        xc.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a_log.data_ptr(), d.data_ptr(), y.data_ptr(), h_final.data_ptr(),
        bsz, s, di, ds, _DTYPES[xc.dtype], _DTYPES[dt.dtype],
        _DTYPES[b.dtype], _DTYPES[c.dtype], stream)
    build.check(err, "mamba_scan")
    global launches
    launches += 1
    return y, h_final
