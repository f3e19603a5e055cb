"""Mamba-1 selective scan: the CUDA kernel's wrapper and its plain
PyTorch version.

``mamba_scan`` dispatches on the tensors' device: CPU tensors go to
:func:`mamba_scan_plain`, CUDA tensors to the hand-written kernel in
``csrc/mamba_scan.cu`` (built on first use), anything else raises.
There is no fallback from the kernel to the plain version.

The state starts at zero, as in the Pallas kernel (``kernel.py:29-31``),
so there is no ``h0``.  Any S runs: there is no chunk to divide it.

Training: when a CUDA input requires grad, ``mamba_scan`` goes through
:class:`MambaScanFn`, whose forward runs the same kernel also writing the
state entering every 16th step, and whose backward is the hand-written
``repro_mamba_scan_bwd`` (each 16 steps' states recomputed from the saved
one, then swept in reverse; its sums over channels taken in clusters of
blocks and finished, with those over batch and sequence, in a second
pass, all in a fixed order).  On the CPU autograd
differentiates the plain version; :func:`mamba_scan_bwd_plain` writes the
same reverse recursion out in PyTorch, the kernel's yardstick on the card.

On the ``meta`` device (the dry-run) every wrapper returns empty results
of the plain version's shapes (the training forward's saved states at the
kernel's interval) and adds :func:`cost` (or :func:`cost_bwd`, from the
backward under autograd) to ``kernels.meta.tally``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import meta
from repro_torch.kernels.meta import KernelCost

SUPPORTED_D_STATE = (4, 8, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (the plain version never counts):
#: forwards (serving and training alike), and backwards (one a call of
#: the two kernels)
launches = 0
launches_bwd = 0
#: the steps between the training forward's saved states, and the
#: backward's threads a block, lanes a channel (at most; d_state 4 takes 4)
#: and blocks a cluster (``kStateChunk``, ``kThreads``, ``kBwdLanes`` and
#: ``kBwdCluster`` in the source): its scratch holds a partial of db and dc
#: a cluster
STATE_CHUNK = 16
BWD_THREADS = 256
BWD_LANES = 8
BWD_CLUSTER = 8
#: the backward's bound counts the forward's saved states one every this
#: many steps, whatever interval the kernel saves them at (that it saves
#: them more often is its own cost, not the function's)
BOUND_STATE_CHUNK = 64


def cost(b: int, s: int, di: int, ds: int,
         itemsizes=(2, 4, 2, 2)) -> KernelCost:
    """The forward's work.  ``itemsizes``: bytes an element of xc, dt, b
    and c (y takes xc's); a_log, d and h_final are f32.  FLOPs a (step,
    channel, state): dt*a, exp, the state's multiply-add (2), dt*x*B,
    h*C summed (2); a (step, channel): dt*x, D*x + the sum.  These are
    f32 operations on the CUDA cores."""
    xi, dti, bi, ci = itemsizes
    nbytes = (xi * b * s * di + dti * b * s * di + (bi + ci) * b * s * ds
              + 4 * di * ds + 4 * di + xi * b * s * di + 4 * b * di * ds)
    return KernelCost(b * s * di * (7 * ds + 3), nbytes)


def cost_bwd(b: int, s: int, di: int, ds: int,
             itemsizes=(2, 4, 2, 2)) -> KernelCost:
    """The backward's work.  Read: xc and dy (xc's dtype), dt, b, c,
    a_log and d, the forward's states one every ``BOUND_STATE_CHUNK``
    steps (f32); written: dxc, ddt, db, dc in their inputs' dtypes,
    da_log and dd (f32).  Its operation bound is one exponential exp(dt
    a) a (step, channel, state) on the special-function units (``exps``;
    the kernel takes it twice, recomputing each chunk's states: its own
    cost, not the function's).  FLOPs, a count for the dry-run: a (step,
    channel, state) the state recomputed (4), g = g e + dy c (3), dc, db,
    q1, de, ddt and da terms (2 each); a (step, channel) dt x, dx (3),
    ddt (2), dd (2)."""
    xi, dti, bi, ci = itemsizes
    n_states = b * -(-s // BOUND_STATE_CHUNK) * di * ds
    nbytes = (2 * xi * b * s * di + dti * b * s * di
              + (bi + ci) * b * s * ds + 2 * (4 * di * ds + 4 * di)
              + 4 * n_states + xi * b * s * di + dti * b * s * di
              + (bi + ci) * b * s * ds)
    return KernelCost(b * s * di * (19 * ds + 8), nbytes, b * s * di * ds)


def _cost_args(xc, dt, b, c):
    bsz, s, di = xc.shape
    return (bsz, s, di, b.shape[2],
            tuple(t.element_size() for t in (xc, dt, b, c)))


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


def mamba_scan_bwd_plain(xc: torch.Tensor, dt: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor,
                         a_log: torch.Tensor, d: torch.Tensor,
                         dy: torch.Tensor,
                         dh_final: Optional[torch.Tensor] = None):
    """The reverse recursion of :func:`mamba_scan_plain` written out, in
    f32: with g_t = dL/dh_t (starting from ``dh_final``, zero if None)
    and e_t = exp(dt_t a), a = -exp(a_log),
    g_t = g_{t+1} e_{t+1} + dy_t c_t; dc_t = sum_di dy_t h_t;
    db_t = sum_di g_t dt_t x_t; dx_t = dt_t sum_ds g_t b_t + d dy_t;
    ddt_t = x_t sum_ds g_t b_t + sum_ds g_t h_{t-1} e_t a;
    da_log = a * sum g_t h_{t-1} e_t dt_t; dd = sum dy_t x_t.
    Returns (dxc, ddt, db, dc, da_log, dd) in the inputs' dtypes."""
    bsz, s, di = xc.shape
    a = -torch.exp(a_log.float())                          # [di,ds]
    xf, dtf, bf, cf, dyf = (t.float() for t in (xc, dt, b, c, dy))
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                    device=xc.device)
    hs = [h]                                               # h_{-1}..h_{S-1}
    for t in range(s):
        h = torch.exp(dtf[:, t, :, None] * a) * h \
            + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        hs.append(h)
    g = torch.zeros_like(h) if dh_final is None else dh_final.float()
    dx, ddt = torch.empty_like(xf), torch.empty_like(dtf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros_like(a)
    for t in range(s - 1, -1, -1):
        dt_t, x_t, dy_t = dtf[:, t], xf[:, t], dyf[:, t]   # [B,di]
        g = g + dy_t[..., None] * cf[:, t, None, :]
        dc[:, t] = torch.sum(dy_t[..., None] * hs[t + 1], dim=1)
        db[:, t] = torch.sum(g * (dt_t * x_t)[..., None], dim=1)
        e = torch.exp(dt_t[..., None] * a)
        de = g * hs[t] * e
        q1 = torch.sum(g * bf[:, t, None, :], dim=-1)
        dx[:, t] = q1 * dt_t + dy_t * d
        ddt[:, t] = q1 * x_t + torch.sum(de * a, dim=-1)
        da = da + torch.sum(de * dt_t[..., None], dim=0)
        g = g * e
    dd = torch.sum(dyf * xf, dim=(0, 1))
    return (dx.to(xc.dtype), ddt.to(dt.dtype), db.to(b.dtype),
            dc.to(c.dtype), da * a, dd)


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
    if meta.is_meta(xc):
        inputs = (xc, dt, b, c, a_log, d)
        if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
            return MambaScanFn.apply(*inputs)
        return _meta_fwd(xc, dt, b, c)[:2]
    if xc.device.type != "cuda":
        raise ValueError(f"mamba_scan: no kernel for device {xc.device}")
    _check_cuda_inputs(xc, dt, b, c, a_log, d)
    inputs = (xc, dt, b, c, a_log, d)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return MambaScanFn.apply(*inputs)
    return _launch_fwd(xc, dt, b, c, a_log, d, None)


def _meta_fwd(xc, dt, b, c):
    """(y, h_final, h_chunks) as empty meta tensors; the cost recorded."""
    meta.record("mamba_scan", cost(*_cost_args(xc, dt, b, c)))
    bsz, s, di = xc.shape
    ds = b.shape[2]
    return (torch.empty_like(xc),
            torch.empty((bsz, di, ds), dtype=torch.float32, device="meta"),
            torch.empty((bsz, -(-s // STATE_CHUNK), di, ds),
                        dtype=torch.float32, device="meta"))


def _launch_fwd(xc, dt, b, c, a_log, d, h_chunks):
    bsz, s, di = xc.shape
    ds = b.shape[2]
    y = torch.empty_like(xc)
    h_final = torch.empty((bsz, di, ds), dtype=torch.float32,
                          device=xc.device)
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    dtypes = (_DTYPES[xc.dtype], _DTYPES[dt.dtype], _DTYPES[b.dtype],
              _DTYPES[c.dtype])
    ptrs = (xc.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
            a_log.data_ptr(), d.data_ptr(), y.data_ptr(),
            h_final.data_ptr())
    if h_chunks is None:
        err = build.library().repro_mamba_scan(*ptrs, bsz, s, di, ds,
                                               *dtypes, stream)
    else:
        err = build.library().repro_mamba_scan_fwd_states(
            *ptrs, h_chunks.data_ptr(), bsz, s, di, ds, *dtypes, stream)
    build.check(err, "mamba_scan")
    global launches
    launches += 1
    return y, h_final


def mamba_scan_train_fwd(xc, dt, b, c, a_log, d):
    """The training forward on the card: (y, h_final, h_chunks), h_chunks
    [B, ceil(S/16), di, ds] f32 the state entering every 16th step."""
    if meta.is_meta(xc):
        return _meta_fwd(xc, dt, b, c)
    _check_cuda_inputs(xc, dt, b, c, a_log, d)
    bsz, s, di = xc.shape
    h_chunks = torch.empty((bsz, -(-s // STATE_CHUNK), di, b.shape[2]),
                           dtype=torch.float32, device=xc.device)
    y, h_final = _launch_fwd(xc, dt, b, c, a_log, d, h_chunks)
    return y, h_final, h_chunks


def mamba_scan_bwd(xc, dt, b, c, a_log, d, h_chunks, dy,
                   dh_final: Optional[torch.Tensor] = None):
    """The hand-written backward on the card: (dxc, ddt, db, dc, da_log,
    dd) in the inputs' dtypes, from the training forward's ``h_chunks``;
    ``dy`` in xc's dtype, ``dh_final`` f32 [B,di,ds] or None (zero)."""
    if meta.is_meta(xc):
        meta.record("mamba_scan_bwd", cost_bwd(*_cost_args(xc, dt, b, c)))
        return tuple(torch.empty_like(t) for t in (xc, dt, b, c, a_log, d))
    _check_cuda_inputs(xc, dt, b, c, a_log, d)
    bsz, s, di = xc.shape
    ds = b.shape[2]
    if h_chunks.shape != (bsz, -(-s // STATE_CHUNK), di, ds) \
            or h_chunks.dtype != torch.float32:
        raise ValueError(f"mamba_scan_bwd: h_chunks "
                         f"{tuple(h_chunks.shape)} {h_chunks.dtype}")
    if dy.shape != xc.shape or dy.dtype != xc.dtype \
            or not dy.is_contiguous():
        raise ValueError(f"mamba_scan_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"for xc {tuple(xc.shape)} {xc.dtype}")
    if dh_final is not None and (
            dh_final.shape != (bsz, di, ds)
            or dh_final.dtype != torch.float32
            or not dh_final.is_contiguous()):
        raise ValueError(f"mamba_scan_bwd: dh_final "
                         f"{tuple(dh_final.shape)} {dh_final.dtype}")
    grads = [torch.empty_like(t) for t in (xc, dt, b, c, a_log, d)]
    nblk = -(-di // (BWD_THREADS // min(BWD_LANES, ds)))  # channel blocks
    n_cl = -(-nblk // BWD_CLUSTER)                        # their clusters
    scratch = torch.empty(2 * bsz * n_cl * s * ds + bsz * di * (ds + 1),
                          dtype=torch.float32, device=xc.device)
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    err = build.library().repro_mamba_scan_bwd(
        xc.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a_log.data_ptr(), d.data_ptr(), dy.data_ptr(), h_chunks.data_ptr(),
        0 if dh_final is None else dh_final.data_ptr(),
        *(t.data_ptr() for t in grads), scratch.data_ptr(), bsz, s, di, ds,
        _DTYPES[xc.dtype], _DTYPES[dt.dtype], _DTYPES[b.dtype],
        _DTYPES[c.dtype], stream)
    build.check(err, "mamba_scan_bwd")
    global launches_bwd
    launches_bwd += 1
    return tuple(grads)


class MambaScanFn(torch.autograd.Function):
    """The selective scan on the card with the hand-written backward; the
    forward saves its inputs and the chunk entry states."""

    @staticmethod
    def forward(ctx, xc, dt, b, c, a_log, d):
        y, h_final, h_chunks = mamba_scan_train_fwd(xc, dt, b, c, a_log, d)
        ctx.save_for_backward(xc, dt, b, c, a_log, d, h_chunks)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        # autograd materialises the gradient of an unused output (the
        # model's h_final) as zeros
        xc, dt, b, c, a_log, d, h_chunks = ctx.saved_tensors
        return mamba_scan_bwd(xc, dt, b, c, a_log, d, h_chunks,
                              dy.contiguous(), dh_final.contiguous())
