"""Mamba-1 selective SSM block (PyTorch twin of ``repro.models.mamba``).

The sequence scan always goes through ``repro_torch.kernels.mamba_scan``:
the wrapper runs the plain PyTorch recurrence for CPU tensors and the
hand-written CUDA kernel for CUDA tensors, so on the card no prefill
reaches the scan without the kernel.  ``cfg.use_pallas`` and
``mamba.chunk`` are not read: the kernel takes any sequence length, where
the reference's scans assert ``S % min(chunk, S) == 0``.

Decode keeps O(1) state: a (d_conv-1)-deep conv window and the [di,ds]
SSM state, both stored in the model's dtype between steps, as in the
reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.serving import trace as tr_lib


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0); F.softplus turns into the
    # identity above its threshold
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_inputs(p: Dict, cfg: ModelConfig, xc: torch.Tensor):
    """xc [B,S,di] (post-conv, post-silu) -> dt (f32), B, C (xc's
    dtype), each contiguous [B,S,*]."""
    m, dtr = cfg.mamba, cfg.dt_rank
    dbc = xc @ p["x_proj"]                              # [B,S,dtr+2ds]
    # the product's dtype plus an f32 bias promotes dt to f32
    dt = _softplus((dbc[..., :dtr] @ p["dt_proj"]).float()
                   + p["dt_bias"].float())
    b = dbc[..., dtr:dtr + m.d_state].contiguous()
    c = dbc[..., dtr + m.d_state:].contiguous()
    return dt, b, c


def _causal_conv(p: Dict, x: torch.Tensor, state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x [B,S,di]; state [B,dc-1,di] or None.
    Sums the taps in f32 in order; output and new state in x's dtype."""
    w = p["conv_w"].float()                             # [dc,di]
    dc = w.shape[0]
    xf = x.float()
    if state is None:
        pad = torch.zeros((x.shape[0], dc - 1, x.shape[2]),
                          dtype=torch.float32, device=x.device)
    else:
        pad = state.float()
    xp = torch.cat([pad, xf], dim=1)                    # [B,S+dc-1,di]
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i] for i in range(dc))
    out = out + p["conv_b"].float()
    new_state = xp[:, xp.shape[1] - (dc - 1):]
    return out.to(x.dtype), new_state.to(x.dtype)


def _seq(p: Dict, cfg: ModelConfig, x: torch.Tensor):
    with tr_lib.span("repro.mamba.in_proj"):
        xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    with tr_lib.span("repro.mamba.conv"):
        xc, conv_state = _causal_conv(p, xi, None)
        xc = F.silu(xc).contiguous()
    with tr_lib.span("repro.mamba.ssm_inputs"):
        dt, bmat, cmat = _ssm_inputs(p, cfg, xc)
    with tr_lib.span("repro.mamba.scan"):
        y, h_final = ms_ops.mamba_scan(xc, dt, bmat, cmat, p["A_log"],
                                       p["D"])
    with tr_lib.span("repro.mamba.out"):
        y = y * F.silu(z)
        return y @ p["out_proj"], conv_state, h_final


def mamba_seq(p: Dict, cfg: ModelConfig, x: torch.Tensor):
    """Full-sequence mamba block.  x [B,S,d] -> (y [B,S,d], {"conv"
    [B,dc-1,di], "ssm" [B,di,ds]}) final states, in x's dtype, for the
    decode cache."""
    y, conv_state, h_final = _seq(p, cfg, x)
    return y, {"conv": conv_state, "ssm": h_final.to(x.dtype)}


def mamba_train(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """``mamba_seq``'s train mode: x [B,S,d] -> y [B,S,d], no state (on
    the card the scan's gradient is the kernel's hand-written
    backward)."""
    return _seq(p, cfg, x)[0]


def mamba_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor, cache: Dict):
    """Single-token step.  x [B,1,d]; cache = {conv [B,dc-1,di], ssm
    [B,di,ds]} -> (y [B,1,d], new states in x's dtype).  The state is
    read as f32, stepped, and stored back in x's dtype every step."""
    conv_state, h = cache["conv"], cache["ssm"]
    with tr_lib.span("repro.mamba.in_proj"):
        xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)  # [B,1,di]
    with tr_lib.span("repro.mamba.conv"):
        xc, conv_state = _causal_conv(p, xi, conv_state)
        xc = F.silu(xc)
    with tr_lib.span("repro.mamba.ssm_inputs"):
        dt, bmat, cmat = _ssm_inputs(p, cfg, xc)
    with tr_lib.span("repro.mamba.scan"):
        a = -torch.exp(p["A_log"].float())
        dtf = dt[:, 0]                                  # [B,di] f32
        x0 = xc[:, 0].float()
        decay = torch.exp(dtf[..., None] * a)           # [B,di,ds]
        drive = (dtf * x0)[..., None] * bmat[:, 0].float()[:, None, :]
        h = decay * h.float() + drive
        y = torch.sum(h * cmat[:, 0].float()[:, None, :], dim=-1)
        y = y + x0 * p["D"]
    with tr_lib.span("repro.mamba.out"):
        y = (y.to(x.dtype) * F.silu(z[:, 0]))[:, None]
        return y @ p["out_proj"], {"conv": conv_state,
                                   "ssm": h.to(x.dtype)}
