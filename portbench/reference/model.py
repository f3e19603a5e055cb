"""The plain reference of the served models: each layer's equations in
float32 PyTorch (TF32 off), one sequence at a time, one layer at a time,
with no cache, no kernel and nothing of the program.

It reads the weights the benchmark made (the program's tree layout, in
the served bf16, upcast here layer by layer) and the token ids the
benchmark drew plus the tokens the program served, and gives the logits at
the positions asked for.  ``quant`` replaces each weight matrix, as it is
upcast, by a lower-precision copy (the control).

Families:
  moe_attention -- deepseek-moe: RMSNorm (scale 1 + w), MHA/GQA with
                   split-half RoPE and causal softmax, a dense SwiGLU
                   first layer, then MoE layers: a float32 softmax router,
                   the top-k experts (ties to the lower index) with their
                   weights renormalised to sum 1, plus the shared experts
                   as one SwiGLU; untied head.
  mamba1        -- falcon-mamba as the program defines it: RMSNorm, then
                   the Mamba-1 block (in_proj, causal depthwise conv with
                   bias, SiLU, x_proj to dt/B/C, softplus(dt_proj + bias),
                   the selective scan with A = -exp(A_log) and skip D,
                   gating by SiLU(z), out_proj); untied head.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F


def set_precision():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _f(w: torch.Tensor, quant: Optional[Callable]) -> torch.Tensor:
    w = w.float()
    return quant(w) if quant is not None else w


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def rope(x, pos, theta):
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = pos[:, None].float() * inv                    # [S, hd/2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(h, p, m, quant, block=1024):
    s, d = h.shape
    nh, kvh, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = (h @ _f(p["wq"], quant).reshape(d, nh * hd)).view(s, nh, hd)
    k = (h @ _f(p["wk"], quant).reshape(d, kvh * hd)).view(s, kvh, hd)
    v = (h @ _f(p["wv"], quant).reshape(d, kvh * hd)).view(s, kvh, hd)
    pos = torch.arange(s, device=h.device)
    q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    g = nh // kvh
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    for i in range(0, s, block):
        qi = q[i:i + block]                              # [b, H, hd]
        sc = torch.einsum("qhd,khd->hqk", qi, k[:i + len(qi)]) \
            / math.sqrt(hd)
        qpos = torch.arange(i, i + len(qi), device=h.device)
        mask = torch.arange(i + len(qi), device=h.device)[None] \
            <= qpos[:, None]
        sc = sc.masked_fill(~mask[None], float("-inf"))
        out[i:i + len(qi)] = torch.einsum("hqk,khd->qhd",
                                          torch.softmax(sc, -1),
                                          v[:i + len(qi)])
    return out.reshape(s, nh * hd) @ _f(p["wo"], quant).reshape(nh * hd, d)


def swiglu(h, p, quant):
    return (F.silu(h @ _f(p["w_gate"], quant)) * (h @ _f(p["w_up"], quant))) \
        @ _f(p["w_down"], quant)


def moe(h, p, m, quant):
    e = m["moe"]
    probs = torch.softmax(h @ p["router"].float(), -1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :e["top_k"]], idx[:, :e["top_k"]]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    y = torch.zeros_like(h)
    r = p["routed"]
    for x in torch.unique(idx).tolist():
        rows, slot = torch.nonzero(idx == x, as_tuple=True)
        ex = {k: r[k][x] for k in ("w_up", "w_gate", "w_down")}
        y.index_add_(0, rows, swiglu(h[rows], ex, quant)
                     * w[rows, slot][:, None])
    return y + swiglu(h, p["shared"], quant)


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def scan(xc, dt, b, c, a_log, dskip):
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t = C_t . h_t + D x_t,
    h_0 = 0, over [S, di] / [S, ds] in float32: every chunk of L steps
    runs from a zero state in parallel with the others, a pass over the
    chunks carries the state across, and a third pass adds each chunk's
    entering state, decayed, to its outputs (the same sums, associated
    by chunk)."""
    s, di = xc.shape
    ds = b.shape[1]
    a = -torch.exp(a_log.float())                        # [di, ds]
    L = max(16, int(math.ceil(math.sqrt(s))))
    n = -(-s // L)
    pad = n * L - s

    def chunks(t):
        t = torch.cat([t, t.new_zeros((pad,) + t.shape[1:])]) if pad else t
        return t.view(n, L, *t.shape[1:])
    X, DT, B, C = chunks(xc), chunks(dt), chunks(b), chunks(c)
    y = torch.empty(n, L, di, device=xc.device)
    h = torch.zeros(n, di, ds, device=xc.device)
    P = torch.ones(n, di, ds, device=xc.device)
    for j in range(L):
        dec = torch.exp(DT[:, j, :, None] * a)
        h = dec * h + (DT[:, j] * X[:, j])[:, :, None] * B[:, j, None, :]
        P = P * dec
        y[:, j] = (h * C[:, j, None, :]).sum(-1)
    start = torch.zeros(n, di, ds, device=xc.device)
    for i in range(1, n):
        start[i] = P[i - 1] * start[i - 1] + h[i - 1]
    P = torch.ones(n, di, ds, device=xc.device)
    for j in range(L):
        P = P * torch.exp(DT[:, j, :, None] * a)
        y[:, j] += (P * start * C[:, j, None, :]).sum(-1)
    return y.reshape(n * L, di)[:s] + xc * dskip.float()


def mamba_block(h, p, m, quant):
    mb = m["mamba"]
    di, ds, dtr = mb["d_inner"], mb["d_state"], mb["dt_rank"]
    xz = h @ _f(p["in_proj"], quant)
    x, z = xz[:, :di], xz[:, di:]
    w = _f(p["conv_w"], quant)                           # [dc, di]
    dc = w.shape[0]
    xp = torch.cat([x.new_zeros(dc - 1, di), x])
    xc = sum(xp[i:i + len(x)] * w[i] for i in range(dc)) + p["conv_b"].float()
    xc = F.silu(xc)
    dbc = xc @ _f(p["x_proj"], quant)
    u = dbc[:, :dtr] @ _f(p["dt_proj"], quant) + p["dt_bias"].float()
    dt = torch.logaddexp(u, torch.zeros_like(u))        # softplus
    y = scan(xc, dt, dbc[:, dtr:dtr + ds], dbc[:, dtr + ds:], p["A_log"],
             p["D"])
    return (y * F.silu(z)) @ _f(p["out_proj"], quant)


@torch.no_grad()
def logits_at(weights: Dict, config: Dict, tokens: torch.Tensor,
              rows: List[int], quant: Optional[Callable] = None
              ) -> torch.Tensor:
    """Logits [len(rows), V] (float32) of the sequence ``tokens`` [S] at
    positions ``rows`` (the logits a position gives predict the next
    token)."""
    m, fam = config["model"], config["family"]
    eps = m["norm_eps"]
    x = _f(weights["embed"][tokens], quant)              # [S, d]
    if fam == "moe_attention":
        fl = weights["first_layer"]
        x = x + attention(rmsnorm(x, fl["ln1"], eps), fl["attn"], m, quant)
        x = x + swiglu(rmsnorm(x, fl["ln2"], eps), fl["ffn"], quant)
        stack = weights["layers"][0]
        for i in range(m["n_layers"] - 1):
            p = _layer(stack, i)
            x = x + attention(rmsnorm(x, p["ln1"], eps), p["attn"], m, quant)
            x = x + moe(rmsnorm(x, p["ln2"], eps), p["moe"], m, quant)
    elif fam == "mamba1":
        stack = weights["layers"][0]
        for i in range(m["n_layers"]):
            p = _layer(stack, i)
            x = x + mamba_block(rmsnorm(x, p["ln1"], eps), p["mamba"], m,
                                quant)
    else:
        raise ValueError(fam)
    x = rmsnorm(x[rows], weights["final_norm"], eps)
    return x @ _f(weights["lm_head"], quant)


def fp8_rows(w: torch.Tensor) -> torch.Tensor:
    """The control's weights: each row (output feature of the last
    axis's products) rounded to float8 e4m3 under a per-row scale, back in
    float32."""
    amax = w.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale
