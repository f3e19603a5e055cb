"""The yardstick's arithmetic, frozen here: the H100's peaks, the work of
the three kernels the per-layer rooflines name (copies of the program's
``kernels/*/ops.py::cost`` as of this benchmark), and the model FLOPs of a
token.  A later change to the program's formulas does not move these."""
from __future__ import annotations

from typing import Dict, Tuple

#: NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, float32 outside
#: the tensor cores, HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM = 3.35e12


def causal_pairs(sq: int, skv: int, q_offset: int = 0) -> int:
    """(query, key) pairs causal attention computes: query i sits at
    position i + q_offset and sees keys j <= i + q_offset, j < skv."""
    full = max(0, min(sq, skv - q_offset))
    return (full * (q_offset + 1) + full * (full - 1) // 2
            + (sq - full) * skv)


def flash_fwd(b: int, sq: int, skv: int, h: int, kvh: int, hd: int,
              itemsize: int = 2) -> Tuple[float, float]:
    """Causal prefill attention: 2 products of 2 hd FLOPs a (q, k) pair a
    head; q, k, v read and o written once."""
    pairs = causal_pairs(sq, skv)
    return (4.0 * hd * h * pairs * b,
            float(itemsize * (2 * b * sq * h * hd + 2 * b * skv * kvh * hd)))


def decode_attn(b: int, h: int, kvh: int, hd: int, valid: int,
                itemsize: int = 2) -> Tuple[float, float]:
    """One decode-attention call over ``valid`` cached positions in all
    (the residents' contexts summed): K and V of those positions read, q
    read and o written for ``b`` rows, the int32 lengths read."""
    return (4.0 * hd * h * valid,
            float(itemsize * 2 * valid * kvh * hd + itemsize * 2 * b * h * hd
                  + 4 * b))


def scan_fwd(b: int, s: int, di: int, ds: int,
             itemsizes=(2, 4, 2, 2)) -> Tuple[float, float]:
    """The selective scan's forward: xc, dt, B, C read (bf16, f32, bf16,
    bf16 as the program feeds them), a_log, D read, y written, the final
    state written (f32).  FLOPs a (step, channel, state) 7, a (step,
    channel) 3: float32 work on the CUDA cores."""
    xi, dti, bi, ci = itemsizes
    nbytes = (xi * b * s * di + dti * b * s * di + (bi + ci) * b * s * ds
              + 4 * di * ds + 4 * di + xi * b * s * di + 4 * b * di * ds)
    return float(b * s * di * (7 * ds + 3)), float(nbytes)


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least time the card could take: the larger of the two."""
    return max(flops / peak, nbytes / HBM)


# -- model FLOPs ------------------------------------------------------------

def token_matmul_params(model: Dict, family: str) -> int:
    """Weights a token multiplies by (each once): the projections, the
    dense first layer, the router and the 6 routed + 2 shared experts of
    each MoE layer, the head.  The embedding lookup is no product."""
    d, v = model["d_model"], model["vocab_size"]
    if family == "moe_attention":
        h, kv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
        attn = d * h * hd * 2 + d * kv * hd * 2
        e = model["moe"]
        moe = (d * e["n_experts"]
               + (e["top_k"] + e["n_shared"]) * 3 * d * e["d_expert"])
        return (model["n_layers"] * attn + 3 * d * model["dense_first_d_ff"]
                + (model["n_layers"] - 1) * moe + d * v)
    if family == "mamba1":
        m = model["mamba"]
        di, ds, dtr = m["d_inner"], m["d_state"], m["dt_rank"]
        layer = d * 2 * di + di * (dtr + 2 * ds) + dtr * di + di * d
        return model["n_layers"] * layer + d * v
    raise ValueError(family)


def token_flops(model: Dict, family: str, ctx: int) -> float:
    """Model FLOPs of one token attending ``ctx`` positions: 2 a
    multiply-add over the weights it uses, plus attention's QK^T and PV
    (2 x 2 x heads x head_dim a position a layer).  Elementwise work, the
    convolution and the scan are left out."""
    f = 2.0 * token_matmul_params(model, family)
    if family == "moe_attention":
        f += 4.0 * model["n_heads"] * model["head_dim"] * ctx \
            * model["n_layers"]
    return f


def prompt_flops(model: Dict, family: str, s: int) -> float:
    """A prompt of ``s`` tokens: token i (1-based) attends i positions."""
    f = 2.0 * token_matmul_params(model, family) * s
    if family == "moe_attention":
        f += 4.0 * model["n_heads"] * model["head_dim"] \
            * (s * (s + 1) // 2) * model["n_layers"]
    return f


def kv_bytes_per_token(model: Dict, itemsize: int = 2) -> int:
    """K and V of one position over every attention layer."""
    return model["n_layers"] * 2 * model["n_kv_heads"] * model["head_dim"] \
        * itemsize
