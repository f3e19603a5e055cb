"""Parameter initialization, analytic counting and loading for the model
zoo (PyTorch twin of ``repro.models.params``).

Params are nested dicts of tensors in the reference's layout: layers that
repeat are stacked with a leading ``n_periods`` dimension (one stacked
dict per position in the layer period), attention weights are
``wq [d,H,hd]``, ``wk/wv [d,KV,hd]``, ``wo [H,hd,d]``.  The same
distributions as the reference (scaled normal weights, zero norms), drawn
from an explicit ``torch.Generator``; ``jax.random`` streams cannot be
reproduced in torch, so parity tests carry the reference's parameters in
by value with :func:`from_reference`.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device

_LATER = ("the PyTorch port so far serves decoders of GQA attention and "
          "Mamba-1 layers with dense FFNs; {what} comes with a later "
          "slice of the port")


def check_supported(cfg: ModelConfig):
    """Raise NotImplementedError for layer kinds not yet ported."""
    kinds = set(cfg.layer_pattern)
    if kinds - {"attn", "mamba"}:
        raise NotImplementedError(_LATER.format(
            what=f"layer kind(s) {sorted(kinds - {'attn', 'mamba'})} "
            "(cross-attention)"))
    if "attn" in kinds and cfg.attention != "gqa":
        raise NotImplementedError(_LATER.format(
            what=f"attention {cfg.attention!r} (mla)"))
    if any(cfg.moe_pattern) or cfg.moe is not None or cfg.dense_first_layer:
        raise NotImplementedError(_LATER.format(what="moe"))
    if cfg.input_mode != "tokens" or cfg.vision_tokens:
        raise NotImplementedError(_LATER.format(
            what=f"input mode {cfg.input_mode!r} / vision inputs"))


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _dense(gen, shape, dtype, device, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def _init_attn(gen, cfg, n, dtype, device) -> Dict[str, Any]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": _dense(gen, (n, d, h, hd), dtype, device, fan_in=d),
         "wk": _dense(gen, (n, d, kv, hd), dtype, device, fan_in=d),
         "wv": _dense(gen, (n, d, kv, hd), dtype, device, fan_in=d),
         "wo": _dense(gen, (n, h, hd, d), dtype, device, fan_in=h * hd)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((n, hd), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((n, hd), dtype=dtype, device=device)
    return p


def _init_ffn(gen, cfg, n, dtype, device) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": _dense(gen, (n, d, f), dtype, device, fan_in=d),
         "w_down": _dense(gen, (n, f, d), dtype, device, fan_in=f)}
    if cfg.gated_mlp:
        p["w_gate"] = _dense(gen, (n, d, f), dtype, device, fan_in=d)
    return p


def _init_mamba(gen, cfg, n, dtype, device) -> Dict[str, Any]:
    d, m, dtr = cfg.d_model, cfg.mamba, cfg.dt_rank
    di, ds, dc = m.d_inner, m.d_state, m.d_conv
    a = torch.arange(1, ds + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(di, 1)
    return {
        "in_proj": _dense(gen, (n, d, 2 * di), dtype, device, fan_in=d),
        "conv_w": _dense(gen, (n, dc, di), dtype, device, fan_in=dc),
        "conv_b": torch.zeros((n, di), dtype=dtype, device=device),
        "x_proj": _dense(gen, (n, di, dtr + 2 * ds), dtype, device,
                         fan_in=di),
        "dt_proj": _dense(gen, (n, dtr, di), dtype, device, fan_in=dtr),
        # softplus^-1(0.01)
        "dt_bias": torch.full((n, di), -4.6, dtype=dtype, device=device),
        "A_log": torch.log(a)[None].repeat(n, 1, 1),
        "D": torch.ones((n, di), dtype=torch.float32, device=device),
        "out_proj": _dense(gen, (n, di, d), dtype, device, fan_in=di),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Initialize the full parameter tree on ``device`` (default: the
    card; raises without one unless ``device='cpu'``).  The generator
    must live on the same device type."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    n = cfg.n_periods
    params: Dict[str, Any] = {
        "embed": _dense(generator, (cfg.vocab_size, cfg.d_model), dtype,
                        dev, fan_in=cfg.d_model)}
    layers = []
    for pos in range(cfg.period):
        layer = {"ln1": torch.zeros((n, cfg.d_model), dtype=dtype,
                                    device=dev)}
        if cfg.layer_kind(pos) == "mamba":
            layer["mamba"] = _init_mamba(generator, cfg, n, dtype, dev)
        else:
            layer["attn"] = _init_attn(generator, cfg, n, dtype, dev)
        # the reference's has_ffn without MoE: pure-SSM configs
        # (d_ff == 0, falcon-mamba) have no FFN sub-block
        if cfg.d_ff > 0:
            layer["ln2"] = torch.zeros((n, cfg.d_model), dtype=dtype,
                                       device=dev)
            layer["ffn"] = _init_ffn(generator, cfg, n, dtype, dev)
        layers.append(layer)
    params["layers"] = layers
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                       device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense(generator, (cfg.d_model, cfg.vocab_size),
                                   dtype, dev)
    return params


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":      # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(
            np.array(a, copy=True).view(np.int16)
        ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_reference(tree, device="cuda"):
    """Carry a parameter (or cache) tree of the JAX package into the port
    by value: nested dicts/lists of array-likes (e.g. the result of
    ``jax.tree.map(np.asarray, params)``) -> the same nesting of tensors
    on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_reference(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_reference(v, dev) for v in tree)
    return _to_tensor(tree, dev)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count (matches the reference's init_params;
    roofline).  active_only counts top-k routed experts."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    total = cfg.vocab_size * d if cfg.input_mode == "tokens" else 0
    if not cfg.tie_embeddings or cfg.input_mode != "tokens":
        total += d * cfg.vocab_size
    if cfg.vision_tokens:
        total += cfg.vision_dim * d

    def ffn_count(f):
        return d * f * (3 if cfg.gated_mlp else 2)

    def attn_count():
        if cfg.attention == "mla":
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            return (d * m.q_lora_rank + m.q_lora_rank * h * qk
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * h * (m.qk_nope_head_dim
                                            + m.v_head_dim)
                    + h * m.v_head_dim * d
                    + m.q_lora_rank + m.kv_lora_rank)
        base = d * h * hd + 2 * d * kv * hd + h * hd * d
        if cfg.qk_norm:
            base += 2 * hd
        return base

    def mamba_count():
        m, dtr = cfg.mamba, cfg.dt_rank
        di, ds, dc = m.d_inner, m.d_state, m.d_conv
        return (d * 2 * di + dc * di + di + di * (dtr + 2 * ds)
                + dtr * di + di + di * ds + di + di * d)

    def moe_count():
        m = cfg.moe
        per = m.d_expert * d * (3 if cfg.gated_mlp else 2)
        n_routed = m.top_k if active_only else m.n_experts
        c = d * m.n_experts + n_routed * per
        if m.n_shared:
            c += ffn_count(m.n_shared * m.d_expert)
        return c

    total += d  # final_norm
    for i in range(cfg.n_scan_layers):
        kind = cfg.layer_kind(i)
        total += d  # ln1
        if kind == "mamba":
            total += mamba_count()
        else:
            total += attn_count()
        if kind == "cross":
            total += 2  # gates
        if cfg.layer_is_moe(i):
            total += d + moe_count()
        elif not (kind == "mamba" and cfg.d_ff == 0):
            total += d + ffn_count(cfg.d_ff)
    if cfg.dense_first_layer:
        total += 2 * d + attn_count() + ffn_count(
            cfg.dense_first_d_ff or cfg.d_ff)
    return total


def count_tensor_params(params) -> int:
    """Elements actually held by a parameter tree."""
    if isinstance(params, dict):
        return sum(count_tensor_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_tensor_params(v) for v in params)
    return params.numel()
