"""Parameter initialization, analytic counting and loading for the model
zoo (PyTorch twin of ``repro.models.params``).

Params are nested dicts of tensors in the reference's layout: layers that
repeat are stacked with a leading ``n_periods`` dimension (one stacked
dict per position in the layer period), attention weights are
``wq [d,H,hd]``, ``wk/wv [d,KV,hd]``, ``wo [H,hd,d]``, MLA's
``wq_a/wq_b/wkv_a/wkv_b/wo`` with their two latent norms, routed experts
``[E,d,f_e]`` / ``[E,f_e,d]`` behind an f32 router ``[d,E]``.  The same
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


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _dense(gen, shape, dtype, device, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    # scaled in place: one f32 temporary beside the result, not two
    return w.mul_(scale).to(dtype)


def _zeros(lead, shape, dtype, device):
    return torch.zeros(lead + shape, dtype=dtype, device=device)


def _init_attn(gen, cfg, lead, dtype, device) -> Dict[str, Any]:
    """GQA projections; ``lead`` is ``(n_periods,)`` for a stacked layer
    and ``()`` for the dense first layer."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": _dense(gen, lead + (d, h, hd), dtype, device, fan_in=d),
         "wk": _dense(gen, lead + (d, kv, hd), dtype, device, fan_in=d),
         "wv": _dense(gen, lead + (d, kv, hd), dtype, device, fan_in=d),
         "wo": _dense(gen, lead + (h, hd, d), dtype, device,
                      fan_in=h * hd)}
    if cfg.qk_norm:
        p["q_norm"] = _zeros(lead, (hd,), dtype, device)
        p["k_norm"] = _zeros(lead, (hd,), dtype, device)
    return p


def _init_mla(gen, cfg, lead, dtype, device) -> Dict[str, Any]:
    """The reference's ``init_mla`` (``params.py:84-102``)."""
    d, h, m = cfg.d_model, cfg.n_heads, cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": _dense(gen, lead + (d, m.q_lora_rank), dtype, device,
                       fan_in=d),
        "q_norm_a": _zeros(lead, (m.q_lora_rank,), dtype, device),
        "wq_b": _dense(gen, lead + (m.q_lora_rank, h, qk), dtype, device,
                       fan_in=m.q_lora_rank),
        "wkv_a": _dense(gen, lead + (d, m.kv_lora_rank
                                     + m.qk_rope_head_dim), dtype, device,
                        fan_in=d),
        "kv_norm_a": _zeros(lead, (m.kv_lora_rank,), dtype, device),
        "wkv_b": _dense(gen, lead + (m.kv_lora_rank, h, m.qk_nope_head_dim
                                     + m.v_head_dim), dtype, device,
                        fan_in=m.kv_lora_rank),
        "wo": _dense(gen, lead + (h, m.v_head_dim, d), dtype, device,
                     fan_in=h * m.v_head_dim),
    }


def _init_ffn(gen, cfg, lead, dtype, device, d_ff=None) -> Dict[str, Any]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": _dense(gen, lead + (d, f), dtype, device, fan_in=d),
         "w_down": _dense(gen, lead + (f, d), dtype, device, fan_in=f)}
    if cfg.gated_mlp:
        p["w_gate"] = _dense(gen, lead + (d, f), dtype, device, fan_in=d)
    return p


def _init_moe(gen, cfg, lead, dtype, device) -> Dict[str, Any]:
    """The reference's ``init_moe`` (``params.py:54-72``) without expert
    parallelism's replicas: routed experts stacked ``[E, d, f_e]`` /
    ``[E, f_e, d]``, an f32 router ``[d, E]``, and the shared experts as
    one dense FFN of width ``n_shared * d_expert``."""
    d, m = cfg.d_model, cfg.moe
    e, fe = m.n_experts, m.d_expert
    routed = {"w_up": _dense(gen, lead + (e, d, fe), dtype, device,
                             fan_in=d),
              "w_down": _dense(gen, lead + (e, fe, d), dtype, device,
                               fan_in=fe)}
    if cfg.gated_mlp:
        routed["w_gate"] = _dense(gen, lead + (e, d, fe), dtype, device,
                                  fan_in=d)
    p = {"router": _dense(gen, lead + (d, e), torch.float32, device,
                          fan_in=d),
         "routed": routed}
    if m.n_shared > 0:
        p["shared"] = _init_ffn(gen, cfg, lead, dtype, device,
                                d_ff=m.n_shared * fe)
    return p


def _init_mamba(gen, cfg, lead, dtype, device) -> Dict[str, Any]:
    d, m, dtr = cfg.d_model, cfg.mamba, cfg.dt_rank
    di, ds, dc = m.d_inner, m.d_state, m.d_conv
    a = torch.arange(1, ds + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(di, 1)
    return {
        "in_proj": _dense(gen, lead + (d, 2 * di), dtype, device, fan_in=d),
        "conv_w": _dense(gen, lead + (dc, di), dtype, device, fan_in=dc),
        "conv_b": _zeros(lead, (di,), dtype, device),
        "x_proj": _dense(gen, lead + (di, dtr + 2 * ds), dtype, device,
                         fan_in=di),
        "dt_proj": _dense(gen, lead + (dtr, di), dtype, device,
                          fan_in=dtr),
        # softplus^-1(0.01)
        "dt_bias": torch.full(lead + (di,), -4.6, dtype=dtype,
                              device=device),
        "A_log": torch.log(a).expand(lead + (di, ds)).contiguous(),
        "D": torch.ones(lead + (di,), dtype=torch.float32, device=device),
        "out_proj": _dense(gen, lead + (di, d), dtype, device, fan_in=di),
    }


def _init_layer(gen, cfg, pos, lead, dtype, device) -> Dict[str, Any]:
    """One layer kind (the reference's ``init_layer``,
    ``params.py:123-149``): attention (GQA or MLA), cross-attention with
    its two scalar gates (zero, as in the reference), or mamba; then a
    dense FFN, MoE, or nothing (``d_ff == 0`` without MoE: falcon-mamba)."""
    kind, is_moe = cfg.layer_kind(pos), cfg.layer_is_moe(pos)
    layer = {"ln1": _zeros(lead, (cfg.d_model,), dtype, device)}
    if kind == "mamba":
        layer["mamba"] = _init_mamba(gen, cfg, lead, dtype, device)
    elif kind == "cross":
        layer["attn"] = _init_attn(gen, cfg, lead, dtype, device)
        layer["gate_attn"] = _zeros(lead, (), dtype, device)
        layer["gate_ffn"] = _zeros(lead, (), dtype, device)
    elif cfg.attention == "mla":
        layer["attn"] = _init_mla(gen, cfg, lead, dtype, device)
    else:
        layer["attn"] = _init_attn(gen, cfg, lead, dtype, device)
    if is_moe or cfg.d_ff > 0:
        layer["ln2"] = _zeros(lead, (cfg.d_model,), dtype, device)
        if is_moe:
            layer["moe"] = _init_moe(gen, cfg, lead, dtype, device)
        else:
            layer["ffn"] = _init_ffn(gen, cfg, lead, dtype, device)
    return layer


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Initialize the full parameter tree on ``device`` (default: the
    card; raises without one unless ``device='cpu'``).  The generator
    must live on the same device type.  The tree has the reference's
    keys: ``embed`` for token inputs only, ``vision_proj
    [vision_dim, d]`` with vision inputs, ``first_layer`` (no
    ``n_periods`` axis) for a dense first layer, and ``lm_head`` when
    the embeddings are untied or the inputs are not tokens."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    d = cfg.d_model
    params: Dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        params["embed"] = _dense(generator, (cfg.vocab_size, d), dtype,
                                 dev, fan_in=d)
    if cfg.vision_tokens:
        params["vision_proj"] = _dense(generator, (cfg.vision_dim, d),
                                       dtype, dev)
    if cfg.dense_first_layer:
        attn_init = _init_mla if cfg.attention == "mla" else _init_attn
        params["first_layer"] = {
            "ln1": _zeros((), (d,), dtype, dev),
            "attn": attn_init(generator, cfg, (), dtype, dev),
            "ln2": _zeros((), (d,), dtype, dev),
            "ffn": _init_ffn(generator, cfg, (), dtype, dev,
                             d_ff=cfg.dense_first_d_ff or cfg.d_ff)}
    params["layers"] = [
        _init_layer(generator, cfg, pos, (cfg.n_periods,), dtype, dev)
        for pos in range(cfg.period)]
    params["final_norm"] = _zeros((), (d,), dtype, dev)
    if not cfg.tie_embeddings or cfg.input_mode != "tokens":
        params["lm_head"] = _dense(generator, (d, cfg.vocab_size), dtype,
                                   dev)
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


# -- trees ---------------------------------------------------------------------

def leaves(tree):
    """A tree's tensors in ``jax.tree_util`` order (dict keys sorted,
    list items by index)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)

