"""GQA/MHA/MQA self-attention and VLM cross-attention (PyTorch twin of
``repro.models.attention``).

Self-attention always goes through ``repro_torch.kernels``: the
wrappers run the plain PyTorch version for CPU tensors and the
hand-written CUDA kernel for CUDA tensors, so on the card no path reaches
self-attention without the kernel.  ``cfg.use_pallas`` is not read.
Cross-attention is plain PyTorch, as the reference's is plain jnp.

Where the JAX model returns a fresh cache (and the engine donates the old
buffer), these functions update the caller's cache tensors in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
# the reference's ``gqa_core``, shared with the kernels' plain versions
from repro_torch.kernels.plain import gqa_core
from repro_torch.models import ops


def quantize_kv(x: torch.Tensor):
    """[B,S,KV,hd] -> (int8 values, bf16 scales [B,S,KV]) per token+head."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def project_qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor,
                                                  torch.Tensor]:
    """x [B,S,d] -> q [B,S,H,hd], k/v [B,S,KV,hd] (qk-norm, then RoPE)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = ops.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = ops.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = ops.apply_rope(q, positions, cfg.rope_theta)
    k = ops.apply_rope(k, positions, cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _expand_kv_for_tp(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor):
    """When the parallel context's model axis divides H but not the KV
    heads, K/V [B,S,KV,hd] broadcast to the full H heads (each KV head
    repeated H / KV times), the layout ``models.model.cache_kv_heads``
    gives the cache (the reference's, ``attention.py:112-125``).  The
    kernels take grouped heads, so attention itself runs on the
    unexpanded K/V; the port expands only what a cache stores."""
    from repro_torch.distributed import context as dist_ctx
    tp = dist_ctx.tp_size()
    kvh = k.shape[2]
    if tp == 1 or kvh % tp == 0 or cfg.n_heads % tp != 0:
        return k, v
    g = cfg.n_heads // kvh
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def _out_proj(out: torch.Tensor, p: Dict) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def self_attention_train(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                         positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal attention for training (no cache), through
    the flash-attention kernel at any S; on the card its gradient is the
    kernel's hand-written backward.  The reference switches to
    ``gqa_blocked`` above 1024 tokens, whose bf16 operands and bf16
    softmax weights differ from the kernel by bf16 rounding in a bf16
    model (as the port's prefill does); in f32 both agree within 1e-4."""
    q, k, v = project_qkv(p, cfg, x, positions)
    return _out_proj(fa_ops.flash_attention(q, k, v, causal=True,
                                            q_offset=0), p)


def self_attention_prefill(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                           positions: torch.Tensor, cache_entry: Dict,
                           slot: int = 0) -> torch.Tensor:
    """Prefill x [B,S,d]: causal attention through the flash-attention
    kernel, and the prompt's K/V written in place into rows
    ``slot:slot+B`` of the layer's cache (positions ``:S``; the rest of
    each row is zeroed, so the cache holds what the reference's padded
    prefill cache holds).  Returns the attention output [B,S,d]."""
    q, k, v = project_qkv(p, cfg, x, positions)
    out = fa_ops.flash_attention(q, k, v, causal=True, q_offset=0)
    if cache_entry["k"].shape[2] != k.shape[2]:     # expanded layout
        k, v = _expand_kv_for_tp(cfg, k, v)
    b, s = k.shape[0], k.shape[1]
    rows = slice(slot, slot + b)
    if cfg.kv_cache_dtype == "int8":
        # quantize the zero-padded row, as the reference does: the pad
        # positions then carry the same (tiny) scale as there
        cache_len = cache_entry["k"].shape[1]
        for name, t in (("k", k), ("v", v)):
            padded = torch.zeros((b, cache_len) + t.shape[2:],
                                 dtype=t.dtype, device=t.device)
            padded[:, :s] = t
            tq, ts = quantize_kv(padded)
            cache_entry[name][rows] = tq
            cache_entry[name + "_scale"][rows] = ts
    else:
        for name, t in (("k", k), ("v", v)):
            cache_entry[name][rows, :s] = t
            cache_entry[name][rows, s:] = 0
    return _out_proj(out, p)


def _write_token(cache: torch.Tensor, new: torch.Tensor,
                 position: torch.Tensor):
    """cache[b, position[b]] = new[b] in place, for every row whose
    position is inside the cache.  A position at or past the cache's end
    writes nothing and raises nothing: the reference's one-hot scatter is
    all zeros there, so the new K/V is dropped (no host sync either)."""
    s_max = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = position.clamp(max=s_max - 1).long()
    keep = (position < s_max).view((-1,) + (1,) * (new.dim() - 1))
    cache[rows, idx] = torch.where(keep, new.to(cache.dtype),
                                   cache[rows, idx])


def self_attention_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                          position: torch.Tensor,
                          cache_entry: Dict) -> torch.Tensor:
    """Single-token decode.  x [B,1,d]; position [B] absolute position of
    the new token; cache_entry = {k, v [B,S,KV,hd]} (+ int8 scales) with
    S = cache_len, updated in place.  Attention runs through the decode
    kernel with kv_len = position + 1, which may exceed S.

    An int8 cache goes to the kernel as it is, with its bf16 scales: the
    kernel dequantizes in f32 and rounds its output to bf16, as the
    Pallas kernel's int8 mode does.  (The reference's model dequantizes
    to bf16 before attention instead, ``attention.py:233-240``, so the
    two may differ in the last bf16 bit of a cached value.)"""
    q, k_new, v_new = project_qkv(p, cfg, x, position[:, None])
    if cache_entry["k"].shape[2] != k_new.shape[2]:  # expanded layout
        k_new, v_new = _expand_kv_for_tp(cfg, k_new, v_new)
    kv_len = (position + 1).to(torch.int32)
    if cfg.kv_cache_dtype == "int8":
        for name, t in (("k", k_new), ("v", v_new)):
            tq, ts = quantize_kv(t)
            _write_token(cache_entry[name], tq[:, 0], position)
            _write_token(cache_entry[name + "_scale"], ts[:, 0], position)
        out = da_ops.decode_attention(
            q, cache_entry["k"], cache_entry["v"], kv_len,
            k_scale=cache_entry["k_scale"], v_scale=cache_entry["v_scale"])
    else:
        _write_token(cache_entry["k"], k_new[:, 0], position)
        _write_token(cache_entry["v"], v_new[:, 0], position)
        out = da_ops.decode_attention(q, cache_entry["k"],
                                      cache_entry["v"], kv_len)
    return _out_proj(out, p)


# ---------------------------------------------------------------------------
# Cross attention (llama-3.2-vision style gated cross-attention layers)
# ---------------------------------------------------------------------------

CROSS_BLOCK_Q = 512


def cross_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                    vis_kv: Dict) -> torch.Tensor:
    """x [B,S,d] attends, unmasked, over the fixed vision K/V
    [B,Tv,KV,hd].  Plain PyTorch, as in the reference, which reaches no
    kernel here.  One path for every S: ``gqa_core`` in f32, in blocks of
    512 query rows above 1024 (rows are independent, so the blocking
    changes no value).  The reference switches to ``gqa_blocked`` above
    1024 rows, whose bf16 operands and bf16 softmax weights differ from
    this path by bf16 rounding in a bf16 model; in f32 both branches
    agree with it within 1e-4."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    s = q.shape[1]
    step = CROSS_BLOCK_Q if s > 1024 else s
    out = torch.cat([gqa_core(q[:, i:i + step], vis_kv["k"], vis_kv["v"],
                              None) for i in range(0, s, step)], dim=1)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def vision_kv(p: Dict, cfg: ModelConfig, vis: torch.Tensor) -> Dict:
    """Project the (projected, stub) vision embeddings [B,Tv,d] to the
    cross layer's K/V once."""
    k = torch.einsum("btd,dhk->bthk", vis, p["wk"])
    v = torch.einsum("btd,dhk->bthk", vis, p["wv"])
    return {"k": k, "v": v}
