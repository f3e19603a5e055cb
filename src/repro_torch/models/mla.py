"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3; PyTorch twin of
``repro.models.mla``).

Prefill runs the standard decompressed attention (f32 scores, ``-1e30``
mask, blocked over q above 1024 tokens); decode runs the *absorbed* path
over the compressed ``{ckv [B,S,kv_lora], kr [B,S,rope]}`` cache, so a
step reads O(S * (kv_lora + rope)) of cache.  Neither reaches a kernel:
the reference's MLA is plain jnp.

Cache writes go in place, as ``models/attention.py`` does: prefill writes
rows ``slot:slot+B`` (positions ``:S``, the rest of each row zeroed);
decode writes position ``pos`` of every row, and drops the write for a
row whose position is past the cache's end.  The reference's blocked
prefill needs ``S % 512 == 0`` above 1024 tokens; here the last block is
ragged, so any S is served.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.kernels.plain import NEG_INF
from repro_torch.models import ops
from repro_torch.models.attention import _write_token

_BLOCKED_THRESHOLD = 1024
BLOCK_Q = 512


def _project_q(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor):
    m = cfg.mla
    q_lat = ops.rmsnorm(x @ p["wq_a"], p["q_norm_a"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", q_lat, p["wq_b"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = ops.apply_rope(q[..., m.qk_nope_head_dim:], positions,
                            cfg.rope_theta)
    return q_nope, q_rope


def _project_kv_latent(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor):
    """Compressed latent ckv [B,S,r] and the one shared rotary key
    [B,S,rope] (split-half RoPE over the rope dims only)."""
    m = cfg.mla
    lat = x @ p["wkv_a"]
    ckv = ops.rmsnorm(lat[..., :m.kv_lora_rank], p["kv_norm_a"],
                      cfg.norm_eps)
    k_rope = ops.apply_rope(lat[..., None, m.kv_lora_rank:], positions,
                            cfg.rope_theta)[..., 0, :]
    return ckv, k_rope


def _scale(cfg: ModelConfig) -> float:
    m = cfg.mla
    return 1.0 / math.sqrt(float(m.qk_nope_head_dim + m.qk_rope_head_dim))


def _attend(p: Dict, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor):
    """Decompressed causal attention over x [B,S,d] -> (out [B,S,d], ckv
    [B,S,r], k_rope [B,S,rope])."""
    m = cfg.mla
    b, s, _ = x.shape
    q_nope, q_rope = _project_q(p, cfg, x, positions)
    ckv, k_rope = _project_kv_latent(p, cfg, x, positions)
    kv = torch.einsum("bsr,rhk->bshk", ckv, p["wkv_b"])
    kn_f = kv[..., :m.qk_nope_head_dim].float()
    v_f = kv[..., m.qk_nope_head_dim:].float()
    kr_f = k_rope.float()
    scale = _scale(cfg)
    kv_pos = torch.arange(s, device=x.device)

    def attend(start: int, stop: int) -> torch.Tensor:
        sc = (torch.einsum("bqhk,bshk->bhqs",
                           q_nope[:, start:stop].float(), kn_f)
              + torch.einsum("bqhk,bsk->bhqs",
                             q_rope[:, start:stop].float(), kr_f)) * scale
        q_pos = torch.arange(start, stop, device=x.device)
        sc = sc.masked_fill(kv_pos[None, :] > q_pos[:, None], NEG_INF)
        w = torch.softmax(sc, dim=-1)
        return torch.einsum("bhqs,bshv->bqhv", w, v_f).to(x.dtype)

    # blocked over q so scores never exceed [B,H,512,S]; the last block
    # may be ragged
    step = BLOCK_Q if s > _BLOCKED_THRESHOLD else s
    o = torch.cat([attend(i, min(i + step, s)) for i in range(0, s, step)],
                  dim=1)
    return torch.einsum("bshv,hvd->bsd", o, p["wo"]), ckv, k_rope


def mla_train(p: Dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """``mla_prefill`` without the cache (the reference's ``mla_train``):
    [B,S,d] -> [B,S,d], blocked over q above 1024 tokens."""
    return _attend(p, cfg, x, positions)[0]


def mla_prefill(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, cache_entry: Dict,
                slot: int = 0) -> torch.Tensor:
    """Decompressed causal attention over x [B,S,d]; the latents go into
    rows ``slot:slot+B`` of ``cache_entry`` in place.  Returns [B,S,d]."""
    out, ckv, k_rope = _attend(p, cfg, x, positions)
    b, s = x.shape[0], x.shape[1]
    rows = slice(slot, slot + b)
    for name, t in (("ckv", ckv), ("kr", k_rope)):
        cache_entry[name][rows, :s] = t
        cache_entry[name][rows, s:] = 0
    return out


def mla_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               position: torch.Tensor, cache_entry: Dict) -> torch.Tensor:
    """Absorbed single-token decode.  x [B,1,d]; position [B]; the new
    latent is written at ``position`` in place (dropped past the cache's
    end), then scores and values are taken in the latent space over every
    cached position ``<= position``.  Returns [B,1,d]."""
    m = cfg.mla
    ckv_cache, kr_cache = cache_entry["ckv"], cache_entry["kr"]
    s_max = ckv_cache.shape[1]
    pos = position[:, None]
    q_nope, q_rope = _project_q(p, cfg, x, pos)              # [B,1,H,*]
    ckv_new, kr_new = _project_kv_latent(p, cfg, x, pos)
    _write_token(ckv_cache, ckv_new[:, 0], position)
    _write_token(kr_cache, kr_new[:, 0], position)
    # absorb W_kv_b's key part into q: q_lat [B,1,H,r]
    wkb_k = p["wkv_b"][..., :m.qk_nope_head_dim]             # [r,H,nope]
    q_lat = torch.einsum("bqhk,rhk->bqhr", q_nope, wkb_k)
    ckv_f = ckv_cache.float()
    scores = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), ckv_f)
              + torch.einsum("bqhk,bsk->bhqs", q_rope.float(),
                             kr_cache.float())) * _scale(cfg)
    kv_pos = torch.arange(s_max, device=x.device)[None, None, None, :]
    scores = scores.masked_fill(kv_pos > position[:, None, None, None],
                                NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bqhr", w, ckv_f)          # [B,1,H,r]
    wkb_v = p["wkv_b"][..., m.qk_nope_head_dim:]             # [r,H,v]
    o = torch.einsum("bqhr,rhv->bqhv", o_lat.to(x.dtype), wkb_v)
    return torch.einsum("bshv,hvd->bsd", o, p["wo"])
