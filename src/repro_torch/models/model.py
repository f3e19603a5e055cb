"""Model assembly for attention-only decoders (PyTorch twin of
``repro.models.model``).

Two serving entry points, with the reference's cache layout
(``layers[pos][name]`` of shape ``[n_periods, B, cache_len, KV, hd]``
plus ``pos [B]``):

  prefill(params, cfg, tokens, cache_len, cache=None, slot=0)
      -> (last_logits [B,V], cache)
  decode_step(params, cfg, cache, tokens) -> (logits [B,V], cache)

PyTorch runs eagerly, so the stacked layers are walked with a Python loop
instead of ``lax.scan``.  Caches are updated in place: prefill writes the
prompt straight into rows ``slot:slot+B`` of a caller's cache (the
engine's slot insert), where the reference builds a padded cache and
copies it in.  Layer kinds other than attention (mamba, mla, moe, cross)
raise NotImplementedError until a later slice of the port.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ops
from repro_torch.models.params import check_supported, torch_dtype


def ffn_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = ops.activation(cfg.activation)
    h = x @ p["w_up"]
    if cfg.gated_mlp:
        h = act(x @ p["w_gate"]) * h
    else:
        h = act(h)
    return h @ p["w_down"]


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> Dict[str, Any]:
    """Zero-filled decode cache (int8 caches: zero values, unit scales)."""
    check_supported(cfg)
    dev = resolve_device(device)
    n, kv, hd = cfg.n_periods, cfg.n_kv_heads, cfg.head_dim
    shape = (n, batch, cache_len, kv, hd)
    layers = []
    for _ in range(cfg.period):
        if cfg.kv_cache_dtype == "int8":
            entry = {
                "k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.ones(shape[:-1], dtype=torch.bfloat16,
                                      device=dev),
                "v_scale": torch.ones(shape[:-1], dtype=torch.bfloat16,
                                      device=dev)}
        else:
            dtype = torch_dtype(cfg.dtype)
            entry = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                     "v": torch.zeros(shape, dtype=dtype, device=dev)}
        layers.append(entry)
    return {"layers": layers,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _index(tree, i: int):
    """Layer i of a stacked tree (views, so cache writes land in place)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _run_stack(params: Dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, mode: str, cache: Dict,
               slot: int = 0) -> torch.Tensor:
    for i in range(cfg.n_periods):
        for pos in range(cfg.period):
            p = _index(params["layers"][pos], i)
            entry = _index(cache["layers"][pos], i)
            h = ops.rmsnorm(x, p["ln1"], cfg.norm_eps)
            if mode == "prefill":
                y = attn.self_attention_prefill(p["attn"], cfg, h,
                                                positions, entry, slot)
            else:
                y = attn.self_attention_decode(p["attn"], cfg, h,
                                               positions, entry)
            x = x + y
            if "ln2" in p:
                h2 = ops.rmsnorm(x, p["ln2"], cfg.norm_eps)
                x = x + ffn_forward(p["ffn"], cfg, h2)
    return x


def _embed(params: Dict, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(float(cfg.d_model)),
                             dtype=torch.float32).to(x.dtype)
    return x


def _head(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    return ops.softcap(logits, cfg.logit_softcap)


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: int = 0, cache: Optional[Dict] = None,
            slot: int = 0):
    """Process the prompt tokens [B,S] and write its cache.

    With ``cache=None`` a fresh cache of ``cache_len`` positions (default
    ``cfg.max_seq_len``) and batch B is made on the tokens' device;
    otherwise rows ``slot:slot+B`` of ``cache`` are overwritten in place
    (their ``pos`` included).  Returns (last_token_logits [B,V], cache)."""
    check_supported(cfg)
    b, s = tokens.shape
    if cache is None:
        cache = init_cache(cfg, b, cache_len or cfg.max_seq_len,
                           device=tokens.device)
    cache_len = cache["layers"][0]["k"].shape[2]
    if s > cache_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of "
                         f"{cache_len}")
    x = _embed(params, cfg, tokens)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _run_stack(params, cfg, x, positions, "prefill", cache, slot)
    cache["pos"][slot:slot + b] = s
    return _head(params, cfg, x[:, s - 1:])[:, 0], cache


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor):
    """One decode step for the whole batch.  tokens [B].  Every row
    advances, as in the reference's gang decode: ``pos`` grows by one
    even for rows that serve no request.  Returns (logits [B,V], cache),
    the cache updated in place."""
    x = _embed(params, cfg, tokens[:, None])
    positions = cache["pos"]
    x = _run_stack(params, cfg, x, positions, "decode", cache)
    cache["pos"] += 1
    return _head(params, cfg, x)[:, 0], cache
