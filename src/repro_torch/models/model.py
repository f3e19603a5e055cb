"""Model assembly for every family of the model zoo (PyTorch twin of
``repro.models.model``): GQA or MLA attention, Mamba-1 and gated
cross-attention layers, dense or MoE feed-forward blocks, a dense first
layer, and token or embedding inputs.

Three entry points: ``forward_train`` (and ``forward_hidden`` /
``loss_fn`` for the LM loss) and two serving ones, the latter with the
reference's cache layout
(``layers[pos][name]`` with a leading ``n_periods`` axis: ``k``/``v``
``[n, B, cache_len, KV, hd]`` for attention layers, ``ckv``
``[n, B, cache_len, kv_lora]`` and ``kr`` ``[n, B, cache_len, rope]`` for
MLA layers, ``k``/``v`` ``[n, B, vision_tokens, KV, hd]`` for cross
layers, ``conv`` ``[n, B, d_conv-1, d_inner]`` and ``ssm``
``[n, B, d_inner, d_state]`` for mamba layers; ``first_layer`` without
the ``n`` axis; plus ``pos [B]``):

  prefill(params, cfg, tokens, cache_len, cache=None, slot=0,
          embeds=None, vision=None) -> (last_logits [B,V], cache)
  decode_step(params, cfg, cache, tokens=None, embeds=None)
      -> (logits [B,V], cache)
  forward_train(params, cfg, tokens=None, embeds=None, vision=None,
                positions=None) -> (logits [B,S,V], aux)
  loss_fn(params, cfg, batch) -> (loss, {"lm_loss", "moe_aux"})

PyTorch runs eagerly, so the stacked layers are walked with a Python loop
instead of ``lax.scan``.  Caches are updated in place: prefill writes the
prompt's K/V, latents, vision K/V and SSM states straight into rows
``slot:slot+B`` of a caller's cache (the engine's slot insert), where the
reference builds a padded cache and copies it in.

Training differentiates through the stacked parameters themselves: a
layer reads views of the ``n_periods``-stacked leaves, so every leaf's
``.grad`` has the reference's shape.  ``cfg.remat`` wraps each period of
the stack in ``torch.utils.checkpoint`` (non-reentrant), where the
reference has ``jax.checkpoint(body, nothing_saveable)``: only the
period's input is kept and its activations are recomputed in the
backward.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ops
from repro_torch.models.params import torch_dtype
from repro_torch.serving import trace as tr_lib


def ffn_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = ops.activation(cfg.activation)
    h = x @ p["w_up"]
    if cfg.gated_mlp:
        h = act(x @ p["w_gate"]) * h
    else:
        h = act(h)
    return h @ p["w_down"]


def cache_kv_heads(cfg: ModelConfig) -> int:
    """KV-head count as stored in the decode cache (the reference's,
    ``model.py:38-48``).  When KV does not divide the parallel context's
    model axis but H does, the cache stores the EXPANDED heads (full H,
    each KV head repeated H / KV times): sharded over "model", a rank's
    slice is smaller than a replicated cache, and no per-step gather of
    the whole cache is needed.  Without a model axis, KV."""
    from repro_torch.distributed import context as dist_ctx
    tp = dist_ctx.tp_size()
    if tp > 1 and cfg.n_kv_heads % tp != 0 and cfg.n_heads % tp == 0:
        return cfg.n_heads
    return cfg.n_kv_heads


def _empty_entry(cfg: ModelConfig, kind: str, lead: tuple, batch: int,
                 cache_len: int, dev) -> Dict[str, torch.Tensor]:
    """One layer kind's zero cache (int8 caches: zero values, unit
    scales); ``lead`` is ``(n_periods,)`` or ``()``."""
    dtype = torch_dtype(cfg.dtype)
    kv, hd = cache_kv_heads(cfg), cfg.head_dim

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + (batch,) + shape, dtype=dt, device=dev)
    if kind == "mamba":
        m = cfg.mamba
        return {"conv": zeros(m.d_conv - 1, m.d_inner),
                "ssm": zeros(m.d_inner, m.d_state)}
    if kind == "cross":
        return {"k": zeros(cfg.vision_tokens, kv, hd),
                "v": zeros(cfg.vision_tokens, kv, hd)}
    if cfg.attention == "mla":
        m = cfg.mla
        return {"ckv": zeros(cache_len, m.kv_lora_rank),
                "kr": zeros(cache_len, m.qk_rope_head_dim)}
    if cfg.kv_cache_dtype == "int8":
        ones = torch.ones(lead + (batch, cache_len, kv),
                          dtype=torch.bfloat16, device=dev)
        return {"k": zeros(cache_len, kv, hd, dt=torch.int8),
                "v": zeros(cache_len, kv, hd, dt=torch.int8),
                "k_scale": ones, "v_scale": ones.clone()}
    return {"k": zeros(cache_len, kv, hd), "v": zeros(cache_len, kv, hd)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> Dict[str, Any]:
    """Zero-filled decode cache in the reference's layout."""
    dev = resolve_device(device)
    cache: Dict[str, Any] = {
        "layers": [_empty_entry(cfg, cfg.layer_kind(pos), (cfg.n_periods,),
                                batch, cache_len, dev)
                   for pos in range(cfg.period)],
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.dense_first_layer:
        cache["first_layer"] = _empty_entry(cfg, "attn", (), batch,
                                            cache_len, dev)
    return cache


def _index(tree, i: int):
    """Layer i of a stacked tree (views, so cache writes land in place)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _mamba(p: Dict, cfg: ModelConfig, h: torch.Tensor, mode: str,
           entry: Dict, slot: int) -> torch.Tensor:
    """A mamba layer; its conv and SSM states are written in place into
    rows ``slot:slot+B`` (prefill) or all rows (decode) of ``entry``
    (training keeps none)."""
    if mode == "train":
        return mamba_mod.mamba_train(p, cfg, h)
    if mode == "prefill":
        y, states = mamba_mod.mamba_seq(p, cfg, h)
        rows = slice(slot, slot + h.shape[0])
    else:
        y, states = mamba_mod.mamba_decode(p, cfg, h, entry)
        rows = slice(None)
    for name, t in states.items():
        entry[name][rows] = t
    return y


def _cross(p: Dict, cfg: ModelConfig, h: torch.Tensor, mode: str,
           entry: Dict, vis: Optional[torch.Tensor], slot: int):
    """A cross layer's attention: prefill projects the vision K/V once and
    writes it into rows ``slot:slot+B``; decode reads it back; training
    projects it and keeps nothing."""
    if mode == "decode":
        vis_kv = entry
    else:
        if vis is None:
            raise ValueError(f"{cfg.name}: a cross-attention layer needs "
                             f"vision inputs at {mode}")
        vis_kv = attn.vision_kv(p["attn"], cfg, vis)
        if mode == "prefill":
            k, v = vis_kv["k"], vis_kv["v"]
            if entry["k"].shape[2] != k.shape[2]:   # expanded layout
                k, v = attn._expand_kv_for_tp(cfg, k, v)
            entry["k"][slot:slot + h.shape[0]] = k
            entry["v"][slot:slot + h.shape[0]] = v
    return attn.cross_attention(p["attn"], cfg, h, vis_kv)


def _gate(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return y * torch.tanh(g.float()).to(y.dtype)


def _layer(p: Dict, cfg: ModelConfig, pos: int, x: torch.Tensor,
           positions: torch.Tensor, mode: str, entry: Optional[Dict],
           vis: Optional[torch.Tensor], slot: int
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer (the reference's ``_layer``, ``model.py:99-153``),
    its cache entry updated in place (``mode`` "prefill" or "decode";
    "train" has none).  Returns (x, the MoE aux loss or None)."""
    kind = cfg.layer_kind(pos)
    with tr_lib.span("repro.model.mamba" if kind == "mamba"
                     else "repro.model.attn"):
        h = ops.rmsnorm(x, p["ln1"], cfg.norm_eps)
        if kind == "mamba":
            y = _mamba(p["mamba"], cfg, h, mode, entry, slot)
        elif kind == "cross":
            y = _gate(_cross(p, cfg, h, mode, entry, vis, slot),
                      p["gate_attn"])
        elif cfg.attention == "mla":
            if mode == "train":
                y = mla_mod.mla_train(p["attn"], cfg, h, positions)
            elif mode == "prefill":
                y = mla_mod.mla_prefill(p["attn"], cfg, h, positions, entry,
                                        slot)
            else:
                y = mla_mod.mla_decode(p["attn"], cfg, h, positions, entry)
        elif mode == "train":
            y = attn.self_attention_train(p["attn"], cfg, h, positions)
        elif mode == "prefill":
            y = attn.self_attention_prefill(p["attn"], cfg, h, positions,
                                            entry, slot)
        else:
            y = attn.self_attention_decode(p["attn"], cfg, h, positions,
                                           entry)
        x = x + y
    aux = None
    if "ln2" in p:
        with tr_lib.span("repro.model.ffn"):
            h2 = ops.rmsnorm(x, p["ln2"], cfg.norm_eps)
            if "moe" in p:
                y2, aux = moe_mod.moe_layer(p["moe"], cfg, h2)
            else:
                y2 = ffn_forward(p["ffn"], cfg, h2)
            if kind == "cross":
                y2 = _gate(y2, p["gate_ffn"])
            x = x + y2
    return x, aux


def _period(layers, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor, mode: str, entries,
            vis: Optional[torch.Tensor], slot: int):
    """One period of the stack: (x, the MoE aux loss of the period's
    LAST layer, f32).  The reference's scan carry adds only the aux of
    the layer its period loop ran last (``model.py:192-203``), so a
    period whose MoE layers are not last (jamba's 1, 3, 5 of 8) adds
    theirs nowhere; the port keeps that sum, so that its loss and
    gradients are the reference's."""
    aux = None
    for pos in range(cfg.period):
        x, aux = _layer(layers[pos], cfg, pos, x, positions, mode,
                        None if entries is None else entries[pos], vis,
                        slot)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def _run_stack(params: Dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, mode: str, cache: Optional[Dict],
               vis: Optional[torch.Tensor] = None, slot: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense first layer (if any), then the periodic stack; in train
    mode (``cache`` None) each period under ``torch.utils.checkpoint``
    when ``cfg.remat``.  Returns (x, the MoE aux loss summed as the
    reference sums it, f32; see :func:`_period`)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.dense_first_layer:
        x, aux = _layer(params["first_layer"], cfg, 0, x, positions, mode,
                        None if cache is None else cache["first_layer"],
                        vis, slot)
        if aux is not None:
            aux_total = aux_total + aux
    remat = cfg.remat and mode == "train"
    for i in range(cfg.n_periods):
        layers = [_index(lp, i) for lp in params["layers"]]
        entries = None if cache is None else [
            _index(e, i) for e in cache["layers"]]
        args = (layers, cfg, x, positions, mode, entries, vis, slot)
        if remat:
            x, aux = checkpoint(_period, *args, use_reentrant=False)
        else:
            x, aux = _period(*args)
        aux_total = aux_total + aux
    return x, aux_total


def _embed(params: Dict, cfg: ModelConfig, tokens: Optional[torch.Tensor],
           embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    if cfg.input_mode != "tokens":
        return embeds.to(torch_dtype(cfg.dtype))
    x = params["embed"][tokens]
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(float(cfg.d_model)),
                             dtype=torch.float32).to(x.dtype)
    return x


def _head(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    with tr_lib.span("repro.model.head"):
        x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings and cfg.input_mode == "tokens":
            logits = x @ params["embed"].T
        else:
            logits = x @ params["lm_head"]
        return ops.softcap(logits, cfg.logit_softcap)


def _cache_len(cfg: ModelConfig, cache: Dict) -> Optional[int]:
    """The positions a cache holds: read from a self-attention or MLA
    entry, the first layer's included (a cross entry's length is the
    image's, and an SSM state takes any prompt); None for a cache with no
    such entry."""
    if "first_layer" in cache:
        e, axis = cache["first_layer"], 1
    else:
        kv = [e for pos, e in enumerate(cache["layers"])
              if cfg.layer_kind(pos) == "attn"]
        if not kv:
            return None
        e, axis = kv[0], 2
    return e["ckv" if "ckv" in e else "k"].shape[axis]


def prefill(params: Dict, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None, cache_len: int = 0,
            cache: Optional[Dict] = None, slot: int = 0,
            embeds: Optional[torch.Tensor] = None,
            vision: Optional[torch.Tensor] = None):
    """Process the prompt -- tokens [B,S], or ``embeds`` [B,S,d] for
    ``input_mode="embeddings"`` -- and write its cache; ``vision``
    [B,Tv,vision_dim] feeds the cross-attention layers.

    With ``cache=None`` a fresh cache of ``cache_len`` positions (default
    ``cfg.max_seq_len``) and batch B is made on the inputs' device;
    otherwise rows ``slot:slot+B`` of ``cache`` are overwritten in place
    (their ``pos`` included).  Returns (last_token_logits [B,V], cache)."""
    x = _embed(params, cfg, tokens, embeds)
    b, s = x.shape[0], x.shape[1]
    if cache is None:
        cache = init_cache(cfg, b, cache_len or cfg.max_seq_len,
                           device=x.device)
    held = _cache_len(cfg, cache)
    if held is not None and s > held:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of "
                         f"{held}")
    vis = None
    if vision is not None and "vision_proj" in params:
        vis = vision.to(x.dtype) @ params["vision_proj"]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x, _ = _run_stack(params, cfg, x, positions, "prefill", cache, vis,
                      slot)
    cache["pos"][slot:slot + b] = s
    return _head(params, cfg, x[:, s - 1:])[:, 0], cache


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None):
    """One decode step for the whole batch: tokens [B] (or embeds
    [B,1,d]).  Every row advances, as in the reference's gang decode:
    ``pos`` grows by one even for rows that serve no request.  Returns
    (logits [B,V], cache), the cache updated in place."""
    x = _embed(params, cfg, None if tokens is None else tokens[:, None],
               embeds)
    positions = cache["pos"]
    x, _ = _run_stack(params, cfg, x, positions, "decode", cache)
    cache["pos"] += 1
    return _head(params, cfg, x)[:, 0], cache


def forward_hidden(params: Dict, cfg: ModelConfig,
                   tokens: Optional[torch.Tensor] = None,
                   embeds: Optional[torch.Tensor] = None,
                   vision: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None):
    """The full-sequence forward without a cache, stopped at the
    final-normed hidden states: (hidden [B,S,d], aux)."""
    x = _embed(params, cfg, tokens, embeds)
    b, s = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    vis = None
    if vision is not None and "vision_proj" in params:
        vis = vision.to(x.dtype) @ params["vision_proj"]
    x, aux = _run_stack(params, cfg, x, positions, "train", None, vis)
    return ops.rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


def forward_train(params: Dict, cfg: ModelConfig,
                  tokens: Optional[torch.Tensor] = None,
                  embeds: Optional[torch.Tensor] = None,
                  vision: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None):
    """Full-sequence forward (no cache): (logits [B,S,V], aux)."""
    x = _embed(params, cfg, tokens, embeds)
    b, s = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    vis = None
    if vision is not None and "vision_proj" in params:
        vis = vision.to(x.dtype) @ params["vision_proj"]
    x, aux = _run_stack(params, cfg, x, positions, "train", None, vis)
    return _head(params, cfg, x), aux


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict):
    """Next-token LM loss (+ the MoE aux loss times its weight), with
    the sequence-chunked CE so the full-vocab logits never exist.
    ``batch``: labels [B,S] and tokens [B,S] or embeds [B,S,d] (+ vision).
    Returns (total, {"lm_loss", "moe_aux"})."""
    hidden, aux = forward_hidden(params, cfg, tokens=batch.get("tokens"),
                                 embeds=batch.get("embeds"),
                                 vision=batch.get("vision"))
    if cfg.tie_embeddings and cfg.input_mode == "tokens":
        w_head = params["embed"].T
    else:
        w_head = params["lm_head"]
    loss = ops.chunked_cross_entropy(hidden, w_head, batch["labels"],
                                     cfg.logit_softcap)
    total = loss
    if cfg.moe is not None:
        total = total + cfg.moe.router_aux_weight * aux
    return total, {"lm_loss": loss, "moe_aux": aux}
