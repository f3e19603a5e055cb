"""Mixture-of-Experts layer: routed top-k experts plus optional shared
experts (PyTorch twin of ``repro.models.moe``).

Four implementations, each returning ``(y, aux)`` as the reference's do:

  dense   -- every expert on every token, gate-combined over all E (the
             oracle).
  ragged  -- (token, expert) pairs sorted by expert, the group offsets
             computed on the device, then each group through its expert
             (``kernels/grouped_ffn``): the counterpart of
             ``jax.lax.ragged_dot``.  On the card two hand-written grouped
             launches, which read the offsets there (no host read), and
             their hand-written backward under autograd; on the CPU the
             kernels' plain version, a loop over the groups.
  gather  -- the tiny-batch path: every expert on the call's few rows,
             then each token takes and combines its top-k outputs (no
             weight copies, no host sync).
  ep      -- expert parallelism over the parallel context's mesh
             (:func:`moe_ep`): capacity-bounded all-to-all dispatch and
             combine over the EP process group, the local experts on the
             grouped path, and the TP split of ``f`` reduced
             with one all-reduce over the model group a layer.

``moe_layer`` dispatches as the reference does: ``ep`` runs ``moe_ep``
under a context with a mesh and ``ragged`` without one.  On the ``meta``
device (the dry-run) ``ragged`` takes ``dense``'s shapes and ``moe_ep``
its static capacity shapes, with no host read.  Expert storage
may hold R replicas of each expert (``params._expert_storage``); the
non-EP paths read one copy of each (:func:`_unique_experts`).  Routing is
the reference's: f32 logits from an f32 router, softmax before top-k,
weights renormalised by ``max(sum, 1e-9)``, and ties broken to the lower
expert index, as ``jax.lax.top_k`` breaks them.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import context as dist_ctx
from repro_torch.kernels.grouped_ffn import ops as gffn
from repro_torch.models import ops
from repro_torch.serving import trace as tr_lib

#: ``moe_ep`` calls since the last reset, and the (token, expert) pairs
#: they dropped past capacity
ep_calls = 0
ep_dropped = 0


def _router(p: Dict, x: torch.Tensor, cfg: ModelConfig):
    """x [T,d] -> (probs [T,E] f32, topk_idx [T,k], topk_w [T,k] f32)."""
    with tr_lib.span("repro.moe.gate"):
        logits = x.float() @ p["router"].float()
        probs = torch.softmax(logits, dim=-1)
        # a stable descending sort keeps the lower index first among equal
        # probabilities (torch.topk promises no order among ties)
        topk_w, topk_idx = torch.sort(probs, dim=-1, descending=True,
                                      stable=True)
        topk_w = topk_w[:, :cfg.moe.top_k]
        topk_idx = topk_idx[:, :cfg.moe.top_k]
        topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True),
                                      min=1e-9)
        return probs, topk_idx, topk_w


def aux_loss(probs: torch.Tensor, topk_idx: torch.Tensor,
             n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    with tr_lib.span("repro.moe.aux"):
        sel = torch.nn.functional.one_hot(topk_idx, n_experts).float()
        f = torch.mean(torch.sum(sel, dim=1), dim=0)  # fraction routed * k
        p_mean = torch.mean(probs, dim=0)
        return n_experts * torch.sum(f * p_mean) / topk_idx.shape[1]


def _unique_experts(p: Dict, cfg: ModelConfig) -> Dict:
    """The routed weights with EP replication stripped (one copy of each
    expert, ``w[::R]``), for the non-EP paths."""
    e = cfg.moe.n_experts
    return {k: w if w.shape[0] == e else w[::w.shape[0] // e]
            for k, w in p.items()}


def _all_experts(p: Dict, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """Every expert on every row: x [T,d] -> [E,T,d], one batched matmul
    over the stacked experts a weight matrix (``[E,T,d] @ [E,d,f]``), so
    each expert's weights are read once and never copied."""
    act = ops.activation(cfg.activation)
    with tr_lib.span("repro.moe.experts"):
        xe = x[None].expand(p["w_up"].shape[0], -1, -1)
        h = xe @ p["w_up"]
        if cfg.gated_mlp:
            h = act(xe @ p["w_gate"]) * h
        else:
            h = act(h)
        return h @ p["w_down"]


def moe_dense(p: Dict, cfg: ModelConfig, x_flat: torch.Tensor):
    probs, topk_idx, topk_w = _router(p, x_flat, cfg)
    y_all = _all_experts(_unique_experts(p["routed"], cfg), cfg,
                         x_flat)                             # [E,T,d]
    with tr_lib.span("repro.moe.combine"):
        comb = torch.zeros(probs.shape, dtype=torch.float32,
                           device=x_flat.device)
        comb.scatter_(1, topk_idx, topk_w)
        y = torch.einsum("te,etd->td", comb.to(x_flat.dtype), y_all)
    return y, aux_loss(probs, topk_idx, cfg.moe.n_experts)


def _expert_ffn(p: Dict, cfg: ModelConfig, e: int,
                x: torch.Tensor) -> torch.Tensor:
    """Expert e on its rows x [n,d] -> [n,d]."""
    act = ops.activation(cfg.activation)
    h = x @ p["w_up"][e]
    if cfg.gated_mlp:
        h = act(x @ p["w_gate"][e]) * h
    else:
        h = act(h)
    return h @ p["w_down"][e]


def _ragged_experts(p: Dict, cfg: ModelConfig, x_sorted: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """The sorted rows through their experts, grouped by ``offsets``
    [E+1] (int32, on the rows' device): ``grouped_ffn``."""
    with tr_lib.span("repro.moe.experts"):
        return gffn.grouped_ffn(x_sorted, offsets, p["w_up"],
                                p.get("w_gate") if cfg.gated_mlp else None,
                                p["w_down"], cfg.activation)


def moe_ragged(p: Dict, cfg: ModelConfig, x_flat: torch.Tensor):
    """Sort by expert, each group through its expert (exact FLOPs).  The
    group offsets come from the sorted expert ids on the device
    (``searchsorted``), so the dispatch reads nothing to the host.  The
    weighted combine casts ``topk_w`` to the experts' output dtype
    before the k-sum, as the reference does."""
    m = cfg.moe
    t = x_flat.shape[0]
    probs, topk_idx, topk_w = _router(p, x_flat, cfg)
    with tr_lib.span("repro.moe.dispatch"):
        # pair i is token i // k's choice; a stable sort keeps each
        # expert's pairs in token order
        sorted_expert, order = torch.sort(topk_idx.reshape(-1), stable=True)
        x_sorted = x_flat[order // m.top_k]
        offsets = torch.searchsorted(
            sorted_expert, torch.arange(m.n_experts + 1,
                                        device=x_flat.device),
            out_int32=True)
    y_sorted = _ragged_experts(_unique_experts(p["routed"], cfg), cfg,
                               x_sorted, offsets)
    with tr_lib.span("repro.moe.combine"):
        y_pairs = torch.empty_like(y_sorted)
        y_pairs[order] = y_sorted                            # unsort
        y = _combine(y_pairs.reshape(t, m.top_k, -1), topk_w, x_flat.dtype)
    return y, aux_loss(probs, topk_idx, m.n_experts)


def _combine(y_pairs: torch.Tensor, topk_w: torch.Tensor, dtype):
    """Each token's k expert outputs [T,k,d] weighted and summed."""
    y = torch.sum(y_pairs * topk_w[..., None].to(y_pairs.dtype), dim=1)
    return y.to(dtype)


# ---------------------------------------------------------------------------
# Expert-parallel path (all-to-all over the EP process group)
# ---------------------------------------------------------------------------

def _local_weight(w: torch.Tensor, spec, axes, coords) -> torch.Tensor:
    """This rank's block of a routed weight: a DTensor's local tensor
    (placed as ``spec`` says), or the block of a full tensor (``axes``:
    the mesh's (names, sizes); ``coords``: this rank's coordinates).
    A DTensor is told by its ``placements``, so that the path with full
    tensors never imports ``torch.distributed.tensor``."""
    from repro_torch.distributed.sharding import local_shard, placements
    if getattr(w, "placements", None) is not None:      # a DTensor
        if tuple(w.placements) != tuple(placements(spec, axes)):
            raise ValueError(f"expert weight placed {w.placements}, not as "
                             f"{spec}")
        return w.to_local()
    return local_shard(w, spec, axes, coords)


def moe_ep(p: Dict, cfg: ModelConfig, x_flat: torch.Tensor):
    """Expert-parallel MoE over the parallel context's ``DeviceMesh``
    (the reference's ``moe_ep`` and its ``shard_map`` body ``_ep_local``,
    ``moe.py:129-231``), forward only.

    ``x_flat`` [T, d] is this rank's tokens: its shard of the batch over
    ``ctx.batch_axes``, the same on every rank of its model-axis group.
    The routed weights are the full stored experts ``[E_store, d, f]``
    (every rank takes its block: experts over ``ctx.ep_axes``, f over the
    model axis) or DTensors placed so.  Each (token, expert) pair goes to
    the shard that stores its expert (spread over an expert's R replicas
    by token), at most ``capacity`` pairs a destination (later pairs are
    dropped and contribute nothing); one all-to-all over the EP group
    dispatches, the shard's experts run on the grouped path
    (``grouped_ffn``) over the rows it received (empty capacity slots
    carry no expert and are skipped), one all-reduce over the model
    group sums the TP split of f, a second all-to-all returns the rows,
    and each token combines
    its k results.  The aux loss is the mean over the batch axes of each
    shard's.  Returns (y [T, d], aux); counts the call and its dropped
    pairs (``ep_calls``, ``ep_dropped``)."""
    global ep_calls, ep_dropped
    from repro_torch.launch.mesh import axis_sizes, mesh_coords
    ctx = dist_ctx.get()
    mesh = ctx.mesh
    if mesh is None:
        raise ValueError("EP MoE requires a parallel context mesh")
    if x_flat.device.type == "meta":
        return _moe_ep_meta(p, cfg, x_flat, ctx)
    if not hasattr(mesh, "get_group"):
        raise TypeError("moe_ep runs on a DeviceMesh (its process groups), "
                        f"not on {type(mesh).__name__}")
    routed = p["routed"]
    if torch.is_grad_enabled() and (x_flat.requires_grad or any(
            w.requires_grad for w in routed.values())):
        raise NotImplementedError("moe_ep runs forward only; train "
                                  "without a parallel context")
    m = cfg.moe
    e = m.n_experts
    ep_axes = tuple(ctx.ep_axes) or ("data",)
    batch_axes = tuple(ctx.batch_axes) or ep_axes
    sizes = axis_sizes(mesh)
    n_shards = math.prod(sizes[a] for a in ep_axes)
    e_store = routed["w_up"].shape[0]
    if e_store % n_shards:
        raise ValueError(f"{e_store} stored experts do not divide over "
                         f"{n_shards} EP shards")
    tp = (ctx.model_axis,) if ctx.model_axis else None
    axes, coords = (tuple(sizes), tuple(sizes.values())), mesh_coords(mesh)
    local = {name: _local_weight(w, (ep_axes, tp, None) if name == "w_down"
                                 else (ep_axes, None, tp), axes, coords)
             for name, w in routed.items()}
    e_loc = max(1, e // n_shards)           # experts a shard
    probs, topk_idx, topk_w, keep, slot, send_x, send_eid = \
        _ep_dispatch(p, cfg, x_flat, n_shards)
    ep_group = coll.axis_group(mesh, ep_axes)
    rx = coll.all_to_all(send_x[:-1], ep_group)
    reid = coll.all_to_all(send_eid[:-1], ep_group)
    order = torch.argsort(reid, stable=True)
    # bincount reads its input's min and max to the host
    with tr_lib.sync("ep_bincount"):
        counts = torch.bincount(reid, minlength=e_loc + 1)
    with tr_lib.sync("ep_sizes"):
        stats = torch.cat([counts[:e_loc], (~keep).sum().view(1)]).tolist()
    group_sizes, dropped = stats[:-1], stats[-1]
    rows = order[:sum(group_sizes)]
    offsets = torch.cumsum(counts[:e_loc], 0, dtype=torch.int32)
    y_rows = _ragged_experts(local, cfg, rx[rows],
                             torch.cat([offsets.new_zeros(1), offsets]))
    if tp is not None:
        coll.all_reduce(y_rows, "sum", coll.axis_group(mesh, tp))
    y_recv = torch.zeros_like(rx)
    y_recv[rows] = y_rows
    y_back = coll.all_to_all(y_recv, ep_group)
    with tr_lib.span("repro.moe.combine"):
        y = _ep_combine(y_back, keep, slot, topk_w, x_flat, cfg)
    batch_group = coll.axis_group(mesh, batch_axes)
    aux = coll.all_reduce(aux_loss(probs, topk_idx, e), "sum", batch_group)
    ep_calls += 1
    ep_dropped += dropped
    return y, aux / torch.distributed.get_world_size(batch_group)


def ep_capacity(t_loc: int, k: int, n_shards: int,
                capacity_factor: float) -> int:
    """(token, expert) pairs a destination shard takes from one rank
    (the reference's, ``moe.py:234-235``): the even share times the
    capacity factor, rounded up to a multiple of 8, at least 8."""
    cap = int(-(-t_loc * k // n_shards) * capacity_factor)
    return max(8, -(-cap // 8) * 8)


def _ep_dispatch(p: Dict, cfg: ModelConfig, x_flat: torch.Tensor,
                 n_shards: int):
    """``moe_ep``'s routing and send buffers: (probs, topk_idx, topk_w,
    keep, slot, send_x [n_shards*cap+1, d], send_eid), each pair at
    ``slot`` of the buffers, a dropped pair in the dump row past the
    end."""
    m = cfg.moe
    e, k = m.n_experts, m.top_k
    r = max(1, n_shards // e)               # replication factor
    e_loc = max(1, e // n_shards)           # experts a shard
    t_loc, d = x_flat.shape
    dev = x_flat.device
    probs, topk_idx, topk_w = _router(p, x_flat, cfg)
    pair_token = torch.arange(t_loc * k, device=dev) // k
    pair_expert = topk_idx.reshape(-1)
    # destination shard: an expert's R replicas take its tokens in turn
    dest = pair_expert * r + pair_token % r if r > 1 \
        else pair_expert // e_loc
    cap = ep_capacity(t_loc, k, n_shards, m.capacity_factor)
    onehot = (dest[:, None] == torch.arange(n_shards, device=dev)).long()
    pos = (torch.cumsum(onehot, 0) - onehot).gather(1, dest[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, dest * cap + pos, n_shards * cap)
    send_x = x_flat.new_zeros((n_shards * cap + 1, d))
    send_x[slot] = x_flat[pair_token]
    # a slot's local expert; e_loc marks an empty slot
    send_eid = torch.full((n_shards * cap + 1,), e_loc, dtype=torch.int64,
                          device=dev)
    send_eid[slot] = pair_expert % e_loc
    return probs, topk_idx, topk_w, keep, slot, send_x, send_eid


def _ep_combine(y_back, keep, slot, topk_w, x_flat, cfg):
    """Each pair's returned row (zero where dropped), combined by token."""
    y_pairs = torch.where(keep[:, None],
                          y_back[torch.where(keep, slot, 0)], 0)
    return _combine(y_pairs.reshape(x_flat.shape[0], cfg.moe.top_k, -1),
                    topk_w, x_flat.dtype)


def _moe_ep_meta(p: Dict, cfg: ModelConfig, x_flat: torch.Tensor, ctx):
    """``moe_ep`` on the ``meta`` device, the dry-run's program of one
    rank: the static shapes of the reference's ``_ep_local``.  ``x_flat``
    is the rank's tokens and the routed weights its block (``E_store /
    shards`` experts, its share of f; a full stored tensor is cut to rank
    0's block).  The dispatch and combine run as above; the expert FFN
    runs once over every received row (``n_shards * cap``: the group
    sizes are data, and the reference's grouped product spans all the
    capacity slots); the two all-to-alls go through
    ``distributed.collectives``, which on meta records their bytes and
    moves nothing.  The model axis's all-reduce of the TP split is left
    to the dry-run's collective model.  Works under autograd."""
    from repro_torch.distributed.sharding import local_shard
    from repro_torch.launch.mesh import axis_sizes
    ep_axes = tuple(ctx.ep_axes) or ("data",)
    sizes = axis_sizes(ctx.mesh)
    n_shards = math.prod(sizes[a] for a in ep_axes)
    routed = p["routed"]
    e_store = max(cfg.moe.n_experts, n_shards)     # _expert_storage's
    if routed["w_up"].shape[0] == e_store and n_shards > 1:
        axes = (tuple(sizes), tuple(sizes.values()))
        zero = dict.fromkeys(sizes, 0)
        routed = {name: local_shard(w, (ep_axes, None, None), axes, zero)
                  for name, w in routed.items()}
    probs, topk_idx, topk_w, keep, slot, send_x, send_eid = \
        _ep_dispatch(p, cfg, x_flat, n_shards)
    rx = coll.all_to_all(send_x[:-1])
    coll.all_to_all(send_eid[:-1])
    y_rows = _expert_ffn(routed, cfg, 0, rx)
    y_back = coll.all_to_all(y_rows)
    y = _ep_combine(y_back, keep, slot, topk_w, x_flat, cfg)
    return y, aux_loss(probs, topk_idx, cfg.moe.n_experts)


def moe_gather(p: Dict, cfg: ModelConfig, x_flat: torch.Tensor):
    """Tiny-batch path (the engine's gang decode of 8 slots): every
    expert runs on the call's few rows (``_all_experts``), and each row
    takes its top-k experts' outputs and combines them as the reference
    does.  The reference gathers ``[T,k,d,f]`` copies of the chosen
    experts' weights instead; each selected (row, expert) pair's math is
    the same, but here no weight is copied and no host sync is taken
    (``chip_smoke.py`` phase 9c times both ways on the card: at
    deepseek-moe-16b's 8-row decode the copies alone cost several times
    this path)."""
    probs, topk_idx, topk_w = _router(p, x_flat, cfg)
    y_all = _all_experts(_unique_experts(p["routed"], cfg), cfg,
                         x_flat)                             # [E,T,d]
    with tr_lib.span("repro.moe.combine"):
        rows = torch.arange(x_flat.shape[0], device=x_flat.device)
        y = y_all[topk_idx, rows[:, None]]                   # [T,k,d]
        y = _combine(y, topk_w, x_flat.dtype)
    return y, aux_loss(probs, topk_idx, cfg.moe.n_experts)


#: the single-device implementations
IMPLS = {"dense": moe_dense, "ragged": moe_ragged, "gather": moe_gather}


def moe_layer(p: Dict, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full MoE block.  x [B,S,d] -> (y [B,S,d], aux_loss scalar).

    The reference's dispatch (``moe.py:259-291``): ``ep`` runs
    :func:`moe_ep` under a parallel context with a mesh, ``gather`` where
    the tokens do not divide over the batch shards or are fewer than
    they, and ``ragged`` without a mesh; any other impl on 8 tokens or
    fewer runs ``gather`` (the engine's gang decode of 8 slots)."""
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.models.model import ffn_forward
    m = cfg.moe
    shape = x.shape
    x_flat = x.reshape(-1, shape[-1])
    t = x_flat.shape[0]
    impl = m.impl
    if impl == "ep":
        ctx = dist_ctx.get()
        if ctx.mesh is None:
            impl = "ragged"
        elif x.device.type != "meta":
            # on meta x is one rank's tokens (the dry-run's program), for
            # which the dry-run has applied this rule to the global batch
            sizes = axis_sizes(ctx.mesh)
            shards = math.prod(sizes[a] for a in (ctx.batch_axes
                                                  or ctx.ep_axes))
            if t % shards != 0 or t < shards:
                impl = "gather"     # e.g. single-token long-context decode
    if t <= 8 and impl != "ep":
        impl = "gather"
    if impl == "ragged" and x.device.type == "meta":
        impl = "dense"      # ragged's group sizes are data; dense's shapes
    if impl == "ep":
        y, aux = moe_ep(p, cfg, x_flat)
    elif impl in IMPLS:
        y, aux = IMPLS[impl](p, cfg, x_flat)
    else:
        raise ValueError(impl)
    if m.n_shared:
        with tr_lib.span("repro.moe.shared"):
            y = y + ffn_forward(p["shared"], cfg, x_flat)
    return y.reshape(shape), aux
