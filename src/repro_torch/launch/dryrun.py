"""Multi-pod dry-run (the port of ``repro.launch.dryrun``): per-device
memory, FLOPs, HBM bytes and collectives of every (architecture x input
shape x mesh) cell on the production meshes, and the H100 roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Artifacts: ``build/dryrun_torch/<mesh>/<arch>__<shape>.json``.

Every tensor here is on the ``meta`` device, wherever this runs: nothing is
allocated and no card is needed (there is no ``--device``), and no process
group is made.  A mesh is the ``(axis names, sizes)`` pair of
``launch.mesh.production_axes``, which the sharding rules read.

PyTorch has no compiled SPMD program to ask, so each figure is counted
from what the port has, not read from a compiler:

* Argument bytes: each leaf of the step's shape stand-ins
  (``launch.steps``: parameters, optimizer state, batch, decode cache)
  cut to one rank's block by its spec (``distributed.sharding``), summed.
* The rank's program: the step traced on meta at the local shapes the
  rules give one rank -- the batch over the data axes, heads, KV heads,
  FFN width, the MLA heads, the scan's channels and the vocabulary over
  "model" exactly where the rules cut the weights (where KV heads do not
  divide the model axis but H does, the reference's expanded heads:
  H / tp of them), experts over the EP axis at ``moe_ep``'s capacity,
  FSDP-sharded weights gathered before use, and a decode cache too long
  for its batch cut along the sequence over the data axes.  A rule that
  falls back to replication leaves that dim whole, so the rank does more
  than 1/n of the work.  The local config's parameters are checked against
  the rules' blocks leaf by leaf.  Training runs ``loss_and_grads`` on the
  gathered weights and the optimizer (AdamW, or Adafactor above 1e11
  parameters) on the rank's FSDP blocks.
* FLOPs: the products' count by ``torch.utils.flop_counter``'s formulas
  (``FlopCounterMode``'s registry, applied in this module's own dispatch
  mode, which also counts the bytes and memory below), plus each
  kernel's ``cost`` (``kernels/*/ops.py``) where the program calls it.
  Every layer is traced: no extrapolation from shallow copies (XLA's
  while-loop counting is what made the reference need it).
* HBM bytes: every dispatched op's operand and result bytes (views and
  allocations move none), an unfused upper estimate, with each kernel's
  call counted by its ``cost`` bytes instead.
* Temp bytes: the high-water mark of live storages the program creates
  (outputs, gathered weights and gradients included); peak = arguments +
  temp, as in the reference.
* Where the rules cut a decode cache's head_dim or MLA latent over
  "model" (a KV head count that neither it nor H divides; jamba's
  ``long_500k``), the rank's program reads its heads' whole head_dim:
  those decode cells' FLOPs and HBM bytes are an upper estimate (their
  argument and peak bytes are the rules' blocks).
* Collectives, a stated model of the rules (XLA chooses otherwise: on a
  reduced qwen3-0.6b train cell on (4, 2) it all-gathers activations and
  never reduce-scatters): FSDP all-gathers of each weight sharded over the
  data axes (twice in a remat train step) and reduce-scatters of its
  gradient; all-reduces over the data axes of the gradients of weights
  replicated there; TP all-reduces of the activations after each
  row-parallel product (``wo``, ``w_down``, ``out_proj``, ``x_proj``,
  the experts' ``w_down``) -- once serving, three times in a remat train
  step (forward, recompute, backward); the sequence-parallel decode's
  combine of each attention layer's partial output; and ``moe_ep``'s
  all-to-alls, which the traced program records itself (two a layer
  forward, as many more backward).  Each kind's bytes are the tensor
  sizes; ``collective_s`` charges a ring's (n - 1) / n of them (twice for
  an all-reduce) at the axis's link rate: NVLink where the axis's ranks
  stay inside 8 consecutive ranks (the mesh is laid out row-major, model
  axis minor), the network otherwise -- so the production 16-wide model
  axis crosses nodes.

The constants are the H100 SXM datasheet's, not measurements.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.common.config import ModelConfig, ShapeConfig, shapes_for
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import context as dist_ctx
from repro_torch.distributed import sharding
from repro_torch.kernels import meta as kmeta
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import axis_sizes, batch_axes, production_axes
from repro_torch.models import model as model_lib
from repro_torch.models import params as params_lib
from repro_torch.models.moe import ep_capacity
from repro_torch.models.params import leaves
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_loop import loss_and_grads

# H100 SXM datasheet constants (not measured here)
PEAK_FLOPS = 989e12          # dense bf16, tensor cores
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s a GPU a direction, 8-GPU node
NET_BW = 50e9                # bytes/s a GPU across nodes (400 Gb/s NDR)
NODE = 8                     # GPUs a node

ALL_SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DEFAULT_OUT = os.path.join("build", "dryrun_torch")
_FSDP_AXES = ("pod", "data")


def optimizer_for(cfg: ModelConfig) -> str:
    """Adafactor above 1e11 parameters (grok-1-314b: Adam's f32 moments do
    not fit 256 cards), AdamW otherwise -- the reference's rule."""
    return "adafactor" if cfg.count_params() > 1e11 else "adamw"


def context_for(axes) -> dist_ctx.ParallelContext:
    """The reference's dry-run context: batch over the data axes, TP over
    "model", EP over "data"."""
    return dist_ctx.ParallelContext(mesh=axes, batch_axes=batch_axes(axes),
                                    model_axis="model", ep_axes=("data",))


# -- trees --------------------------------------------------------------------

def _flat(tree, names=()):
    """{path names: leaf} of a nest of dicts and lists (the rules' names)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, names + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, names + (f"[{i}]",)))
        return out
    return {names: tree}


def _flat_specs(tree, specs, names=()):
    """{path names: spec} of a spec tree mirroring ``tree`` (a spec is a
    tuple, so the walk follows the tensors')."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, specs[k], names + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, (v, sp) in enumerate(zip(tree, specs)):
            out.update(_flat_specs(v, sp, names + (f"[{i}]",)))
        return out
    return {names: specs}


def tree_local_bytes(tree, specs, axes) -> int:
    """Bytes of one rank's blocks of every leaf of ``tree``."""
    flat, fspecs = _flat(tree), _flat_specs(tree, specs)
    return sum(sharding.local_nbytes(x.shape, x.dtype, fspecs[k], axes)
               for k, x in flat.items())


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# -- the cell's arguments -----------------------------------------------------

@dataclasses.dataclass
class Arguments:
    """The step's stand-ins (global shapes, meta) and their specs."""
    params: Dict
    param_specs: Dict
    batch: Dict
    batch_specs: Dict
    opt: Optional[Dict] = None
    opt_specs: Optional[Dict] = None
    cache: Optional[Dict] = None
    cache_specs: Optional[Dict] = None
    optimizer: Optional[str] = None
    seq_parallel: bool = False

    def trees(self):
        return [(t, s) for t, s in ((self.params, self.param_specs),
                                    (self.opt, self.opt_specs),
                                    (self.batch, self.batch_specs),
                                    (self.cache, self.cache_specs))
                if t is not None]

    def local_bytes(self, axes) -> int:
        return sum(tree_local_bytes(t, s, axes) for t, s in self.trees())


def arguments(cfg: ModelConfig, shape: ShapeConfig, axes) -> Arguments:
    """The reference's ``lower_cell`` inputs (``dryrun.py:69-104``) as meta
    stand-ins with their specs, under the dry-run's context (which sizes
    the experts' storage and the decode cache's heads)."""
    sizes = axis_sizes(axes)
    data_shards = sizes["data"]
    mode = "train" if shape.kind == "train" else "serve"
    with dist_ctx.use(context_for(axes)):
        p = steps_lib.param_specs(cfg, data_shards)
        args = Arguments(
            params=p, param_specs=sharding.params_shardings(cfg, p, axes,
                                                            mode),
            batch=steps_lib.input_specs(cfg, shape), batch_specs=None)
        args.batch_specs = sharding.input_shardings(cfg, axes, args.batch)
        if shape.kind == "train":
            args.optimizer = optimizer_for(cfg)
            args.opt = steps_lib.opt_specs(cfg, data_shards, args.optimizer)
            args.opt_specs = sharding.params_shardings(cfg, args.opt, axes,
                                                       mode)
        elif shape.kind == "decode":
            args.seq_parallel = shape.global_batch < data_shards
            args.cache = steps_lib.cache_specs(cfg, shape)
            args.cache_specs = sharding.cache_shardings(
                cfg, axes, args.cache, args.seq_parallel)
    return args


# -- the rank's program -------------------------------------------------------

def _tp(sizes, dim: int) -> int:
    """The model axis's cut of ``dim`` where the rules cut it, else 1."""
    t = sizes.get("model", 1)
    return t if dim % t == 0 and dim >= t else 1


def local_config(cfg: ModelConfig, shape: ShapeConfig, axes) -> ModelConfig:
    """The config of one rank's program: every dim the rules cut over
    "model" divided by it (heads, KV heads -- the expanded H / tp where KV
    does not divide the axis but H does --, FFN width, the experts' and the
    shared experts' width, the scan's channels, the vocabulary), and the
    MoE dispatch the reference picks for the GLOBAL batch (``ep``, or
    ``gather`` where the tokens do not divide the batch shards)."""
    sizes = axis_sizes(axes)
    t = sizes.get("model", 1)
    h_loc = cfg.n_heads // _tp(sizes, cfg.n_heads)
    if _tp(sizes, cfg.n_kv_heads) > 1:
        kv_loc = cfg.n_kv_heads // t
    elif t > 1 and cfg.n_heads % t == 0 and h_loc < cfg.n_heads:
        kv_loc = h_loc                       # the expanded heads
    else:
        kv_loc = cfg.n_kv_heads
    ch = dict(n_heads=h_loc, n_kv_heads=kv_loc,
              d_ff=cfg.d_ff // _tp(sizes, cfg.d_ff) if cfg.d_ff else 0,
              vocab_size=cfg.vocab_size // _tp(sizes, cfg.vocab_size))
    if cfg.dense_first_layer and cfg.dense_first_d_ff:
        f = cfg.dense_first_d_ff
        ch["dense_first_d_ff"] = f // _tp(sizes, f)
    if cfg.mamba is not None:
        di = cfg.mamba.d_inner
        ch["mamba"] = dataclasses.replace(cfg.mamba,
                                          d_inner=di // _tp(sizes, di),
                                          dt_rank=cfg.dt_rank)
    if cfg.moe is not None:
        m = cfg.moe
        impl = m.impl
        if impl == "ep":
            shards = math.prod(sizes[a] for a in batch_axes(axes))
            tokens = shape.global_batch * (1 if shape.kind == "decode"
                                           else shape.seq_len)
            if tokens % shards or tokens < shards:
                impl = "gather"
        ch["moe"] = dataclasses.replace(
            m, d_expert=m.d_expert // _tp(sizes, m.d_expert), impl=impl)
    return dataclasses.replace(cfg, **ch)


def _drop_axes(spec, axes_to_drop):
    """``spec`` with the named axes removed (a gathered dim)."""
    out = []
    for a in spec:
        kept = tuple(x for x in a if x not in axes_to_drop) if a else ()
        out.append(kept or None)
    return tuple(out)


def _compute_spec(names, spec):
    """The block a rank computes with: FSDP axes gathered; the routed
    experts keep their EP axis ("data": every MoE config of the registry
    runs ``moe_ep``)."""
    if "routed" in names:
        return (spec[:-3] + (_drop_axes(spec[-3:-2], ("pod",))[0],)
                + _drop_axes(spec[-2:], _FSDP_AXES))
    return _drop_axes(spec, _FSDP_AXES)


def check_local_params(lcfg: ModelConfig, args: Arguments, axes) -> int:
    """Hold the local config's parameters to the rules' blocks (FSDP
    gathered), leaf by leaf; raise on a mismatch.  Two dims differ by
    design: the routed experts' leading dim (the block holds the rank's
    E_store / shards experts, where the local config routes over all E),
    and, where the rank reads the expanded heads, wk / wv's heads (the
    block holds every KV head, replicated; the rank's H / tp heads read
    theirs).  Returns the leaves checked."""
    got = _flat(params_lib.abstract_params(lcfg))
    specs = _flat_specs(args.params, args.param_specs)
    full = _flat(args.params)
    if got.keys() != full.keys():
        raise ValueError(f"local parameters {sorted(set(got) ^ set(full))}"
                         " differ from the stand-ins'")
    expanded = lcfg.n_kv_heads == lcfg.n_heads < full_heads(args)
    for key, x in got.items():
        block = compute_shape(key, full[key], specs[key], axes)
        have, want = tuple(x.shape), block
        skip = (len(have) - 3 if "routed" in key else
                len(have) - 2 if expanded and key[-1] in ("wk", "wv")
                else None)
        if skip is not None:
            have, want = (t[:skip] + t[skip + 1:] for t in (have, want))
        if have != want:
            raise ValueError(f"{'/'.join(key)}: local config gives "
                             f"{tuple(x.shape)}, the rules' block is "
                             f"{block}")
    return len(got)


def full_heads(args: Arguments) -> int:
    """The global config's q heads, read from the stand-ins."""
    for key, x in _flat(args.params).items():
        if key[-1] in ("wq", "wq_b"):
            return x.shape[-2]
    return 0


def compute_shape(key, x, spec, axes) -> Tuple[int, ...]:
    """The block of the global leaf ``x`` a rank computes with."""
    return sharding.local_shape(x.shape, _compute_spec(key, spec), axes)


def fsdp_block(key, shape, spec, axes) -> Tuple[int, ...]:
    """A local leaf's block over the FSDP axes its spec shards it on (the
    rank's share of the gathered weight, its gradient's reduce-scatter
    and its optimizer state)."""
    sizes = axis_sizes(axes)
    out = []
    for dim, ax in zip(shape, spec):
        fsdp = [a for a in (ax or ()) if a in _FSDP_AXES
                and not ("routed" in key and a == "data")]
        out.append(dim // math.prod(sizes[a] for a in fsdp))
    return tuple(out)


def local_params(lcfg: ModelConfig, args: Arguments, axes):
    """The local program's parameters: the local config's, with each
    routed expert leaf at the rules' block (E_store / shards experts)."""
    specs = _flat_specs(args.params, args.param_specs)
    full = _flat(args.params)

    def fix(tree, names=()):
        if isinstance(tree, dict):
            return {k: fix(v, names + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fix(v, names + (f"[{i}]",))
                              for i, v in enumerate(tree))
        if "routed" not in names or lcfg.moe.impl != "ep":
            return tree         # gather: every expert on the few rows
        return _meta(compute_shape(names, full[names], specs[names], axes),
                     tree.dtype)
    return fix(params_lib.abstract_params(lcfg))


def _local_batch(args: Arguments, shape: ShapeConfig, axes):
    """The rank's batch: each input cut by its spec."""
    fspecs = args.batch_specs
    return {k: _meta(sharding.local_shape(x.shape, fspecs[k], axes),
                     x.dtype) for k, x in args.batch.items()}


def _local_cache(local_cfg: ModelConfig, shape: ShapeConfig, axes,
                 seq_parallel: bool):
    """The rank's decode cache: its batch block, the local heads, and the
    sequence cut over the data axes where the cache is sequence-parallel
    (the compute layout of ``cache_shardings``' blocks)."""
    sizes = axis_sizes(axes)
    bshards = math.prod(sizes[a] for a in batch_axes(axes))
    b = shape.global_batch
    b_loc = b // bshards if b % bshards == 0 and b >= bshards else b
    s = shape.seq_len
    if seq_parallel and b_loc == b:
        s //= bshards
    return model_lib.init_cache(local_cfg, b_loc, s, device="meta")


# -- counting modes -----------------------------------------------------------

class _Counter(TorchDispatchMode):
    """HBM bytes and live storages of the traced program.

    Bytes: each op's tensor operands and results (unfused); views and
    allocations move none, a fill writes its result, a gather moves what
    it takes (twice its result, and its indices) and a scatter what it
    puts (twice its values, and its indices), not the whole tensor it
    indexes.  A kernel wrapper's
    meta branch makes only allocations here; its traffic is its ``cost``.

    Live bytes: every storage an op creates (an output that aliases no
    input), until it is freed, and their high-water mark."""

    _ALLOC = frozenset(("empty", "empty_like", "empty_strided",
                        "new_empty", "new_empty_strided", "lift_fresh"))
    _FILL = frozenset(("zeros_like", "ones_like", "full_like", "zeros",
                       "ones", "full", "new_zeros", "new_ones", "new_full",
                       "fill_", "zero_", "arange", "scalar_tensor"))
    _GATHER = frozenset(("index", "index_select", "gather", "embedding"))
    _SCATTER = frozenset(("index_put", "index_put_", "_index_put_impl_",
                          "scatter", "scatter_", "scatter_add",
                          "scatter_add_", "index_add", "index_add_",
                          "index_copy", "index_copy_"))

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm = 0
        self.live = 0
        self.peak = 0
        self._seen = {}
        self._ops = {}

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)

        def free(key=key, n=n, seen=self._seen, mode=weakref.ref(self)):
            seen.pop(key, None)
            m = mode()
            if m is not None:
                m.live -= n
        weakref.finalize(st, free)

    def _op(self, func):
        """(kind, aliased, FLOP formula) of an op, cached: kind "alloc",
        "fill", "gather", "scatter", "view" or "op"; aliased, whether a
        result is (a view of) an input; the formula ``FlopCounterMode``'s
        (``flop_registry``), or None."""
        info = self._ops.get(func)
        if info is None:
            name = func.overloadpacket.__name__
            rets = [r.alias_info for r in func._schema.returns]
            aliased = any(a is not None for a in rets)
            writes = any(a is not None and a.is_write for a in rets)
            kind = ("alloc" if name in self._ALLOC else
                    "fill" if name in self._FILL else
                    "gather" if name in self._GATHER else
                    "scatter" if name in self._SCATTER else
                    "view" if aliased and not writes else "op")
            info = (kind, aliased,
                    flop_registry.get(func.overloadpacket))
            self._ops[func] = info
        return info

    @staticmethod
    def _tensors(args, kwargs):
        out = []
        for a in list(args) + list((kwargs or {}).values()):
            if isinstance(a, torch.Tensor):
                out.append(a)
            elif isinstance(a, (list, tuple)):
                out.extend(x for x in a if isinstance(x, torch.Tensor))
        return out

    @staticmethod
    def _nbytes(ts) -> int:
        return sum(t.numel() * t.element_size() for t in ts
                   if isinstance(t, torch.Tensor))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        kind, aliased, flop_fn = self._op(func)
        if flop_fn is not None:
            self.flops += flop_fn(*args, **kwargs, out_val=out)
        if kind == "op":
            self.hbm += self._nbytes(self._tensors(args, kwargs)) + \
                self._nbytes(outs)
        elif kind == "fill":
            self.hbm += self._nbytes(outs)
        elif kind == "gather":
            idx = [t for t in self._tensors(args, kwargs)
                   if not t.is_floating_point()]
            self.hbm += 2 * self._nbytes(outs) + self._nbytes(idx)
        elif kind == "scatter":
            # (self, indices..., values / src): all but the destination
            ins = self._tensors(args, kwargs)
            self.hbm += 2 * self._nbytes(ins[-1:]) + self._nbytes(
                [t for t in ins[1:-1] if not t.is_floating_point()])
        if not aliased:
            for t in outs:
                if isinstance(t, torch.Tensor):
                    self._track(t)
        return out


@dataclasses.dataclass
class Program:
    flops: float
    hbm_bytes: float
    temp_bytes: int
    output_bytes: int
    kernels: Dict[str, list]
    all_to_all: int
    tokens: int


def _output_bytes(out) -> int:
    seen, total = set(), 0
    for t in torch.utils._pytree.tree_leaves(out):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += t.numel() * t.element_size()
    return total


def rank_program(cfg: ModelConfig, shape: ShapeConfig, axes,
                 args: Arguments) -> Tuple[Program, ModelConfig]:
    """Trace one rank's step on meta at its local shapes and count it.
    The rank's arguments exist before the count starts; FSDP-gathered
    weights, gradients, activations and outputs are made inside it."""
    lcfg = local_config(cfg, shape, axes)
    check_local_params(lcfg, args, axes)
    local = local_params(lcfg, args, axes)
    batch = _local_batch(args, shape, axes)
    ctx = dist_ctx.ParallelContext(mesh=axes, batch_axes=(),
                                   model_axis=None, ep_axes=("data",))
    cache = state = None
    if shape.kind == "decode":
        with dist_ctx.use(ctx):
            cache = _local_cache(lcfg, shape, axes, args.seq_parallel)
    if shape.kind == "train":
        # the rank's FSDP blocks and their optimizer state (arguments)
        specs = _flat_specs(args.params, args.param_specs)
        blocks = {}
        for key, x in _flat(local).items():
            shp = fsdp_block(key, x.shape, specs[key], axes)
            blocks[key] = x if shp == tuple(x.shape) else _meta(shp, x.dtype)
        block_list = list(blocks.values())
        state = (steps_lib.adafactor_init(block_list)
                 if args.optimizer == "adafactor"
                 else opt_lib.init(block_list))
        for p in leaves(local):
            p.requires_grad_(True)
    kmeta.reset()
    coll.reset_counts()
    counter = _Counter()
    with dist_ctx.use(ctx), counter:
        if shape.kind == "train":
            out = _train_program(lcfg, local, blocks, state, batch,
                                 args.optimizer)
        elif shape.kind == "prefill":
            out = model_lib.prefill(local, lcfg, cache_len=shape.seq_len,
                                    **batch)
        else:
            out = model_lib.decode_step(local, lcfg, cache, **batch)
        output_bytes = _output_bytes(out)
        del out
    kflops = sum(v[1] for v in kmeta.tally.values())
    kbytes = sum(v[2] for v in kmeta.tally.values())
    tokens = next(iter(batch.values())).shape[0] * (
        1 if shape.kind == "decode" else shape.seq_len)
    prog = Program(flops=float(counter.flops + kflops),
                   hbm_bytes=float(counter.hbm + kbytes),
                   temp_bytes=int(counter.peak),
                   output_bytes=int(output_bytes),
                   kernels={k: list(v) for k, v in kmeta.tally.items()},
                   all_to_all=int(coll.bytes_moved.get("all-to-all", 0)),
                   tokens=int(tokens))
    return prog, lcfg


def _train_program(lcfg, local, blocks, state, batch, optimizer):
    """``loss_and_grads`` on the gathered weights (a leaf the rules shard
    over the data axes is gathered into a fresh buffer, the all-gather's
    result), then the optimizer on the rank's FSDP blocks: the gradient's
    block (the reduce-scatter's result) updates the parameter's block and
    its moments."""
    flat_local = _flat(local)
    gathered = {}
    for key, p in flat_local.items():
        if blocks[key] is p:
            gathered[key] = p
        else:
            gathered[key] = torch.empty(p.shape, dtype=p.dtype,
                                        device="meta").requires_grad_(True)
    loss, aux, grads = loss_and_grads(lcfg, _unflat(local, gathered), batch)
    del gathered
    g_list = []
    for key, g in _flat(grads).items():
        blk = blocks[key]
        if tuple(g.shape) != tuple(blk.shape):
            g = torch.empty(blk.shape, dtype=g.dtype, device="meta").copy_(
                g[tuple(slice(0, n) for n in blk.shape)])
        g_list.append(g)
    del grads
    p_list = list(blocks.values())
    if optimizer == "adafactor":
        steps_lib.adafactor_update(1e-3, g_list, state, p_list)
        metrics = {}
    else:
        _, _, metrics = opt_lib.update(opt_lib.OptimizerConfig(), g_list,
                                       state, p_list)
    return p_list, state, {"loss": loss, **aux, **metrics}


def _unflat(tree, flat, names=()):
    """``tree``'s structure with its leaves from ``flat`` ({names: leaf})."""
    if isinstance(tree, dict):
        return {k: _unflat(v, flat, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflat(v, flat, names + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return flat[names]


# -- collectives --------------------------------------------------------------

def _link(axes, group_axes) -> Tuple[float, str]:
    """(bytes/s, "nvlink" | "network") of a collective over ``group_axes``:
    NVLink where the group's ranks stay inside 8 consecutive ranks of the
    row-major mesh."""
    sizes = axis_sizes(axes)
    names = list(sizes)
    span = 1
    for a in group_axes:
        stride = math.prod(sizes[b] for b in names[names.index(a) + 1:])
        span += (sizes[a] - 1) * stride
    return (NVLINK_BW, "nvlink") if span <= NODE else (NET_BW, "network")


def _factor(kind: str, n: int) -> float:
    """A ring's share of the tensor each rank sends."""
    if n <= 1:
        return 0.0
    return (2.0 if kind == "all-reduce" else 1.0) * (n - 1) / n


class _Collectives:
    def __init__(self, axes):
        self.axes = axes
        self.sizes = axis_sizes(axes)
        self.bytes: Dict[str, float] = {}
        self.seconds = 0.0

    def add(self, kind: str, group_axes, nbytes: float, times: float = 1):
        group_axes = tuple(a for a in group_axes if a in self.sizes)
        n = math.prod(self.sizes[a] for a in group_axes)
        if n <= 1 or nbytes <= 0 or times <= 0:
            return
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes * times
        bw, _ = _link(self.axes, group_axes)
        self.seconds += _factor(kind, n) * nbytes * times / bw

    def result(self) -> Dict[str, float]:
        out = {k: int(v) for k, v in sorted(self.bytes.items())}
        out["total"] = sum(out.values())
        return out


def collectives(cfg: ModelConfig, lcfg: ModelConfig, shape: ShapeConfig,
                axes, args: Arguments, prog: Program) -> _Collectives:
    """The step's collectives under the stated model (module docstring)."""
    c = _Collectives(axes)
    sizes = c.sizes
    train = shape.kind == "train"
    data_axes = tuple(a for a in _FSDP_AXES if a in sizes)
    itemsize = params_lib.torch_dtype(cfg.dtype).itemsize
    # weights: FSDP gathers and gradient reductions
    if train:
        gathers = 2 if cfg.remat else 1
        fspecs = _flat_specs(args.params, args.param_specs)
        fparams = _flat(args.params)
        for key, x in fparams.items():
            spec = fspecs[key]
            comp = _compute_spec(key, spec)
            gathered = math.prod(sharding.local_shape(x.shape, comp, axes)) \
                * x.element_size()
            on = {a for axes_ in spec if axes_ for a in axes_}
            fsdp_axes = tuple(a for a in data_axes if a in on
                              and not ("routed" in key and a == "data"))
            if fsdp_axes:
                c.add("all-gather", fsdp_axes, gathered, gathers)
                c.add("reduce-scatter", fsdp_axes, gathered)
            rest = tuple(a for a in data_axes if a not in on)
            if rest:
                c.add("all-reduce", rest, math.prod(
                    sharding.local_shape(x.shape, spec, axes))
                    * x.element_size())
    # TP all-reduces after each row-parallel product
    t = sizes.get("model", 1)
    if t > 1:
        per = 3 if train and cfg.remat else (2 if train else 1)
        tokens = prog.tokens
        act = tokens * cfg.d_model * itemsize
        n_rows = 0.0
        for pos in range(cfg.period):
            kind = cfg.layer_kind(pos)
            if kind == "mamba":
                if lcfg.mamba.d_inner < cfg.mamba.d_inner:
                    n_rows += act + tokens * (cfg.dt_rank + 2 *
                                              cfg.mamba.d_state) * itemsize
            elif lcfg.n_heads < cfg.n_heads:
                n_rows += act                                  # wo
            if cfg.layer_is_moe(pos):
                m, lm = cfg.moe, lcfg.moe
                if lm.d_expert < m.d_expert:
                    if lm.impl == "ep":
                        shards = sizes["data"]
                        rows = shards * ep_capacity(tokens, m.top_k, shards,
                                                    m.capacity_factor)
                    else:
                        rows = tokens * m.top_k
                    n_rows += rows * cfg.d_model * itemsize
                    if m.n_shared:
                        n_rows += act
            elif kind != "mamba" or cfg.d_ff:
                if lcfg.d_ff < cfg.d_ff:
                    n_rows += act
        c.add("all-reduce", ("model",), n_rows * cfg.n_periods, per)
        if cfg.dense_first_layer:
            first = (act if lcfg.n_heads < cfg.n_heads else 0) + (
                act if lcfg.dense_first_d_ff < cfg.dense_first_d_ff else 0)
            c.add("all-reduce", ("model",), first, per)
    # the sequence-parallel decode's combine
    if args.seq_parallel:
        n_attn = sum(1 for pos in range(cfg.period)
                     if cfg.layer_kind(pos) == "attn") * cfg.n_periods \
            + (1 if cfg.dense_first_layer else 0)
        hd = cfg.head_dim
        c.add("all-reduce", tuple(batch_axes(axes)),
              n_attn * prog.tokens * lcfg.n_heads * (hd + 2) * 4)
    # moe_ep's all-to-alls, as the traced program recorded them
    if prog.all_to_all:
        c.add("all-to-all", ("data",), prog.all_to_all)
    return c


# -- cells --------------------------------------------------------------------

def analyse(cfg: ModelConfig, shape: ShapeConfig, axes, multi_pod: bool,
            analysis: bool = True) -> Dict:
    """One cell's record (the reference's ``analyse`` keys where the
    quantity is the same; ``flops_per_device`` and
    ``hbm_bytes_per_device`` for its two HLO figures)."""
    sizes = axis_sizes(axes)
    n_chips = math.prod(sizes.values())
    args = arguments(cfg, shape, axes)
    arg_bytes = args.local_bytes(axes)
    prog, lcfg = rank_program(cfg, shape, axes, args)
    n = cfg.count_params()
    n_active = cfg.count_active_params()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = {"train": 6, "prefill": 2, "decode": 2}[shape.kind]
    model_flops = mult * n_active * tokens
    out = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "multi" if multi_pod else "single",
        "n_chips": int(n_chips),
        "params": int(n), "active_params": int(n_active),
        "argument_bytes_per_device": int(arg_bytes),
        "output_bytes_per_device": int(prog.output_bytes),
        "temp_bytes_per_device": int(prog.temp_bytes),
        "peak_bytes_per_device": int(arg_bytes + prog.temp_bytes),
        "optimizer": args.optimizer,
        "seq_parallel": args.seq_parallel,
    }
    if analysis:
        coll_ = collectives(cfg, lcfg, shape, axes, args, prog)
        terms = {"compute_s": prog.flops / PEAK_FLOPS,
                 "memory_s": prog.hbm_bytes / HBM_BW,
                 "collective_s": coll_.seconds}
        out.update({
            "flops_per_device": prog.flops,
            "hbm_bytes_per_device": prog.hbm_bytes,
            "collective_bytes": coll_.result(),
            "model_flops_global": model_flops,
            "useful_flop_ratio": (model_flops / n_chips) / prog.flops
            if prog.flops else 0.0,
            **terms,
            "dominant": max(terms, key=terms.get),
            "kernels": prog.kernels,
        })
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             verbose: bool = True, analysis: bool = True,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None, axes=None) -> Dict:
    """One cell, written to ``out_dir/<arch>__<shape>.json``.  ``cfg``,
    ``shape`` and ``axes`` override the registry's config, the named shape
    and the production mesh (a caller's own cell)."""
    cfg = cfg or get_config(arch)
    if shape is None:
        shape = {s.name: s for s in shapes_for(cfg)}.get(shape_name)
    mesh = "multi" if multi_pod else "single"
    if shape is None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh,
                "skipped": "long_500k requires sub-quadratic attention"}
    axes = axes or production_axes(multi_pod)
    t0 = time.perf_counter()
    result = analyse(cfg, shape, axes, multi_pod, analysis)
    result["trace_s"] = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape.name}.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    if verbose:
        line = (f"[{mesh}] {arch} x {shape.name}: "
                f"peak/dev={result['peak_bytes_per_device'] / 2**30:.2f}GiB")
        if analysis:
            line += (f" compute={result['compute_s'] * 1e3:.2f}ms "
                     f"memory={result['memory_s'] * 1e3:.2f}ms "
                     f"coll={result['collective_s'] * 1e3:.2f}ms "
                     f"dom={result['dominant']} "
                     f"useful={result['useful_flop_ratio']:.2f}")
        print(line + f" ({result['trace_s']:.1f}s trace)", flush=True)
    return result


def _cell_job(job) -> Optional[tuple]:
    """One cell of ``main`` (a worker's task): None, or the failure."""
    arch, sh, mp, sub = job
    try:
        # the roofline analysis only on the single-pod mesh; multi-pod
        # proves the "pod" axis shards and fits
        run_cell(arch, sh, mp, sub, analysis=not mp)
    except Exception as e:
        traceback.print_exc()
        return (arch, sh, mp, repr(e))
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-device memory, FLOPs, HBM bytes and collectives of "
        "the production cells, counted on the meta device: nothing is "
        "allocated and no card is needed, so there is no --device.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    archs = list(ASSIGNED) if args.all or not args.arch else [args.arch]
    shapes = ALL_SHAPE_NAMES if args.all or not args.shape \
        else [args.shape]
    jobs = []
    for mp in meshes:
        sub = os.path.join(args.out, "multi" if mp else "single")
        for arch in archs:
            cfg = get_config(arch)
            valid = {s.name for s in shapes_for(cfg)}
            for sh in shapes:
                if sh not in valid:
                    if sh in ALL_SHAPE_NAMES:
                        print(f"[skip] {arch} x {sh}: requires "
                              "sub-quadratic attention", flush=True)
                    continue
                key = os.path.join(sub, f"{arch}__{sh}.json")
                if os.path.exists(key):
                    print(f"[cached] {arch} x {sh}", flush=True)
                    continue
                jobs.append((arch, sh, mp, sub))
    workers = min(len(jobs), os.cpu_count() or 1)
    if workers > 1:
        # one process a cell at a time: the traces are Python-bound
        import multiprocessing
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            results = pool.map(_cell_job, jobs, chunksize=1)
    else:
        results = [_cell_job(job) for job in jobs]
    failures = [r for r in results if r is not None]
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("dry-run complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
