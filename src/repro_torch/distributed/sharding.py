"""Logical-axis sharding rules, DP / FSDP / TP / EP / SP (the port of
``repro.distributed.sharding``).

Every parameter leaf is matched by its tree path to a rule that assigns
mesh axes to tensor dims, with divisibility fallbacks (starcoder2's 36
heads do not divide a 16-way "model" axis, so they stay unsharded; head_dim
is never split).  Rules differ between train (FSDP over "data"/"pod") and
serve (weights replicated across instances, the paper's homogeneous
instances, except EP expert shards).

A spec is a tuple with one entry per tensor dim: None, or a tuple of mesh
axis names, major to minor (the reference's ``PartitionSpec``, a single
axis name written as a 1-tuple).  ``placements`` turns one into
``DeviceMesh`` placements, ``local_shard`` cuts a rank's block out of a
full tensor.  The mesh is anything ``launch.mesh.axis_sizes`` reads.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from repro_torch.common.config import ModelConfig
from repro_torch.launch.mesh import axis_sizes, mesh_coords

Spec = Tuple[Optional[Tuple[str, ...]], ...]


def _axis(sizes: Dict[str, int], dim: int, axes) -> Optional[Tuple[str, ...]]:
    """The axes (those the mesh has) if their product divides ``dim`` and
    is at most ``dim``; else None."""
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a in sizes)
    if not axes or dim is None:
        return None
    n = math.prod(sizes[a] for a in axes)
    return axes if dim % n == 0 and dim >= n else None


def _tree_map_with_names(fn, tree, names=()):
    """``fn(names, leaf)`` over a nest of dicts and lists, the names as
    the reference's ``_path_names`` spells them (dict keys, ``[i]``)."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_names(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_with_names(fn, v, names + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(names, tree)


def param_spec(names: Tuple[str, ...], shape: Tuple[int, ...],
               cfg: ModelConfig, mesh, mode: str) -> Spec:
    """The spec of one parameter leaf.

    mode: "train" (FSDP over the data axes) | "serve" (replicated
    weights)."""
    sizes = axis_sizes(mesh)
    fsdp = tuple(a for a in ("pod", "data") if a in sizes) \
        if mode == "train" else ()
    tp = "model"
    name = names[-1]
    off = 1 if "layers" in names else 0          # leading n_periods dim
    shape = tuple(shape)

    def spec(*dims):
        full = (None,) * off + dims
        return full[:len(shape)] + (None,) * (len(shape) - len(full))

    dims = shape[off:]

    def fsdp_ax(i):
        return _axis(sizes, dims[i], fsdp) if fsdp else None

    def tp_ax(i):
        return _axis(sizes, dims[i], tp)

    if "routed" in names:
        # EP storage: experts over "data"; f over "model"; d gets no FSDP
        ep = _axis(sizes, dims[0], "data") if cfg.moe and \
            cfg.moe.impl == "ep" else fsdp_ax(0)
        if name in ("w_up", "w_gate"):      # [E, d, f]
            return spec(ep, None, tp_ax(2))
        if name == "w_down":                # [E, f, d]
            return spec(ep, tp_ax(1), None)
    if name == "router":
        return spec(None, None)
    if name == "embed":                     # [V, d]
        # d stays unsharded: an FSDP sharding of d would conflict with the
        # lookup output's batch axis
        return spec(tp_ax(0), None)
    if name == "lm_head":                   # [d, V]
        return spec(fsdp_ax(0), tp_ax(1))
    if name == "vision_proj":
        return spec(None, fsdp_ax(1))
    if name in ("wq", "wk", "wv"):          # [d, H, hd]
        # heads over "model" where divisible; never head_dim (RoPE splits
        # it in half)
        return spec(fsdp_ax(0), tp_ax(1), None)
    if name == "wo":                        # [H, hd, d]
        return spec(tp_ax(0), None, fsdp_ax(2))
    if name in ("wq_b", "wkv_b"):           # [r, H, *]
        return spec(None, tp_ax(1), None)
    if name in ("wq_a", "wkv_a"):           # [d, r]
        return spec(fsdp_ax(0), None)
    if name in ("w_up", "w_gate"):          # [d, f]
        return spec(fsdp_ax(0), tp_ax(1))
    if name == "w_down":                    # [f, d]
        return spec(tp_ax(0), fsdp_ax(1))
    if name == "in_proj":                   # [d, 2*di]
        return spec(fsdp_ax(0), tp_ax(1))
    if name == "conv_w":                    # [dc, di]
        return spec(None, tp_ax(1))
    if name in ("conv_b", "dt_bias", "D"):  # [di]
        return spec(tp_ax(0))
    if name == "x_proj":                    # [di, dtr+2ds]
        return spec(tp_ax(0), None)
    if name == "dt_proj":                   # [dtr, di]
        return spec(None, tp_ax(1))
    if name == "A_log":                     # [di, ds]
        return spec(tp_ax(0), None)
    if name == "out_proj":                  # [di, d]
        return spec(tp_ax(0), fsdp_ax(1))
    # norms, gates, scalars
    return (None,) * len(shape)


def params_shardings(cfg: ModelConfig, params_tree, mesh, mode: str):
    """The spec tree mirroring a params (or optimizer-state) tree."""
    return _tree_map_with_names(
        lambda names, leaf: param_spec(names, tuple(leaf.shape), cfg, mesh,
                                       mode), params_tree)


# -- activations / inputs / caches --------------------------------------------

def _batch_axes(sizes):
    return tuple(a for a in ("pod", "data") if a in sizes)


def batch_spec(mesh, batch_size: int, extra_dims: int = 1) -> Spec:
    sizes = axis_sizes(mesh)
    return (_axis(sizes, batch_size, _batch_axes(sizes)),) + \
        (None,) * extra_dims


def input_shardings(cfg: ModelConfig, mesh, tree):
    """Specs for a batch dict of (meta) tensors: dim 0 is the batch."""
    sizes = axis_sizes(mesh)
    return _tree_map_with_names(
        lambda names, leaf: (_axis(sizes, leaf.shape[0],
                                   _batch_axes(sizes)),)
        + (None,) * (leaf.dim() - 1), tree)


def cache_shardings(cfg: ModelConfig, mesh, cache_tree, seq_parallel: bool):
    """Decode-cache specs.

    Normal decode: batch over the data axes, KV heads (or latent / channel
    dims) over "model" where divisible.  Long context (``seq_parallel``):
    a batch the data axes do not divide shards the KV sequence axis over
    them instead (context parallelism); SSM channel state over "model"."""
    sizes = axis_sizes(mesh)
    batch_ax = _batch_axes(sizes)

    def one(names, leaf):
        name, shape = names[-1], tuple(leaf.shape)
        if name == "pos":
            return (None,)
        off = 1 if "layers" in names else 0
        dims = shape[off:]
        lead = (None,) * off
        b_ax = _axis(sizes, dims[0], batch_ax)
        if name in ("k", "v"):                   # [B,S,KV,hd]
            if seq_parallel and b_ax is None:
                return lead + (None, _axis(sizes, dims[1], batch_ax), None,
                               _axis(sizes, dims[3], "model"))
            kv_ax = _axis(sizes, dims[2], "model")
            hd_ax = None if kv_ax is not None else _axis(sizes, dims[3],
                                                         "model")
            return lead + (b_ax, None, kv_ax, hd_ax)
        if name == "ckv":                        # [B,S,r]
            if seq_parallel and b_ax is None:
                return lead + (None, _axis(sizes, dims[1], batch_ax), None)
            return lead + (b_ax, None, _axis(sizes, dims[2], "model"))
        if name == "kr":                         # [B,S,rope]: rope is tiny
            if seq_parallel and b_ax is None:
                return lead + (None, _axis(sizes, dims[1], batch_ax), None)
            return lead + (b_ax, None, None)
        if name == "ssm":                        # [B,di,ds]
            return lead + (b_ax, _axis(sizes, dims[1], "model"), None)
        if name == "conv":                       # [B,dc-1,di]
            return lead + (b_ax, None, _axis(sizes, dims[2], "model"))
        return lead + (b_ax,) + (None,) * (len(dims) - 1)

    return _tree_map_with_names(one, cache_tree)


# -- specs on a DeviceMesh ---------------------------------------------------

def placements(spec: Spec, mesh):
    """The ``DeviceMesh`` placements of ``spec``: for each mesh axis,
    ``Shard(d)`` for the tensor dim ``d`` it shards, else ``Replicate()``.
    A dim over several axes lists them in the mesh's order (DTensor
    shards such a dim major to minor in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, axes in enumerate(spec):
        if not axes:
            continue
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape`` under
    ``spec`` (:func:`local_shard`'s blocks: each dim over axes a0, a1, ...
    cut into prod(sizes) equal blocks)."""
    sizes = axis_sizes(mesh)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not fit a tensor of "
                         f"{len(shape)} dims")
    out = []
    for d, (dim, axes) in enumerate(zip(shape, spec)):
        n = math.prod(sizes[a] for a in axes) if axes else 1
        if dim % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {axes} ({n})")
        out.append(dim // n)
    return tuple(out)


def local_nbytes(shape, dtype, spec: Spec, mesh) -> int:
    """Bytes of one rank's block of a ``dtype`` tensor of ``shape`` under
    ``spec``."""
    return math.prod(local_shape(shape, spec, mesh)) * dtype.itemsize


def local_shard(x, spec: Spec, mesh, coords: Optional[Dict[str, int]] = None):
    """This rank's block of the full tensor ``x`` under ``spec`` (a view):
    each dim over axes (a0, a1, ...) is cut into prod(sizes) equal blocks
    and the block at the axes' coordinates, a0 major, is kept.
    ``coords`` ({axis: coordinate}) defaults to this rank's on a
    ``DeviceMesh``."""
    sizes = axis_sizes(mesh)
    if coords is None:
        coords = mesh_coords(mesh)
    blocks = local_shape(tuple(x.shape), spec, mesh)
    for d, axes in enumerate(spec):
        if not axes:
            continue
        i = 0
        for a in axes:
            i = i * sizes[a] + coords[a]
        x = x.narrow(d, i * blocks[d], blocks[d])
    return x
