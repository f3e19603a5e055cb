"""Ambient parallelism context (the port of
``repro.distributed.context``).

Launchers install the active mesh and the axis roles here so that model
code (the expert-parallel MoE, the decode cache's head layout) finds them
without threading a mesh through every call.  With no context set, model
code runs its single-device implementations.

The mesh is a ``DeviceMesh`` or anything :func:`repro_torch.launch.mesh.
axis_sizes` reads (axis names and sizes).  ``constrain_heads`` and
``constrain_batch`` are XLA sharding hints in the reference, which never
change a value; the port's eager SPMD makes every collective an explicit
call, so here they keep the reference's signature and divisibility rule
and return ``x`` itself.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.launch.mesh import axis_sizes


@dataclass
class ParallelContext:
    mesh: object = None                      # DeviceMesh, axes mesh or None
    batch_axes: Tuple[str, ...] = ()         # the global batch's axes
    model_axis: Optional[str] = None         # TP axis name
    ep_axes: Tuple[str, ...] = ()            # expert-parallel axes
    seq_axis: Optional[str] = None           # SP axis (long-context)


_CURRENT = ParallelContext()


def get() -> ParallelContext:
    return _CURRENT


def set_context(ctx: ParallelContext) -> None:
    global _CURRENT
    _CURRENT = ctx


@contextlib.contextmanager
def use(ctx: ParallelContext):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ctx
    try:
        yield ctx
    finally:
        _CURRENT = prev


def tp_size() -> int:
    ctx = get()
    if ctx.mesh is None or ctx.model_axis is None:
        return 1
    return axis_sizes(ctx.mesh)[ctx.model_axis]


def _product(ctx: ParallelContext, axes) -> int:
    sizes = axis_sizes(ctx.mesh)
    return math.prod(sizes[a] for a in axes)


def heads_spec(shape, head_dim: int = 2, batch_dim: int = 0):
    """The spec the reference's ``constrain_heads`` gives a tensor of
    ``shape``: dim ``head_dim`` over the model axis (and the batch over
    the batch axes) where divisible; None where it leaves it alone."""
    ctx = get()
    if ctx.mesh is None or ctx.model_axis is None:
        return None
    if shape[head_dim] % tp_size() != 0:
        return None
    dims = [None] * len(shape)
    dims[head_dim] = (ctx.model_axis,)
    if ctx.batch_axes and shape[batch_dim] % _product(
            ctx, ctx.batch_axes) == 0:
        dims[batch_dim] = tuple(ctx.batch_axes)
    return tuple(dims)


def batch_spec_of(shape, batch_dim: int = 0):
    """The spec the reference's ``constrain_batch`` gives a tensor of
    ``shape``: dim ``batch_dim`` over the batch axes where divisible,
    everything else replicated; None where it leaves it alone."""
    ctx = get()
    if ctx.mesh is None or not ctx.batch_axes:
        return None
    if shape[batch_dim] % max(1, _product(ctx, ctx.batch_axes)) != 0:
        return None
    dims = [None] * len(shape)
    dims[batch_dim] = tuple(ctx.batch_axes)
    return tuple(dims)


def constrain_heads(x, head_dim: int = 2, batch_dim: int = 0):
    """A sharding hint to :func:`heads_spec` in the reference; every
    collective of the port is explicit, so ``x`` is returned as it is."""
    return x


def constrain_batch(x, batch_dim: int = 0):
    """A sharding hint to :func:`batch_spec_of` in the reference (layer
    boundaries); ``x`` is returned as it is."""
    return x


def data_shards() -> int:
    """Size of the expert-parallel axis product (0 if no context)."""
    ctx = get()
    if ctx.mesh is None:
        return 0
    return _product(ctx, ctx.ep_axes)
