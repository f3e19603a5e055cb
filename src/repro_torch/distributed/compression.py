"""Compressed gradient all-reduce (int8 quantized) for data parallelism
(the port of ``repro.distributed.compression``):

    g_int8 = round(g / scale),  scale = max|g| over the group / 127
    all_reduce(g_int8 as int32) * scale / n_shards

per tensor.  The quantized payload is a quarter of f32's bytes; the sum
runs as int32, as the reference's ``psum`` does, so the all-reduce itself
moves as many bytes as an f32 one.  Where the reference's ``shard_map``
cuts the global batch, each rank here passes its own batch shard.  The
scales travel as one all-reduce (max) of every leaf's amax, and the
integers as one all-reduce (sum) of every leaf's values.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.collectives import axis_group
from repro_torch.models.params import leaves, tree_unflatten


def quantize_psum(tree, group):
    """The int8-quantized mean of a tree of tensors over ``group``."""
    flat = leaves(tree)
    if not flat:
        return tree
    n = torch.distributed.get_world_size(group)
    gf = [g.float() for g in flat]
    amax = torch.stack([torch.max(torch.abs(g)) for g in gf])
    # one shared scale a leaf: the max across ranks first, so the
    # quantization grids line up
    coll.all_reduce(amax, "max", group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.cat([torch.clamp(torch.round(g / s), -127, 127)
                   .to(torch.int8).reshape(-1) for g, s in zip(gf, scale)])
    total = coll.all_reduce(q.to(torch.int32), "sum", group)
    out, start = [], 0
    for g, s in zip(flat, scale):
        part = total[start:start + g.numel()].reshape(g.shape)
        start += g.numel()
        out.append((part.float() * s / float(n)).to(g.dtype))
    return tree_unflatten(tree, out)


def make_compressed_dp_grad_fn(loss_fn: Callable, mesh,
                               batch_axes) -> Callable:
    """grad_fn(params, local_batch) -> the mean over the ``batch_axes``
    group of each rank's gradient of ``loss_fn(params, local_batch)``,
    reduced by the int8 all-reduce.  Params are replicated; each rank
    passes its own batch shard."""
    group = axis_group(mesh, tuple(batch_axes))

    def grad_fn(params, batch):
        ps = [p.detach().requires_grad_(True) for p in leaves(params)]
        grads = torch.autograd.grad(
            loss_fn(tree_unflatten(params, ps), batch), ps)
        return quantize_psum(tree_unflatten(params, grads), group)

    return grad_fn
