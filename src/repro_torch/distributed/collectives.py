"""The port's collectives: one explicit call each on a ``torch.distributed``
process group, where the reference's ``shard_map`` bodies name mesh axes.

Every collective of ``models.moe.moe_ep``, ``distributed.pipeline`` and
``distributed.compression`` goes through here.  NCCL refuses two ranks on
one device, so several ranks on one card run over gloo, which implements
only some collectives for CUDA tensors.  Where the group's backend is
gloo and the op is not one of those, the tensor is copied to the host,
the collective runs there, and the result is copied back; the choice is
made from the backend and the op, never by catching an error, and each
such copy is counted (``host_copies``, ``host_copy_bytes``).  NCCL
groups, and tensors already on the host, never take that path.

Every all-reduce and all-to-all adds the bytes this rank sends into it
to ``bytes_moved`` under the reference's kind name.  On the ``meta``
device (the dry-run's program of one rank) they move nothing and need no
group: they only add those bytes and return a result of the right shape.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_sizes

#: collectives gloo runs on CUDA tensors itself (all-reduce sum and max
#: of f32, bf16 and int32, and the equal-split all-to-all, checked on an
#: H100 with torch 2.11); point-to-point sends and receives go through
#: the host
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_to_all"})

#: collectives whose CUDA tensors went through the host since the last
#: reset, and the bytes copied each way
host_copies = 0
host_copy_bytes = 0
#: {"all-reduce" | "all-to-all": bytes this rank put in} since the last
#: reset
bytes_moved = {}

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_counts() -> None:
    global host_copies, host_copy_bytes
    host_copies = host_copy_bytes = 0
    bytes_moved.clear()


def _count(kind: str, t: torch.Tensor) -> None:
    bytes_moved[kind] = bytes_moved.get(kind, 0) + t.numel() * \
        t.element_size()


def axis_group(mesh, axes: Sequence[str]):
    """The process group of this rank's line (or plane) along ``axes`` of
    a ``DeviceMesh``."""
    axes = tuple(axes)
    if not axes:
        raise ValueError("no mesh axes given")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = list(axis_sizes(mesh))
    return mesh[tuple(sorted(axes, key=names.index))]._flatten().get_group()


def via_host(t: torch.Tensor, group, op: str) -> bool:
    """Whether ``op`` on ``t`` over ``group`` runs on a host copy: a CUDA
    tensor on a gloo group, for an op gloo has no CUDA implementation
    of."""
    return (t.is_cuda and dist.get_backend(group) == "gloo"
            and op not in GLOO_CUDA_OPS)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    global host_copies, host_copy_bytes
    host_copies += 1
    host_copy_bytes += t.numel() * t.element_size()
    return t.cpu()


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """In-place all-reduce ("sum" or "max") of ``t``; returns ``t``."""
    _count("all-reduce", t)
    if t.device.type == "meta":
        return t
    if via_host(t, group, "all_reduce"):
        h = _to_host(t)
        dist.all_reduce(h, op=_REDUCE_OPS[op], group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=_REDUCE_OPS[op], group=group)
    return t


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """Equal-split all-to-all along dim 0 (the reference's tiled
    ``all_to_all`` over axis 0): block i of ``t`` goes to the group's
    rank i, and block j of the result came from rank j."""
    t = t.contiguous()
    if t.device.type == "meta":
        return _MetaAllToAll.apply(t)
    _count("all-to-all", t)
    if via_host(t, group, "all_to_all"):
        h = _to_host(t)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=group)
        return out.to(t.device)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _MetaAllToAll(torch.autograd.Function):
    """The all-to-all on meta: its bytes counted, a result of its shape,
    and, under autograd, the backward's all-to-all of the gradient counted
    too."""

    @staticmethod
    def forward(ctx, t):
        _count("all-to-all", t)
        return torch.empty_like(t)

    @staticmethod
    def backward(ctx, grad):
        _count("all-to-all", grad)
        return torch.empty_like(grad)


def ring_shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """Send ``t`` to the next rank of the group, and return what the
    previous rank sent (the reference's ``ppermute`` with
    ``i -> (i + 1) % n``)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    send = t.contiguous()
    if via_host(send, group, "send_recv"):
        send = _to_host(send)
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, nxt, group),
            dist.P2POp(dist.irecv, recv, prv, group)]):
        req.wait()
    return recv.to(t.device)
