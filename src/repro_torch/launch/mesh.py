"""Meshes (the port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the default process
group, whose named dimensions are the reference's mesh axes.  The
sharding rules and the parallel context read only axis names and sizes,
so they also take a plain ``(axis names, sizes)`` pair, or any object
with ``axis_names`` and a ``shape`` mapping (a jax ``AbstractMesh``, a
test's fake): that holds them at the production sizes without 256
processes.  ``make_production_mesh`` is a function, not a constant, so
that importing this module touches no process group.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple


def production_axes(multi_pod: bool = False
                    ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """The target deployment's (axis names, sizes):

    single-pod: (16, 16) = 256 devices, axes ("data", "model")
    multi-pod:  (2, 16, 16) = 512 devices, axes ("pod", "data", "model")

    "data" (x "pod") enumerates serving instances / DP+FSDP shards;
    "model" is the tensor-parallel axis inside an instance.  On H100s a
    16-wide model axis spans two 8-GPU NVLink domains."""
    if multi_pod:
        return ("pod", "data", "model"), (2, 16, 16)
    return ("data", "model"), (16, 16)


def make_mesh(shape, axes, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with the named ``axes`` over the
    default process group, which the caller has initialised; raises if
    its world size is not ``prod(shape)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default "
                           "process group (torch.distributed."
                           "init_process_group)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"world size {dist.get_world_size()} is not the "
                         f"mesh's {math.prod(shape)} = prod{shape}")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The target deployment mesh (:func:`production_axes`) over the
    default process group of 256 (512) ranks."""
    axes, shape = production_axes(multi_pod)
    return make_mesh(shape, axes, device=device)


def set_mesh(mesh):
    """Context manager making ``mesh`` ambient: a ``DeviceMesh``'s own
    (DTensor operations read it); for a plain axes mesh, nothing."""
    if hasattr(mesh, "__enter__"):
        return mesh
    return contextlib.nullcontext(mesh)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}, in the mesh's axis order, for a ``DeviceMesh``,
    an ``(axis names, sizes)`` pair, or an object with ``axis_names`` and
    a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # DeviceMesh
        return dict(zip(names, mesh.shape))
    if isinstance(mesh, tuple) and len(mesh) == 2:
        names, sizes = mesh
        if len(names) != len(sizes):
            raise ValueError(f"mesh {mesh}: names and sizes differ in "
                             "length")
        return dict(zip(tuple(names), (int(s) for s in sizes)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def mesh_axes(mesh) -> tuple:
    return tuple(axis_sizes(mesh))


def batch_axes(mesh) -> tuple:
    """Axes the global batch shards over."""
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of a ``DeviceMesh``."""
    coords = mesh.get_coordinate()
    if coords is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, (int(c) for c in coords)))

