"""GPipe-style pipeline parallelism over a process group (the port of
``repro.distributed.pipeline``).

Each rank along the mesh axis ``axis`` holds one stage's parameters; the
schedule runs ``n_micro + n_stages - 1`` ticks; each tick the activation
moves one rank forward on a ring (``collectives.ring_shift``, the
reference's ``ppermute``).  At the end the last stage's outputs reach
every rank through one all-reduce of the masked outputs (the reference's
``psum``).  The reference runs every stage on every tick, the bubble's
ticks on stale buffers whose results are never emitted; here a stage
skips those ticks, which changes no output.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.collectives import axis_group


def pipeline_apply(stage_fn: Callable, mesh, axis: str, stage_params,
                   x_micro: torch.Tensor) -> torch.Tensor:
    """Run ``x_micro`` [n_micro, mb, ...] (the same on every rank) through
    the stages along ``axis`` of the ``DeviceMesh``.

    stage_fn(params, x [mb, ...]) -> [mb, ...]
    stage_params: THIS rank's stage (the reference's leading stage dim is
    the rank's coordinate on ``axis``).
    Returns the last stage's outputs [n_micro, mb, ...] on every rank."""
    group = axis_group(mesh, (axis,))
    n_stages = torch.distributed.get_world_size(group)
    stage = torch.distributed.get_rank(group)
    n_micro = x_micro.shape[0]
    buf = torch.zeros_like(x_micro[0])            # activation in flight
    outs = torch.zeros_like(x_micro)
    ticks = n_micro + n_stages - 1
    for t in range(ticks):
        if stage == 0 and t < n_micro:
            buf = x_micro[t]                      # stage 0 ingests t
        # stage s holds microbatch t - s on ticks s .. s + n_micro - 1
        y = stage_fn(stage_params, buf) if 0 <= t - stage < n_micro \
            else buf
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = y          # last stage emits
        if t < ticks - 1:                         # the last shift feeds none
            buf = coll.ring_shift(y, group)
    if stage != n_stages - 1:
        outs.zero_()
    return coll.all_reduce(outs, "sum", group)
