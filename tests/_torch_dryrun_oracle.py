"""The JAX package's dry-run as an oracle, run in a process of its own
with 8 forced host devices (``tests/_torch_dryrun_support.run_oracle``).

    python tests/_torch_dryrun_oracle.py args|flops CELLS.json OUT.json

``args``: for each cell, the reference's ``lower_cell`` compiled on its
mesh of host devices, and ``memory_analysis()``'s argument, output and
temp bytes.

``flops``: for each cell, ``extrapolate_costs``' shallow compiles (every
scan unrolled; a one-period config, as the tests' are, compiles once at
its own depth, where ``extrapolate_costs`` would return the two-period
compile) and, from each, ``cost_analysis()``'s FLOPs and the FLOPs of
the compiled program's products (every ``dot`` instruction: 2 x its
output's elements x its contracted size), extrapolated to full depth the
way ``extrapolate_costs`` does.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported; this process puts the 8 back before JAX makes its devices.
"""
import json
import os
import re
import sys

import numpy as np

import repro.launch.dryrun as dr  # noqa: E402  (sets XLA_FLAGS)

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.common.config import ShapeConfig  # noqa: E402
from repro.configs import get_config  # noqa: E402

import _torch_dryrun_support as sup  # noqa: E402

_DEF = re.compile(r"^\s*(?:ROOT )?%(\S+) = [a-z0-9]+\[([0-9,]*)\]")
_DOT = re.compile(r" dot\(%([^,\s]+), %([^,\s)]+)\)(.*)")


def _dims(s):
    return [int(x) for x in s.split(",") if x]


def dot_flops(hlo: str) -> int:
    """2 x output elements x contracted size, summed over every dot."""
    shapes = {}
    lines = hlo.splitlines()
    for line in lines:
        m = _DEF.match(line)
        if m:
            shapes[m.group(1)] = _dims(m.group(2))
    total = 0
    for line in lines:
        if " dot(" not in line:
            continue
        m, d = _DEF.match(line), _DOT.search(line)
        if not (m and d):
            raise ValueError(f"unparsed dot: {line.strip()[:200]}")
        lhs = shapes[d.group(1)]
        cd = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", d.group(3))
        k = int(np.prod([lhs[i] for i in _dims(cd.group(1))])) if cd else 1
        total += 2 * int(np.prod(_dims(m.group(2)))) * k
    return total


def mesh_of(name):
    axes, sizes = sup.MESHES[name]
    devs = np.array(jax.devices()[:int(np.prod(sizes))]).reshape(sizes)
    return Mesh(devs, axes), "pod" in axes


def main():
    what, cells_path, out_path = sys.argv[1:4]
    with open(cells_path) as f:
        cells = json.load(f)
    out = {}
    for cell in cells:
        cfg, shape = sup.build(get_config, ShapeConfig, cell)
        mesh, multi = mesh_of(cell["mesh"])
        if what == "args":
            _, comp = dr.lower_cell(cfg, shape, mesh, multi)
            mem = comp.memory_analysis()
            out[sup.key(cell)] = dict(
                argument=int(mem.argument_size_in_bytes),
                output=int(mem.output_size_in_bytes),
                temp=int(mem.temp_size_in_bytes))
            continue
        flops, dots = [], []
        for mult in ((1,) if cfg.n_periods == 1 else (1, 2)):
            _, comp = dr.lower_cell(dr._shallow(cfg, mult, shape), shape,
                                    mesh, multi)
            cost = comp.cost_analysis()
            cost = cost[0] if isinstance(cost, list) else cost
            flops.append(float(cost["flops"]))
            dots.append(dot_flops(comp.as_text()))
        n = cfg.n_periods
        if n == 1:
            out[sup.key(cell)] = dict(flops=flops[0], dots=dots[0])
            continue
        out[sup.key(cell)] = dict(
            flops=max(flops[0] + (flops[1] - flops[0]) * (n - 1), flops[1]),
            dots=max(dots[0] + (dots[1] - dots[0]) * (n - 1), dots[1]))
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
