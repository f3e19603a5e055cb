"""The dry-run's FLOPs a device against the JAX reference's compiled
program (``extrapolate_costs``' compiles, ``tests/_torch_dryrun_oracle.py``
in one subprocess for the module) on (1, 1) and (data=4, model=2) meshes
of host devices, at the probe's widths (d_model 256, d_ff 1024, 8 heads
of 32, vocabulary 2048; B=4 x S=128; one period), train cells: the dense
attention families and minicpm3-4b here; the scan, vision and MoE
families in ``test_torch_dryrun_flops_b.py`` and ``_jamba.py``.

What is compared is the products: the port's count (the products by
``torch.utils.flop_counter``'s formulas plus the kernels' ``cost``) turned
by five stated terms into the reference's program
(``_torch_dryrun_support.as_reference_products``), against the FLOPs of
the reference's compiled ``dot`` instructions, within the family bound
(5% dense attention, 10% scan / MLA / vision, 20% MoE), and the
(4, 2) / (1, 1) ratio within 5% of the reference's.  XLA's own total
(``cost_analysis``) adds elementwise work, mostly the reference's
associative scan (36 FLOPs an element forward, 368 with its gradient,
where the port's kernel does the function's 7 ds + 3 and 19 ds + 8); it
is printed beside, not compared."""
import pytest

from repro_torch.common.config import ShapeConfig
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

import _torch_dryrun_support as sup

ARCHS = ("qwen3-0.6b", "gemma-7b", "starcoder2-7b", "llama-2-7b",
         "musicgen-medium", "minicpm3-4b")
BOUND = {"minicpm3-4b": 0.10}
CELLS = [{"set": "probe", "arch": a, "kind": "train", "mesh": m}
         for a in ARCHS for m in ("1x1", "4x2")]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return sup.run_oracle(tmp_path_factory, "dryrun_flops", CELLS, "flops")


def port_record(cell):
    cfg, shape = sup.build(get_config, ShapeConfig, cell)
    return dryrun.analyse(cfg, shape, sup.MESHES[cell["mesh"]], False)


def check_family(ref, arch, bound):
    got = {}
    for mesh in ("1x1", "4x2"):
        cell = {"set": "probe", "arch": arch, "kind": "train", "mesh": mesh}
        r = port_record(cell)
        port = sup.as_reference_products(get_config, cell, r)
        want = ref[sup.key(cell)]["dots"]
        print(f"{sup.key(cell)}: port {r['flops_per_device']:.6g} -> "
              f"{port:.6g} products, reference {want:.6g} products, "
              f"{ref[sup.key(cell)]['flops']:.6g} in all")
        assert abs(port / want - 1) <= bound, (cell, port, want)
        got[mesh] = (port, want)
    ratio = (got["4x2"][0] / got["1x1"][0]) / (got["4x2"][1] / got["1x1"][1])
    assert abs(ratio - 1) <= 0.05, ratio


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_per_device_match_the_reference(ref, arch):
    check_family(ref, arch, BOUND.get(arch, 0.05))
