"""The dry-run's argument bytes a device against the JAX reference's
``memory_analysis().argument_size_in_bytes`` for the train cells slowest
to compile (jamba-v0.1-52b's period of 8 layers, llama-3.2-vision-11b's
cross layers) on (data=4, model=2), and qwen3-0.6b's on (pod=2, data=2,
model=2); one subprocess for the module (``_torch_dryrun_oracle.py``)."""
import pytest

from repro_torch.common.config import ShapeConfig
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

import _torch_dryrun_support as sup

CELLS = [{"set": "tiny", "arch": a, "kind": "train", "mesh": m}
         for a, m in (("jamba-v0.1-52b", "4x2"),
                      ("llama-3.2-vision-11b", "4x2"),
                      ("qwen3-0.6b", "2x2x2"))]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return sup.run_oracle(tmp_path_factory, "dryrun_args_slow", CELLS,
                          "args")


@pytest.mark.parametrize("cell", CELLS, ids=sup.key)
def test_argument_bytes_equal_the_reference(ref, cell):
    cfg, shape = sup.build(get_config, ShapeConfig, cell)
    axes = sup.MESHES[cell["mesh"]]
    assert dryrun.arguments(cfg, shape, axes).local_bytes(axes) == \
        ref[sup.key(cell)]["argument"]
