"""The dry-run's argument bytes a device against the JAX reference's
``lower_cell(...).compile().memory_analysis().argument_size_in_bytes``,
byte for byte: every registry config reduced to one period (bf16, remat,
experts through ``moe_ep``), the train cells on a (data=4, model=2) mesh
of host devices (jamba-v0.1-52b's and llama-3.2-vision-11b's, the
slowest to compile, in ``test_torch_dryrun_args_slow.py``).  The
reference's figures come from one subprocess for the module
(``tests/_torch_dryrun_oracle.py``)."""
import pytest

from repro_torch.common.config import ShapeConfig
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

import _torch_dryrun_support as sup

ARCHS = ("qwen3-0.6b", "gemma-7b", "starcoder2-7b", "llama-2-7b",
         "musicgen-medium", "falcon-mamba-7b", "minicpm3-4b",
         "deepseek-moe-16b", "grok-1-314b")
CELLS = [{"set": "tiny", "arch": a, "kind": "train", "mesh": "4x2"}
         for a in ARCHS]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return sup.run_oracle(tmp_path_factory, "dryrun_args", CELLS, "args")


def argument_bytes(cell) -> int:
    cfg, shape = sup.build(get_config, ShapeConfig, cell)
    axes = sup.MESHES[cell["mesh"]]
    return dryrun.arguments(cfg, shape, axes).local_bytes(axes)


@pytest.mark.parametrize("cell", CELLS, ids=sup.key)
def test_argument_bytes_equal_the_reference(ref, cell):
    """Parameters, optimizer state (AdamW; the rule's Adafactor only above
    1e11 parameters) and batch, each leaf cut to one rank's block."""
    assert argument_bytes(cell) == ref[sup.key(cell)]["argument"]
