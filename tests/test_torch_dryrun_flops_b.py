"""As ``test_torch_dryrun_flops.py``, for falcon-mamba-7b and
llama-3.2-vision-11b (bound 10%) and the routed-expert families
deepseek-moe-16b and grok-1-314b (20%), experts 8 x top-2 through
``moe_ep``; jamba-v0.1-52b in ``test_torch_dryrun_flops_jamba*.py``."""
import pytest

import _torch_dryrun_support as sup
from test_torch_dryrun_flops import check_family

BOUND = {"falcon-mamba-7b": 0.10, "llama-3.2-vision-11b": 0.10,
         "deepseek-moe-16b": 0.20, "grok-1-314b": 0.20}
CELLS = [{"set": "probe", "arch": a, "kind": "train", "mesh": m}
         for a in BOUND for m in ("1x1", "4x2")]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return sup.run_oracle(tmp_path_factory, "dryrun_flops_b", CELLS,
                          "flops")


@pytest.mark.parametrize("arch", sorted(BOUND))
def test_flops_per_device_match_the_reference(ref, arch):
    check_family(ref, arch, BOUND[arch])
