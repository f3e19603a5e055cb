"""As ``test_torch_dryrun_flops.py``, for jamba-v0.1-52b (one period of 8
layers: 7 Mamba-1, 1 attention, 4 with experts 8 x top-2 through
``moe_ep``) on the 1 x 1 mesh alone: its compile takes ~35 s, so each
mesh has a file.  The products are held within 2.5% a mesh, tighter than
the family's 20%, so that the two files together hold the (4, 2) / (1, 1)
ratio within 5% of the reference's."""
import pytest

import _torch_dryrun_support as sup
from test_torch_dryrun_flops import port_record
from repro_torch.configs import get_config

CELL = {"set": "probe", "arch": "jamba-v0.1-52b", "kind": "train",
        "mesh": "1x1"}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return sup.run_oracle(tmp_path_factory, "dryrun_flops_jamba_1x1",
                          [CELL], "flops")


def test_flops_per_device_match_the_reference(ref):
    r = port_record(CELL)
    port = sup.as_reference_products(get_config, CELL, r)
    want = ref[sup.key(CELL)]["dots"]
    print(f"{sup.key(CELL)}: port {r['flops_per_device']:.6g} -> "
          f"{port:.6g} products, reference {want:.6g} products, "
          f"{ref[sup.key(CELL)]['flops']:.6g} in all")
    assert abs(port / want - 1) <= 0.025, (port, want)
