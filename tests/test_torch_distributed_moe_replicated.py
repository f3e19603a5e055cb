"""The port's expert-parallel MoE with replicated expert storage: E=2
experts stored for 4 EP shards (R=2, each expert twice, an expert's
tokens spread over both copies) on a gloo group of 8 CPU ranks, a
(data=4, model=2) mesh, against its own ``ragged`` (one copy of each
expert) and the JAX reference's ``moe_ep`` on host devices (set-up in
``_torch_dist_moe_support.py``).  f32, 1e-4."""
import numpy as np
import pytest

from _torch_dist_moe_support import moe_runs, rows

TOL = 1e-4
SETUPS = (("replicated", 2, 1, 4, 4.0),)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return moe_runs(tmp_path_factory.mktemp("moe_ep_replicas"), SETUPS)


def test_moe_ep_with_replicated_experts(runs):
    """E=2 stored for data=4 (R=2: each expert twice, an expert's tokens
    spread over both copies): against the port's ragged, which reads one
    copy, and against the reference's moe_ep."""
    ref, outs, plain = runs
    assert ref["replicated/moe/routed/w_up"].shape[0] == 4
    y_ep = rows(outs, "replicated/y")
    np.testing.assert_allclose(y_ep, plain["replicated"][0], atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(y_ep, ref["replicated/yep"], atol=TOL,
                               rtol=0)
    for o in outs:
        assert abs(float(o["replicated/aux"])
                   - float(ref["replicated/auxep"])) < 1e-5
