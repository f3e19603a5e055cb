"""The port's expert-parallel MoE (``models.moe.moe_ep``) on a gloo group
of 8 CPU ranks, a (data=4, model=2) mesh, against its own ``ragged`` and
the JAX reference's ``moe_ep`` on host devices (set-up in
``_torch_dist_moe_support.py``), and the expert storage at full width.
Reduced deepseek-moe-16b, f32; the bounds are the reference's own
test's (1e-4, the aux loss 0.3 against ``ragged``)."""
import numpy as np
import pytest

from repro.configs import REGISTRY as REF_REGISTRY
from repro.models import params as ref_params
from repro_torch.configs import get_config
from repro_torch.models import params as pt_params

from _torch_dist_moe_support import DATA, T, moe_runs, rows

TOL = 1e-4
# (name, experts, top_k, stored slots, capacity factor): 8 experts top-2
# with no drops; drops past a small capacity
SETUPS = (("full", 8, 2, 8, 4.0), ("drops", 8, 2, 8, 0.5))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return moe_runs(tmp_path_factory.mktemp("moe_ep"), SETUPS)


def test_moe_ep_matches_ragged_and_the_reference(runs):
    """(data=4, model=2), 8 experts top-2, capacity factor 4.0 (no drops):
    the port's moe_ep against its ragged over all the tokens, and against
    the reference's moe_ep on the same parameters and tokens; moe_layer's
    dispatch under the mesh (ep plus the shared expert) against ragged's."""
    ref, outs, plain = runs
    y_rag, aux_rag, y_lay = plain["full"]
    y_ep = rows(outs, "full/y")
    np.testing.assert_allclose(y_ep, y_rag, atol=TOL, rtol=0)
    np.testing.assert_allclose(y_ep, ref["full/yep"], atol=TOL, rtol=0)
    n = T // DATA
    for o in outs:      # the model axis's ranks agree (its all-reduce)
        i = int(o["coords"][0])
        np.testing.assert_array_equal(o["full/y"], y_ep[i * n:(i + 1) * n])
        assert abs(float(o["full/aux"]) - aux_rag) < 0.3
        assert abs(float(o["full/aux"]) - float(ref["full/auxep"])) < 1e-5
        # moe_ep's own call and moe_layer's dispatch to it; no drops
        assert int(o["full/calls"]) == 2 and int(o["full/dropped"]) == 0
        # the experts as DTensors placed by their specs: the same result
        np.testing.assert_array_equal(o["full/y_dtensor"], o["full/y"])
    np.testing.assert_allclose(rows(outs, "full/y_layer"), y_lay,
                               atol=TOL, rtol=0)


def test_moe_ep_drops_past_capacity_as_the_reference(runs):
    """At a capacity factor of 0.5 pairs are dropped: the port drops the
    same ones as the reference (outputs equal), and counts them."""
    ref, outs, plain = runs
    y_ep = rows(outs, "drops/y")
    np.testing.assert_allclose(y_ep, ref["drops/yep"], atol=TOL, rtol=0)
    assert np.abs(y_ep - plain["drops"][0]).max() > 1e-3
    dropped = sum(int(o["drops/dropped"]) for o in outs
                  if int(o["coords"][1]) == 0)
    assert 0 < dropped < T * 2


@pytest.mark.parametrize("arch,shards,store", [
    ("grok-1-314b", 16, 16), ("deepseek-moe-16b", 16, 64),
    ("jamba-v0.1-52b", 16, 16), ("deepseek-moe-16b", 0, 64)])
def test_expert_storage_matches_the_reference(arch, shards, store):
    """``init_params(..., data_shards)`` stores the reference's expert
    slots at full width (on the meta device): grok's 8 experts twice over
    16 shards."""
    cfg = get_config(arch)
    p = pt_params.abstract_params(cfg, shards)
    pos = next(i for i in range(cfg.period) if cfg.layer_is_moe(i))
    w = p["layers"][pos]["moe"]["routed"]["w_up"]
    assert w.device.type == "meta" and w.shape[1] == store
    assert ref_params._expert_storage(REF_REGISTRY[arch], shards) == store
