"""The port's serving gateway over real engines against the JAX
package's: the RL policy with the reference's Q-network parameters
carried over (both Q architectures), a seeded crash + straggler
schedule with failover and hedging, the int8 KV cache, and the
featurizer read off the engine adapter.

Set-up and the exact comparison (decisions, stats, snapshot
percentiles, per-request virtual-clock stamps) are shared with
``test_torch_gateway.py`` through ``_torch_gateway_support``."""
import itertools
import json

import numpy as np
import pytest

from _torch_gateway_support import assert_same, chaos_schedule, \
    heuristic, rl_policies, serve_both
from repro.core import state as ref_state
from repro.serving import chaos as ref_chaos
from repro_torch.core import state as pt_state
from repro_torch.serving import chaos as pt_chaos

FLAGS = list(itertools.product([False, True], repeat=4))


@pytest.mark.parametrize("arch", ["decomposed", "mlp"])
def test_rl_policy_over_engines_matches_reference(arch):
    ref, pt = serve_both(rl_policies(arch))
    assert_same(ref, pt)


@pytest.mark.parametrize("policy", ["mixing", "rl"])
def test_chaos_failover_over_engines_matches_reference(policy):
    assert [repr(e) for e in chaos_schedule(pt_chaos).events()] == \
        [repr(e) for e in chaos_schedule(ref_chaos).events()]
    pols = rl_policies("decomposed") if policy == "rl" \
        else heuristic(policy)
    ref, pt = serve_both(pols, chaos=True)
    assert_same(ref, pt)
    stats = json.loads(pt[1])
    assert stats["orphaned"] > 0 and stats["n"] == 10


@pytest.mark.parametrize("policy", ["mixing", "rl"])
def test_int8_cache_over_engines_matches_reference(policy):
    pols = rl_policies("decomposed") if policy == "rl" \
        else heuristic(policy)
    ref, pt = serve_both(pols, int8=True)
    assert_same(ref, pt)


class _Featurizing:
    """Delegates to a policy and, at every decision, featurizes the
    cluster with every feature-flag combination."""

    def __init__(self, inner, state_lib):
        self.inner, self.state_lib = inner, state_lib
        self.name = inner.name
        self.states = []

    def route(self, cluster, req, d_hat):
        for flags in FLAGS:
            impact_f, hw, cache, health = flags
            self.states.append(self.state_lib.featurize(
                cluster, cluster.profile, n_buckets=8,
                include_impact=impact_f, predict_decode=lambda r: d_hat,
                include_hardware=hw, include_cache=cache,
                include_health=health))
        self.states.append(self.state_lib.action_mask(cluster))
        return self.inner.route(cluster, req, d_hat)


def test_featurize_on_engine_adapter_matches_reference():
    """Bit-identical float32 states off the engine adapter, with a
    prefix cache (cache features), failover (the health tracker's
    stamps) and a straggler (slowdown features)."""
    base = heuristic("mixing+cache")
    pols = {"ref": _Featurizing(base["ref"], ref_state),
            "pt": _Featurizing(base["pt"], pt_state)}
    ref, pt = serve_both(pols, prefix_cache=256, chaos=True)
    assert_same(ref, pt)
    assert len(pols["pt"].states) == len(pols["ref"].states) > 100
    for got, want in zip(pols["pt"].states, pols["ref"].states):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
