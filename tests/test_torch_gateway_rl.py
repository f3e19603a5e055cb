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

import jax
import numpy as np
import pytest
import torch

from _torch_gateway_support import MODULES, assert_same, engines, run, \
    stream
from repro.core import rl_router as ref_rl
from repro.core import state as ref_state
from repro.serving import chaos as ref_chaos
from repro.serving import policies as ref_pol
from repro_torch.core import rl_router as pt_rl
from repro_torch.core import state as pt_state
from repro_torch.serving import chaos as pt_chaos
from repro_torch.serving import policies as pt_pol

SIDES = (("ref", ref_rl, ref_pol, ref_chaos), ("pt", pt_rl, pt_pol, pt_chaos))
FLAGS = list(itertools.product([False, True], repeat=4))


def _rl_policies(arch, m=2):
    """RLPolicy on each side; the port's agent holds the reference's
    parameters."""
    kw = dict(variant="guided", n_instances=m, q_arch=arch, seed=0)
    ref_cfg, pt_cfg = ref_rl.RouterConfig(**kw), pt_rl.RouterConfig(**kw)
    ref_agent = ref_rl.make_agent(ref_cfg)
    pt_agent = pt_rl.make_agent(pt_cfg, device="cpu")
    pt_agent.from_reference(jax.tree.map(np.asarray, ref_agent.params))
    return {"ref": ref_pol.RLPolicy(ref_agent, ref_cfg),
            "pt": pt_pol.RLPolicy(pt_agent, pt_cfg)}


def _chaos(chaos_mod):
    return chaos_mod.FaultSchedule.random(seed=7, m=2, horizon=1.0,
                                          n_crashes=1, n_stragglers=1)


def _serve(policies, int8=False, prefix_cache=0, chaos=False, **gcfg):
    ref_e, pt_e = engines(int8=int8, prefix_cache=prefix_cache)
    out = []
    for (side, _, _, chaos_mod), eng in zip(SIDES, (ref_e, pt_e)):
        kw = dict(gcfg)
        if chaos:
            kw.update(chaos=_chaos(chaos_mod), failover=True,
                      hedge_after_s=0.3)
        with torch.no_grad():
            out.append(run(side, eng, policies[side],
                           stream(MODULES[side]), **kw))
    return out


def _heuristic(name):
    return {side: pol.make_gateway_policy(name, rl.RouterConfig(
        n_instances=2)) for side, rl, pol, _ in SIDES}


@pytest.mark.parametrize("arch", ["decomposed", "mlp"])
def test_rl_policy_over_engines_matches_reference(arch):
    ref, pt = _serve(_rl_policies(arch))
    assert_same(ref, pt)


@pytest.mark.parametrize("policy", ["mixing", "rl"])
def test_chaos_failover_over_engines_matches_reference(policy):
    assert [repr(e) for e in _chaos(pt_chaos).events()] == \
        [repr(e) for e in _chaos(ref_chaos).events()]
    pols = _rl_policies("decomposed") if policy == "rl" \
        else _heuristic(policy)
    ref, pt = _serve(pols, chaos=True)
    assert_same(ref, pt)
    stats = json.loads(pt[1])
    assert stats["orphaned"] > 0 and stats["n"] == 10


@pytest.mark.parametrize("policy", ["mixing", "rl"])
def test_int8_cache_over_engines_matches_reference(policy):
    pols = _rl_policies("decomposed") if policy == "rl" \
        else _heuristic(policy)
    ref, pt = _serve(pols, int8=True)
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
    base = _heuristic("mixing+cache")
    pols = {"ref": _Featurizing(base["ref"], ref_state),
            "pt": _Featurizing(base["pt"], pt_state)}
    ref, pt = _serve(pols, prefix_cache=256, chaos=True)
    assert_same(ref, pt)
    assert len(pols["pt"].states) == len(pols["ref"].states) > 100
    for got, want in zip(pols["pt"].states, pols["ref"].states):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
