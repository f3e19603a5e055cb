"""The port's router against the JAX package's, on the simulator.

The DQN Q-network with the reference's parameters carried over by value
(Q-values within 1e-6 of their scale, greedy decisions identical with
the guidance prior and the Q squash), the featurizer (float32 states
bit-identical for every feature-flag combination), the r_mixing scores,
guidance prior and action mask, and the framework-free copies the
gateway runs on (workload scenarios, fault schedules, the simulator and
its legacy heuristics, streaming metrics, and the gateway itself over
the ``py`` simulator).  All on the CPU at small sizes; the engine-backed
gateway is in ``test_torch_gateway*.py``."""
import dataclasses
import itertools
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import dqn as ref_dqn
from repro.core import policies as ref_legacy
from repro.core import rl_router as ref_rl
from repro.core import simulator as ref_sim
from repro.core import state as ref_state
from repro.core import workload as ref_wl
from repro.core.profiles import A100_LLAMA31_8B as REF_A100
from repro.core.profiles import V100_LLAMA2_7B as REF_V100
from repro.serving import chaos as ref_chaos
from repro.serving import gateway as ref_gw
from repro.serving import metrics as ref_metrics
from repro.serving import policies as ref_pol
from repro_torch.core import dqn as pt_dqn
from repro_torch.core import policies as pt_legacy
from repro_torch.core import rl_router as pt_rl
from repro_torch.core import simulator as pt_sim
from repro_torch.core import state as pt_state
from repro_torch.core import workload as pt_wl
from repro_torch.core.profiles import A100_LLAMA31_8B as PT_A100
from repro_torch.core.profiles import V100_LLAMA2_7B as PT_V100
from repro_torch.serving import chaos as pt_chaos
from repro_torch.serving import gateway as pt_gw
from repro_torch.serving import metrics as pt_metrics
from repro_torch.serving import policies as pt_pol

Q_RTOL = 1e-6
FLAGS = list(itertools.product([False, True], repeat=4))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _agents(arch, m=3, **over):
    cfg_kw = dict(q_arch=arch, n_instances=m, **over)
    ref = ref_rl.make_agent(ref_rl.RouterConfig(**cfg_kw))
    pt = pt_rl.make_agent(pt_rl.RouterConfig(**cfg_kw), device="cpu")
    pt.from_reference(_np_tree(ref.params))
    return ref, pt


def _assert_q_close(pt, ref):
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(pt, ref, rtol=Q_RTOL, atol=Q_RTOL * scale)


# -- the Q-network ------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mlp", "decomposed"])
def test_q_values_match_reference(arch):
    ref, pt = _agents(arch)
    kept = dataclasses.asdict(pt.cfg)
    assert kept == {k: getattr(ref.cfg, k) for k in kept}
    rng = np.random.default_rng(0)
    states = rng.standard_normal((64, ref.cfg.state_dim)).astype(np.float32)
    q_ref = np.asarray(ref_dqn.q_values(ref.cfg, ref.params, states))
    q_pt = pt_dqn.q_values(pt.params, states)
    assert q_pt.dtype == np.float32 and q_pt.shape == q_ref.shape
    _assert_q_close(q_pt, q_ref)
    if arch == "decomposed":
        # the equivariant network scores any cluster width
        wide = rng.standard_normal(
            (8, ref.cfg.inst_dims * 6 + ref.cfg.router_dims)
        ).astype(np.float32)
        _assert_q_close(pt_dqn.q_values(pt.params, wide),
                        np.asarray(ref_dqn.q_values(ref.cfg, ref.params,
                                                    wide)))


@pytest.mark.parametrize("m", [2, 3, 5, 17])
def test_decomposed_q_ties_identical_instances_exactly(m):
    """Identical instance blocks (idle instances) score bit-identical
    Q-values, as in the reference, so the masked argmax breaks the tie
    the same way -- whatever the cluster width."""
    ref, pt = _agents("decomposed", m=m)
    rng = np.random.default_rng(m)
    block = rng.standard_normal(ref.cfg.inst_dims).astype(np.float32)
    router = rng.standard_normal(ref.cfg.router_dims).astype(np.float32)
    s = np.concatenate([np.tile(block, m), router])[None]
    q_pt = pt_dqn.q_values(pt.params, s)[0]
    q_ref = np.asarray(ref_dqn.q_values(ref.cfg, ref.params, s))[0]
    assert len(set(q_ref[:m].tolist())) == 1
    assert len(set(q_pt[:m].tolist())) == 1
    _assert_q_close(q_pt, q_ref)


@pytest.mark.parametrize("arch", ["mlp", "decomposed"])
@pytest.mark.parametrize("q_squash", [0.0, 0.05])
def test_act_decisions_match_reference(arch, q_squash):
    ref, pt = _agents(arch)
    rng = np.random.default_rng(1)
    n_act = ref.cfg.n_actions
    for _ in range(200):
        s = rng.standard_normal(ref.cfg.state_dim).astype(np.float32)
        mask = rng.random(n_act) < 0.7
        mask[-1] = True
        prior = (rng.standard_normal(n_act).astype(np.float32) * 0.1
                 if rng.random() < 0.7 else None)
        assert pt.act(s, mask, prior=prior, q_squash=q_squash) == \
            ref.act(s, mask, prior=prior, q_squash=q_squash)
    states = rng.standard_normal((32, ref.cfg.state_dim)).astype(np.float32)
    masks = rng.random((32, n_act)) < 0.6
    masks[:, -1] = True
    prior = rng.standard_normal((32, n_act)).astype(np.float32) * 0.1
    np.testing.assert_array_equal(
        pt.act_batch(states, masks, prior=prior, q_squash=q_squash),
        ref.act_batch(states, masks, prior=prior, q_squash=q_squash))


@pytest.mark.parametrize("arch", ["mlp", "decomposed"])
def test_parameter_trees_round_trip(arch):
    ref, pt = _agents(arch)
    tree = pt.params.reference_tree()
    want = _np_tree(ref.params)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    other = pt_rl.make_agent(pt_rl.RouterConfig(q_arch=arch,
                                                n_instances=3),
                             device="cpu")
    other.load_state_dict(pt.state_dict())
    s = np.ones((2, ref.cfg.state_dim), np.float32)
    np.testing.assert_array_equal(pt_dqn.q_values(other.params, s),
                                  pt_dqn.q_values(pt.params, s))


def test_init_is_seeded_he_normal():
    cfg = pt_dqn.DQNConfig(state_dim=200, n_actions=5, hidden=(256, 256))
    a = pt_dqn.DQNAgent(cfg, seed=3, device="cpu")
    b = pt_dqn.DQNAgent(cfg, seed=3, device="cpu")
    c = pt_dqn.DQNAgent(cfg, seed=4, device="cpu")
    w0 = a.params.net.w0.detach()
    assert torch.equal(w0, b.params.net.w0)
    assert not torch.equal(w0, c.params.net.w0)
    assert abs(float(w0.std()) - (2.0 / 200) ** 0.5) < 0.01
    assert not bool(a.params.net.b0.detach().any())


def test_agent_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the agent runs on it")
    cfg = pt_rl.RouterConfig(n_instances=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_rl.make_agent(cfg)


def test_restore_rl_policy_names_the_training_slice(tmp_path):
    """The training slice's checkpoint restores into a policy whose
    networks equal the saved agent's; an empty directory raises."""
    from repro_torch.training.checkpoint import CheckpointManager
    cfg = pt_rl.RouterConfig(q_arch="decomposed", n_instances=3)
    saved = pt_rl.make_agent(dataclasses.replace(cfg, seed=5),
                             device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    try:
        mgr.save(2, saved.state_dict(), sync=True)
    finally:
        mgr.close()
    pol = pt_pol.restore_rl_policy(cfg, str(tmp_path), m=2, device="cpu")
    s = np.ones((2, pol.agent.cfg.state_dim), np.float32)
    q = pt_dqn.q_values(pol.agent.params, s)
    np.testing.assert_array_equal(q, pt_dqn.q_values(saved.params, s))
    assert not np.array_equal(q, pt_dqn.q_values(
        pt_rl.make_agent(cfg, m=2, device="cpu").params, s))
    with pytest.raises(FileNotFoundError, match="no router checkpoint"):
        pt_pol.restore_rl_policy(cfg, str(tmp_path / "none"), device="cpu")


def test_guidance_weight_and_dims_match_reference():
    for variant in ("guided", "aware", "baseline"):
        cfg_r = ref_rl.RouterConfig(variant=variant)
        cfg_p = pt_rl.RouterConfig(variant=variant)
        for ep in (0, 1, 5, 40):
            assert pt_rl.guidance_weight(cfg_p, ep) == \
                ref_rl.guidance_weight(cfg_r, ep)
    for flags in FLAGS:
        assert pt_state.instance_dims(*flags) == \
            ref_state.instance_dims(*flags)
        assert pt_state.state_dim(5, *flags) == ref_state.state_dim(5,
                                                                    *flags)


# -- the featurizer and the scoring, on the simulator -------------------------

def _scenario(wl, prof, seed=5, n=60, m=3, sessions=True):
    return wl.make_tenant_scenario(
        seed=seed, n_requests=n, rate=12.0, pattern="bursty",
        profiles=(prof,) * m,
        sessions=wl.SessionConfig(block=16) if sessions else None)


def _clusters(hetero=False):
    profs_r = (REF_V100, REF_A100, REF_V100) if hetero else REF_V100
    profs_p = (PT_V100, PT_A100, PT_V100) if hetero else PT_V100
    kw = dict(n_instances=3, prefix_cache_tokens=2048, prefix_block=16)
    return ref_sim.Cluster(profs_r, **kw), pt_sim.Cluster(profs_p, **kw)


def _lockstep(ref_c, pt_c, ticks=400):
    """Drive both clusters with the same seeded stream under round
    robin; yield at every tick that has a request to route."""
    ref_reqs = _scenario(ref_wl, REF_V100).requests
    pt_reqs = _scenario(pt_wl, PT_V100).requests
    i, nxt = 0, 0
    for tick in range(ticks):
        while i < len(ref_reqs) and ref_reqs[i].arrival <= ref_c.t:
            ref_c.enqueue(ref_reqs[i])
            pt_c.enqueue(pt_reqs[i])
            i += 1
        if ref_c.central:
            yield tick
            alive = ref_c.alive()
            if alive:
                a = alive[nxt % len(alive)]
                nxt += 1
                ref_c.route(a)
                pt_c.route(a)
        if tick == 120:     # a failed instance: all-zero block, masked
            ref_c.fail_instance(1)
            pt_c.fail_instance(1)
        if tick == 260:
            ref_c.recover_instance(1)
            pt_c.recover_instance(1)
        ref_c.advance()
        pt_c.advance()


@pytest.mark.parametrize("hetero", [False, True])
def test_featurize_matches_reference_bit_for_bit(hetero):
    ref_c, pt_c = _clusters(hetero)
    seen = 0
    for tick in _lockstep(ref_c, pt_c):
        # the gateway's health stamp, as the HealthTracker would set it
        scores = [0.1 * ((tick + k) % 7) for k in range(3)]
        for c in (ref_c, pt_c):
            c.health_scores = list(scores)
            c.instances[2].speed_factor = 1.0 + (tick % 3)
        for flags in FLAGS:
            impact_f, hw, cache, health = flags
            kw = dict(n_buckets=8, include_impact=impact_f,
                      predict_decode=lambda r: r.decode_tokens + 3,
                      include_hardware=hw, include_cache=cache,
                      include_health=health)
            want = ref_state.featurize(ref_c, ref_c.profile, **kw)
            got = pt_state.featurize(pt_c, pt_c.profile, **kw)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=str(flags))
            np.testing.assert_array_equal(
                pt_state.pad_state(got, 3, 5, *flags),
                ref_state.pad_state(want, 3, 5, *flags))
        seen += 1
    assert seen > 50


@pytest.mark.parametrize("cache_weight", [0.0, 0.5])
def test_scores_guidance_and_mask_match_reference(cache_weight):
    ref_c, pt_c = _clusters(hetero=True)
    seen = 0
    for tick in _lockstep(ref_c, pt_c):
        hm = [True, tick % 5 != 0, tick % 3 != 0]
        for c in (ref_c, pt_c):
            c.health_mask = list(hm)
        rh, ph = ref_c.central[0], pt_c.central[0]
        for d_hat in (1, rh.decode_tokens, 900):
            s_ref = ref_rl.mixing_scores(ref_c, rh, d_hat, 0.5,
                                         cache_weight=cache_weight)
            s_pt = pt_rl.mixing_scores(pt_c, ph, d_hat, 0.5,
                                       cache_weight=cache_weight)
            np.testing.assert_array_equal(s_pt, s_ref)
            np.testing.assert_array_equal(
                pt_rl.guidance_from_scores(pt_c, ph, d_hat, s_pt),
                ref_rl.guidance_from_scores(ref_c, rh, d_hat, s_ref))
        mask = pt_state.action_mask(pt_c)
        np.testing.assert_array_equal(mask, ref_state.action_mask(ref_c))
        np.testing.assert_array_equal(pt_state.pad_mask(mask, 3, 6),
                                      ref_state.pad_mask(mask, 3, 6))
        seen += 1
    assert seen > 50


# -- the framework-free copies ------------------------------------------------

def _req_fields(r):
    return (r.prompt_tokens, r.decode_tokens, r.arrival, r.tenant,
            r.task, r.prefix_hashes, r.full_hashes)


@pytest.mark.parametrize("sessions", [False, True])
def test_tenant_scenario_matches_reference(sessions):
    ref = _scenario(ref_wl, REF_V100, sessions=sessions, n=200)
    pt = _scenario(pt_wl, PT_V100, sessions=sessions, n=200)
    assert [_req_fields(r) for r in pt.requests] == \
        [_req_fields(r) for r in ref.requests]
    assert pt.meta == ref.meta


def test_fault_schedules_match_reference():
    for seed in range(6):
        kw = dict(seed=seed, m=4, horizon=30.0, n_crashes=2,
                  n_stragglers=2, n_bursts=1)
        ref = ref_chaos.FaultSchedule.random(**kw)
        pt = pt_chaos.FaultSchedule.random(**kw)
        assert [repr(e) for e in pt.events()] == \
            [repr(e) for e in ref.events()]


def _simulated(sim, legacy, prof, name, wl):
    cluster = sim.Cluster(prof, 3)
    reqs = wl.to_requests(wl.generate(150, seed=4), rate=9.0, seed=5)
    stats = sim.run_heuristic(cluster, reqs, legacy.make_policy(name, prof))
    return stats, [(r.instance, r.first_token, r.finished)
                   for r in reqs]


@pytest.mark.parametrize("name", ["round_robin", "jsq", "decode_balancer",
                                  "dedicated", "max_capacity", "min_min",
                                  "impact_greedy"])
def test_simulator_and_legacy_policies_match_reference(name):
    assert _simulated(pt_sim, pt_legacy, PT_V100, name, pt_wl) == \
        _simulated(ref_sim, ref_legacy, REF_V100, name, ref_wl)


def test_simulator_refuses_unported_backends():
    """Every backend resolves through the registry: ``vec``, and the
    device-resident ``jax``, whose pool defaults to the card and so
    raises without one, asking for the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt_sim.Cluster(PT_V100, 2, backend="jax")
    assert type(pt_sim.Cluster(PT_V100, 2, backend="vec")).__name__ == \
        "VecCluster"


def _gateway_sim(gw, pol, rl, wl, prof, chaos, policy, **cfg_kw):
    scn = _scenario(wl, prof, seed=9, n=150, sessions=False)
    gcfg = gw.GatewayConfig(**cfg_kw)
    if chaos is not None:
        gcfg.chaos = chaos.FaultSchedule.random(
            seed=3, m=3, horizon=10.0, n_crashes=1, n_stragglers=1)
        gcfg.failover = True
        gcfg.hedge_after_s = 2.0
    g = gw.Gateway(gcfg, (prof,) * 3,
                   pol.make_gateway_policy(policy, rl.RouterConfig()))
    stats = g.run(scn)
    return ([(r.instance, r.first_token, r.finished, r.phase.name)
             for r in scn.requests], stats)


@pytest.mark.parametrize("policy", ["rr", "jsq", "mixing", "sticky"])
@pytest.mark.parametrize("setup", ["shed", "chaos"])
def test_gateway_over_simulator_matches_reference(policy, setup):
    kw = dict(queue_cap=6, on_full="shed",
              tenant_weights={"chat": 2.0}) if setup == "shed" else {}
    chaos = setup == "chaos"
    ref = _gateway_sim(ref_gw, ref_pol, ref_rl, ref_wl, REF_V100,
                       ref_chaos if chaos else None, policy, **kw)
    pt = _gateway_sim(pt_gw, pt_pol, pt_rl, pt_wl, PT_V100,
                      pt_chaos if chaos else None, policy, **kw)
    assert pt[0] == ref[0]
    assert json.dumps(pt[1], sort_keys=True, default=str) == \
        json.dumps(ref[1], sort_keys=True, default=str)
    assert pt_metrics.format_snapshot(pt[1]["snapshot"]) == \
        ref_metrics.format_snapshot(ref[1]["snapshot"])


@pytest.mark.parametrize("arch", ["mlp", "decomposed"])
def test_rl_policy_route_and_explain_match_reference(arch):
    """RLPolicy on the simulator: the same decisions, and ``explain``'s
    score breakdown -- r_mixing scores and the guidance prior exactly,
    Q-values and the selection vector within 1e-6 of their scale."""
    ref_agent, pt_agent = _agents(arch)
    kw = dict(q_arch=arch, n_instances=3)
    ref_p = ref_pol.RLPolicy(ref_agent, ref_rl.RouterConfig(**kw))
    pt_p = pt_pol.RLPolicy(pt_agent, pt_rl.RouterConfig(**kw))
    ref_c, pt_c = _clusters()
    seen = 0
    for _ in _lockstep(ref_c, pt_c):
        rh, ph = ref_c.central[0], pt_c.central[0]
        d_hat = rh.decode_tokens
        assert pt_p.route(pt_c, ph, d_hat) == ref_p.route(ref_c, rh, d_hat)
        want, got = ref_p.explain(ref_c, rh, d_hat), \
            pt_p.explain(pt_c, ph, d_hat)
        assert set(got) == set(want)
        for key in ("scores", "bonus", "prior"):
            assert got.get(key) == want.get(key), key
        _assert_q_close(np.asarray(got["q"]), np.asarray(want["q"]))
        sel_g, sel_w = np.asarray(got["sel"]), np.asarray(want["sel"])
        np.testing.assert_array_equal(np.isinf(sel_g), np.isinf(sel_w))
        fin = np.isfinite(sel_w)
        _assert_q_close(sel_g[fin], sel_w[fin])
        seen += 1
    assert seen > 50
