"""The port's router training path against the JAX package's, on the
CPU: ``rl.train`` (episode histories, learn-step counts, the
best-validation snapshot, the trained networks), ``evaluate``,
``NStepAssembler``, and ``ManagedCluster.serve`` under a fault plan,
with the agent carried from the reference.  Small streams (about 30
requests, 2-3 instances) and a small replay batch, so that learn steps
happen within them."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import cluster_manager as ref_cm
from repro.core import rl_router as ref_rl
from repro.core import workload as ref_wl
from repro.core.profiles import V100_LLAMA2_7B as REF_V100
from repro_torch.core import cluster_manager as pt_cm
from repro_torch.core import rl_router as pt_rl
from repro_torch.core import workload as pt_wl
from repro_torch.core.profiles import V100_LLAMA2_7B as PT_V100
from repro_torch.training import checkpoint as pt_ckpt

RTOL = 1e-6
PARAM_TOL = 1e-4


def _pair(arch, batch_size=16, **kw):
    cfg_kw = dict(n_instances=2, q_arch=arch, explore_episodes=1, seed=0,
                  nstep=8, learn_every=2, **kw)
    ref_cfg, pt_cfg = ref_rl.RouterConfig(**cfg_kw), \
        pt_rl.RouterConfig(**cfg_kw)
    ref = ref_rl.make_agent(ref_cfg)
    pt = pt_rl.make_agent(pt_cfg, device="cpu")
    ref.cfg = dataclasses.replace(ref.cfg, batch_size=batch_size)
    pt.cfg = dataclasses.replace(pt.cfg, batch_size=batch_size)
    pt.from_reference(jax.tree.map(np.asarray, ref.params))
    return ref_cfg, pt_cfg, ref, pt


def _stream(wl, n=30, rate=2.5):
    return lambda ep: wl.to_requests(wl.generate(n, seed=ep), rate=rate,
                                     seed=ep + 50)


def _counting(fn, agent, steps):
    def wrapped(ep):
        steps.append(agent.steps)
        return fn(ep)
    return wrapped


def _assert_params_close(pt_agent, ref_tree, tol=PARAM_TOL):
    got = pt_ckpt._flatten(pt_agent.params.tree())
    want = pt_ckpt._flatten(jax.tree.map(np.asarray, ref_tree))
    assert list(got) == list(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=tol,
                                   atol=tol * scale, err_msg=key)


@pytest.mark.parametrize("variant", ["guided", "baseline"])
@pytest.mark.parametrize("arch", ["mlp", "decomposed"])
def test_train_matches_reference(arch, variant):
    ref_cfg, pt_cfg, ref, pt = _pair(arch, variant=variant)
    steps_r, steps_p = [], []
    out_r = ref_rl.train(ref_cfg, REF_V100,
                         _counting(_stream(ref_wl), ref, steps_r), 2,
                         agent=ref)
    out_p = pt_rl.train(pt_cfg, PT_V100,
                        _counting(_stream(pt_wl), pt, steps_p), 2,
                        agent=pt)
    assert out_p["agent"] is pt
    assert steps_p == steps_r and pt.steps == ref.steps > 0
    for h_r, h_p in zip(out_r["history"], out_p["history"], strict=True):
        assert set(h_p) == set(h_r)
        for key in ("n", "ticks", "episode", "epsilon", "guide_w",
                    "preemptions"):
            assert h_p[key] == h_r[key], key
        for key in ("e2e_mean", "reward", "ttft_mean"):
            np.testing.assert_allclose(h_p[key], h_r[key], rtol=RTOL,
                                       err_msg=key)
    assert pt.r_mean == pytest.approx(ref.r_mean, rel=RTOL)
    assert pt.buffer.size == ref.buffer.size
    _assert_params_close(pt, ref.params)


def test_train_restores_a_cloned_best_validation_snapshot():
    """With ``valid_fn`` the greedy-validated best network comes back at
    the end -- a clone taken when it validated, not the live network
    that kept learning after it."""
    ref_cfg, pt_cfg, ref, pt = _pair("decomposed")
    valid_r = lambda: _stream(ref_wl, n=20)(7)      # noqa: E731
    valid_p = lambda: _stream(pt_wl, n=20)(7)       # noqa: E731
    out_r = ref_rl.train(ref_cfg, REF_V100, _stream(ref_wl), 3, agent=ref,
                         valid_fn=valid_r)
    live = pt.params
    out_p = pt_rl.train(pt_cfg, PT_V100, _stream(pt_wl), 3, agent=pt,
                        valid_fn=valid_p)
    assert [h.get("valid_e2e") for h in out_p["history"]] == \
        pytest.approx([h.get("valid_e2e") for h in out_r["history"]],
                      rel=RTOL)
    assert pt.params is not live and pt.target is not pt.params
    _assert_params_close(pt, ref.params)
    for a, b in zip(pt.params.parameters(), pt.target.parameters()):
        assert np.array_equal(a.detach().numpy(), b.detach().numpy())


@pytest.mark.parametrize("arch", ["mlp", "decomposed"])
def test_evaluate_matches_reference(arch):
    ref_cfg, pt_cfg, ref, pt = _pair(arch)
    got = pt_rl.evaluate(pt_cfg, PT_V100, pt, _stream(pt_wl, n=40)(3))
    want = ref_rl.evaluate(ref_cfg, REF_V100, ref, _stream(ref_wl, n=40)(3))
    assert set(got) == set(want)
    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, rtol=RTOL, err_msg=key)


def test_nstep_assembler_matches_reference():
    rng = np.random.default_rng(0)
    a_r, a_p = ref_rl.NStepAssembler(4, 0.9), pt_rl.NStepAssembler(4, 0.9)
    out_r, out_p = [], []
    for i in range(11):
        r = float(rng.normal())
        out_r += list(a_r.add(i, i % 3, r))
        out_p += list(a_p.add(i, i % 3, r))
    out_r += list(a_r.drain())
    out_p += list(a_p.drain())
    assert out_p == out_r and len(out_p) == 11


PLANS = [{1.0: "fail:1", 4.0: "restore:1", 6.0: "add"},
         {0.5: "add", 2.0: "fail:0", 3.0: "fail:2", 7.0: "restore:0"}]


@pytest.mark.parametrize("plan", PLANS, ids=["fail-restore-add",
                                             "add-fail-fail-restore"])
@pytest.mark.parametrize("arch", ["mlp", "decomposed"])
def test_managed_cluster_serve_matches_reference(arch, plan):
    """Fail, restore and add events; the mlp agent cannot score the
    grown cluster and falls back to the guidance heuristic, as in the
    reference."""
    ref_cfg, pt_cfg, ref, pt = _pair(arch)
    mc_r = ref_cm.ManagedCluster(ref_cm.ManagedClusterConfig(n_instances=2),
                                 ref_cfg, REF_V100, ref)
    mc_p = pt_cm.ManagedCluster(pt_cm.ManagedClusterConfig(n_instances=2),
                                pt_cfg, PT_V100, pt)
    reqs_r = _stream(ref_wl, n=40, rate=5.0)(11)
    reqs_p = _stream(pt_wl, n=40, rate=5.0)(11)
    want = mc_r.serve(reqs_r, fault_plan=dict(plan))
    got = mc_p.serve(reqs_p, fault_plan=dict(plan))
    assert got["events"] == want["events"] and len(got["events"]) == \
        len(plan)
    assert set(got) == set(want)
    for key, val in want.items():
        if key != "events":
            np.testing.assert_allclose(got[key], val, rtol=RTOL,
                                       err_msg=key)
    assert [(r.instance, r.preemptions) for r in reqs_p] == \
        [(r.instance, r.preemptions) for r in reqs_r]


def test_managed_cluster_saves_and_restores_the_router(tmp_path):
    _, pt_cfg, _, pt = _pair("decomposed")
    mc = pt_cm.ManagedCluster(
        pt_cm.ManagedClusterConfig(n_instances=2,
                                   checkpoint_dir=str(tmp_path)),
        pt_cfg, PT_V100, pt)
    try:
        mc.save_router(4)
        saved = pt_ckpt._flatten(pt.state_dict())
        with_fresh = pt_rl.make_agent(
            dataclasses.replace(pt_cfg, seed=5), device="cpu")
        mc.agent = with_fresh
        assert mc.restore_router()
        for key, val in pt_ckpt._flatten(with_fresh.state_dict()).items():
            assert np.array_equal(val, saved[key]), key
    finally:
        mc.close()
    assert not mc.ckpt._thread.is_alive()
    bare = pt_cm.ManagedCluster(pt_cm.ManagedClusterConfig(), pt_cfg,
                                PT_V100, pt)
    assert not bare.restore_router()
    bare.close()


@pytest.mark.parametrize("kw", [{"backend": "vec"}, {"backend": "jax"},
                                {"sim_backend": "jax"}, {"pool": "vec"}])
def test_routing_env_refuses_unported_backends(kw):
    """Every backend is ported: ``vec``, the deprecated ``sim_backend``
    spelling and a shared pool step; the device-resident ``jax`` backend
    builds its pool on the card when ``reset`` builds the cluster (as the
    reference builds it there), so without a card it raises, asking for
    the CPU (its CPU pool steps in tests/test_torch_backends.py)."""
    import warnings
    from repro_torch.core.vecsim import VecCluster, VecSimPool
    if kw.get("pool") == "vec":
        kw = {"pool": VecSimPool(2), "pool_ep": 1}
    cfg = pt_rl.RouterConfig(n_instances=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        env = pt_rl.RoutingEnv(cfg, PT_V100, **kw)
    reqs = _stream(pt_wl, n=6)(0)
    if "jax" in kw.values() and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            env.reset(reqs)
        return
    env.reset(reqs)
    assert isinstance(env.cluster, VecCluster) and env.sim_backend == "vec"
    assert env.m == 2 and env.cluster.ep == kw.get("pool_ep", 0)
    done = False
    while not done:
        _, _, done, _ = env.step(0)
    assert len(env.cluster.completed) == 6


def test_router_config_has_every_reference_field():
    assert [f.name for f in dataclasses.fields(pt_rl.RouterConfig)] == \
        [f.name for f in dataclasses.fields(ref_rl.RouterConfig)]
    assert dataclasses.asdict(pt_rl.RouterConfig()) == \
        dataclasses.asdict(ref_rl.RouterConfig())
