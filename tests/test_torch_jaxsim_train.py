"""The port's device-resident simulator under its callers, on the CPU: the
batched trainer over ``backend="jax"`` against ``py`` (the reference's
``test_train_batched_jax_reproduces_python_backend``), the device
featurizer ``featurize_jax_many`` bit-equal to ``featurize_vec_many`` and
to the reference's (the oracle subprocess, ``_torch_jaxsim_oracle.py
featurize``), a hypothesis property with instance failures against
``py``, the hybrid pool (``min_span_ticks=8``) over the batched
drive's shared spans using both paths with the numpy pool's results, and
the gateway CLI's ``--backend jax`` against ``--backend vec``."""
import numpy as np
import pytest
import torch
from _hypothesis_support import given, settings, st
from _torch_jaxsim_support import (assert_stamps_equal, drive_pooled, reqs,
                                   run_oracle, stamps)

from repro_torch.core import batched_rl, rl_router as rl
from repro_torch.core import state as state_lib
from repro_torch.core.jaxsim import JaxSimPool
from repro_torch.core.profiles import V100_LLAMA2_7B as PROF
from repro_torch.core.simulator import Cluster
from repro_torch.core.vecsim import VecCluster, VecSimPool
from repro_torch.core.workload import Scenario
from repro_torch.kernels.sim_rounds import ops as sim_ops
from repro_torch.launch import serve

FLAGS = ({}, {"include_hardware": True},
         {"include_cache": True, "include_health": True},
         {"include_impact": False, "include_hardware": True})


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = run_oracle(tmp_path_factory, "featurize")
    with np.load(out / "featurize.npz") as z:
        return dict(z)


def test_train_batched_jax_reproduces_python_backend(monkeypatch):
    """Same seeds, same scenarios: the jax-pool trainer makes the SAME
    decisions as the Python-stepper trainer (ticks and preemptions
    exact, E2E to 1e-9, rewards to the summation order's 1e-6)."""
    calls = []
    plain = sim_ops.rounds_plain
    monkeypatch.setattr(sim_ops, "rounds_plain",
                        lambda ro, c: calls.append(1) or plain(ro, c))

    def scenario(ep):
        return Scenario.homogeneous(PROF, 3, reqs(40, seed=700 + ep))

    def cfg():
        return rl.RouterConfig(variant="guided", n_instances=3,
                               explore_episodes=2, q_arch="decomposed",
                               seed=0)
    hist = {}
    for backend, kw in (("py", None), ("jax", {"device": "cpu"})):
        hist[backend] = batched_rl.train_batched(
            cfg(), scenario, 3, device="cpu",
            bcfg=batched_rl.BatchedRLConfig(n_envs=3, m_max=3,
                                            backend=backend,
                                            pool_kwargs=kw))["history"]
    assert calls, "no span reached the round loop"
    for hp, hj in zip(hist["py"], hist["jax"]):
        assert hp["n"] == hj["n"] == 40
        assert hp["ticks"] == hj["ticks"]
        assert hp["preemptions"] == hj["preemptions"]
        assert hp["e2e_mean"] == pytest.approx(hj["e2e_mean"], rel=1e-9)
        assert hp["reward"] == pytest.approx(hj["reward"], rel=1e-6)


@pytest.mark.parametrize("fi", range(len(FLAGS)))
def test_featurize_jax_many_bit_parity(oracle, fi):
    """At every decision point of a seeded episode pair (the reference's
    test): bit-equal to the port's numpy featurizer and to the
    reference's jitted one."""
    flags = FLAGS[fi]
    pool = JaxSimPool(2, min_span_ticks=0, device="cpu")
    cfg = rl.RouterConfig(variant="guided", n_instances=3, seed=0)
    envs = [rl.RoutingEnv(cfg, PROF, pool=pool, pool_ep=i)
            for i in range(2)]
    for i, env in enumerate(envs):
        env.reset(reqs(30, seed=40 + i))
    for step in range(25):
        for env in envs:
            a = (int(np.argmax(env.guidance_bonus()[:env.cluster.m]))
                 if env.cluster.central else env.cluster.m)
            env.step(a)
        kw = dict(n_buckets=cfg.n_buckets, alpha=cfg.alpha, **flags)
        args = ([e.cluster for e in envs], [e.profile for e in envs],
                [e.predict_decode for e in envs])
        vec = state_lib.featurize_vec_many(*args, **kw)
        dev = state_lib.featurize_jax_many(*args, **kw)
        np.testing.assert_array_equal(np.stack(dev), np.stack(vec))
        np.testing.assert_array_equal(np.stack(dev), oracle[f"{fi}/{step}"])
    assert pool.n_jax_calls > 0


def test_hybrid_pool_uses_both_paths_with_the_same_results():
    """The registry's default threshold (8 ticks): short spans on the
    numpy rounds, long ones through the round loop, results equal the
    numpy pool's request by request."""
    runs = {}
    for name, pool in (("vec", VecSimPool(3)),
                       ("hybrid", JaxSimPool(3, device="cpu"))):
        streams = [reqs(30, seed=900 + e) for e in range(3)]
        drive_pooled(pool, streams)
        runs[name] = ([stamps(rs) for rs in streams], pool)
    pool = runs["hybrid"][1]
    assert pool.n_jax_calls > 0 and pool.n_numpy_calls > 0
    for got, want in zip(runs["hybrid"][0], runs["vec"][0]):
        assert_stamps_equal(got, want)


def test_serve_gateway_jax_equals_vec(capsys):
    """``--backend jax`` on ``--device cpu`` through the launcher: the
    same served stream and stats as ``--backend vec``."""
    out = {}
    for backend in ("vec", "jax"):
        args = serve.build_parser().parse_args(
            ["--mode", "gateway", "--backend", backend, "--policy", "jsq",
             "--requests", "30", "--rate", "2.5", "--device", "cpu"])
        stats = serve.serve_gateway(args)
        out[backend] = {k: v for k, v in stats.items()
                        if k not in ("wall_s", "decisions_per_s")}
    assert out["jax"] == out["vec"]
    assert out["jax"]["n"] == 30
    if not torch.cuda.is_available():
        args = serve.build_parser().parse_args(
            ["--mode", "gateway", "--backend", "jax", "--requests", "4"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.serve_gateway(args)


@given(seed=st.integers(0, 30), m=st.integers(1, 4),
       chunk=st.sampled_from([0, 64, 256]), fail=st.booleans())
@settings(max_examples=4, deadline=None)
def test_jax_parity_property(seed, m, chunk, fail):
    """Random widths x chunked prefill x failure lanes (the reference's
    ``test_jax_parity_property``): completions, clocks, TTFT and
    preemption counts equal the Python stepper's."""
    do_fail = fail and m > 1

    def drive(make_cluster):
        rs = reqs(50, seed=seed)
        cluster = make_cluster()
        pending = sorted(rs, key=lambda r: r.arrival)
        i, rr, failed, restored = 0, 0, False, False
        while len(cluster.completed) < len(rs) and cluster.t < 3000:
            while i < len(pending) and pending[i].arrival <= cluster.t:
                cluster.enqueue(pending[i])
                i += 1
            if do_fail and cluster.t > 1.0 and not failed:
                cluster.fail_instance(0)
                failed = True
            if do_fail and cluster.t > 2.0 and not restored:
                cluster.instances[0].restore()
                cluster.instances[0].clock = cluster.t
                restored = True
            alive = cluster.alive()
            while cluster.central and alive:
                cluster.route(alive[rr % len(alive)])
                rr += 1
                alive = cluster.alive()
            cluster.advance()
        if getattr(cluster, "is_vec", False):
            cluster.sync_all()
        return rs

    a = drive(lambda: Cluster(PROF, m, chunked_prefill=chunk))
    b = drive(lambda: VecCluster(
        PROF, m, pool=JaxSimPool(1, min_span_ticks=0, device="cpu"),
        chunked_prefill=chunk))
    assert_stamps_equal(stamps(b), stamps(a), exact_tbt=False)
