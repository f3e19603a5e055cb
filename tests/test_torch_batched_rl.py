"""The port's batched multi-episode trainer (``core/batched_rl.py``) and
``training/train_loop.train_router`` against the JAX package's on the
CPU: episode histories equal on the ``py`` and ``vec`` simulators for
both Q-network architectures, on a homogeneous stream and on a
heterogeneous scenario stream, the trained networks within 1e-5, the
best-validation snapshot, a 1-episode batched run against sequential
``evaluate``, the host row packer against ``observe``, and
``train_router`` with a length predictor.  Agents and predictors are
carried from the reference by value; 3 environments, 4 episodes of 40
requests, a 16-row replay batch so that learn steps happen."""
import dataclasses

import jax
import numpy as np
import pytest
from _torch_rl_support import assert_params_close, one_torch_thread  # noqa: F401

from repro.core import batched_rl as ref_b
from repro.core import dqn as ref_dqn
from repro.core import predictor as ref_pred
from repro.core import rl_router as ref_rl
from repro.core import workload as ref_wl
from repro.core.profiles import V100_LLAMA2_7B as REF_V100
from repro.training import train_loop as ref_tl
from repro_torch.core import batched_rl as pt_b
from repro_torch.core import dqn as pt_dqn
from repro_torch.core import predictor as pt_pred
from repro_torch.core import rl_router as pt_rl
from repro_torch.core import workload as pt_wl
from repro_torch.core.profiles import V100_LLAMA2_7B as PT_V100
from repro_torch.serving import obs as pt_obs
from repro_torch.training import train_loop as pt_tl

RTOL = 1e-6          # rewards and latencies (float64 sums of float32 Q)
BATCH = 16
N_REQ = 40
SMALL = dict(seq_len=32, d_model=16, n_heads=2, n_layers=1)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _pair(arch, m_max, variant="guided", **kw):
    cfg_kw = dict(n_instances=3, q_arch=arch, explore_episodes=2, seed=0,
                  variant=variant, **kw)
    ref_cfg, pt_cfg = ref_rl.RouterConfig(**cfg_kw), \
        pt_rl.RouterConfig(**cfg_kw)
    ref = ref_rl.make_agent(ref_cfg, m=m_max)
    pt = pt_rl.make_agent(pt_cfg, m=m_max, device="cpu")
    pt.from_reference(jax.tree.map(np.asarray, ref.params))
    return ref_cfg, pt_cfg, ref, pt


def _homogeneous(wl, prof, samples=False, n=N_REQ):
    def fn(ep):
        smp = wl.generate(n, seed=ep)
        return wl.Scenario.homogeneous(
            prof, 3, wl.to_requests(smp, rate=5.0, seed=ep + 9),
            name=f"paper-{ep}", samples=smp if samples else None)
    return fn


def _streams(hetero):
    if hetero:
        return (ref_wl.scenario_stream(0, n_requests=N_REQ),
                pt_wl.scenario_stream(0, n_requests=N_REQ))
    return _homogeneous(ref_wl, REF_V100), _homogeneous(pt_wl, PT_V100)


def _assert_histories_equal(got, want):
    assert len(got) == len(want)
    for h_r, h_p in zip(want, got, strict=True):
        assert set(h_p) == set(h_r)
        for key, val in h_r.items():
            if isinstance(val, float) and key not in ("epsilon",
                                                      "guide_w"):
                np.testing.assert_allclose(h_p[key], val, rtol=RTOL,
                                           err_msg=key)
            else:
                assert h_p[key] == val, key


@pytest.mark.parametrize("hetero", [False, True], ids=["paper", "hetero"])
@pytest.mark.parametrize("arch", ["decomposed", "mlp"])
@pytest.mark.parametrize("backend", ["py", "vec"])
def test_train_batched_matches_reference(backend, arch, hetero):
    m_max = 6 if hetero else 3
    ref_cfg, pt_cfg, ref, pt = _pair(arch, m_max)
    s_r, s_p = _streams(hetero)
    bk = dict(n_envs=3, m_max=m_max, backend=backend,
              learn_batch_size=BATCH)
    out_r = ref_b.train_batched(ref_cfg, s_r, 4,
                                bcfg=ref_b.BatchedRLConfig(**bk), agent=ref)
    out_p = pt_b.train_batched(pt_cfg, s_p, 4,
                               bcfg=pt_b.BatchedRLConfig(**bk), agent=pt)
    assert out_p["agent"] is pt and pt.cfg.batch_size == BATCH
    _assert_histories_equal(out_p["history"], out_r["history"])
    assert sum(h["n"] for h in out_p["history"]) == 4 * N_REQ
    if hetero:
        assert len({h["m"] for h in out_p["history"]}) > 1
    assert pt.steps == ref.steps > 10
    assert pt.buffer.size == ref.buffer.size
    assert pt.r_mean == pytest.approx(ref.r_mean, rel=RTOL)
    assert pt.rng.bit_generator.state == ref.rng.bit_generator.state
    assert_params_close(pt, ref)


def test_train_batched_prioritized_uncentered_with_telemetry():
    """Prioritized replay over the packed rows (reward centering off, so
    a round's rows go through ``_observe_packed``'s packer), validation
    with the best snapshot restored, and the registry telemetry."""
    ref_cfg, pt_cfg, ref, pt = _pair("decomposed", 3)
    for agent in (ref, pt):
        agent.cfg = dataclasses.replace(agent.cfg, center_rewards=False)
    s_r, s_p = _streams(False)
    bk = dict(n_envs=3, m_max=3, backend="vec", learn_batch_size=BATCH,
              prioritized=True, valid_every=1)
    valid_r = lambda: _homogeneous(ref_wl, REF_V100, n=20)(7)  # noqa
    valid_p = lambda: _homogeneous(pt_wl, PT_V100, n=20)(7)    # noqa
    out_r = ref_b.train_batched(ref_cfg, s_r, 4,
                                bcfg=ref_b.BatchedRLConfig(**bk), agent=ref,
                                valid_fn=valid_r)
    live = pt.params
    reg = pt_obs.MetricsRegistry()
    out_p = pt_b.train_batched(pt_cfg, s_p, 4,
                               bcfg=pt_b.BatchedRLConfig(**bk), agent=pt,
                               valid_fn=valid_p, registry=reg)
    _assert_histories_equal(out_p["history"], out_r["history"])
    assert [h.get("valid_e2e") for h in out_p["history"]] == pytest.approx(
        [h.get("valid_e2e") for h in out_r["history"]], rel=RTOL)
    assert any("valid_e2e" in h for h in out_p["history"])
    assert pt.cfg.prioritized and pt.steps == ref.steps > 10
    # |TD| priorities: float32 TD errors of networks within 1e-5
    np.testing.assert_allclose(pt.buffer.prio[:pt.buffer.size],
                               ref.buffer.prio[:ref.buffer.size],
                               rtol=1e-4)
    # the restored best snapshot is a copy, not the live network
    assert pt.params is not live and pt.target is not pt.params
    for a, b in zip(pt.params.parameters(), pt.target.parameters()):
        assert np.array_equal(a.detach().numpy(), b.detach().numpy())
    assert_params_close(pt, ref)
    prom = reg.to_prometheus()
    assert "rl_episode_reward" in prom and "rl_learn_steps" in prom
    assert reg["rl_learn_steps"] == float(pt.steps)


def _transitions(agent, n=37, seed=3):
    rng = np.random.default_rng(seed)
    d, na = agent.cfg.state_dim, agent.cfg.n_actions
    return [(rng.normal(size=d).astype(np.float32), int(rng.integers(na)),
             float(rng.normal() * 1e3 + 1e-9), rng.normal(size=d).astype(
                 np.float32), float(i % 2), rng.random(na) < 0.7)
            for i in range(n)]


@pytest.mark.parametrize("center", [False, True],
                         ids=["packed", "centered"])
def test_observe_packed_rows_equal_observe(center):
    """A round's rows through ``_observe_packed`` are bit-equal to the
    same transitions through ``observe`` (float64 rewards and done flags
    rounded to float32 alike), and bit-equal to the reference's device
    packer's rows; reward centering keeps the per-transition path."""
    cfg = dataclasses.replace(
        pt_rl.make_agent(pt_rl.RouterConfig(n_instances=3),
                         device="cpu").cfg, center_rewards=center,
        buffer_size=64)
    a, b = (pt_dqn.DQNAgent(cfg, device="cpu") for _ in range(2))
    ref = ref_dqn.DQNAgent(ref_dqn.DQNConfig(**dataclasses.asdict(cfg)))
    trans = _transitions(a)
    for t in trans:
        a.observe(*t)
    pt_b._observe_packed(b, trans[:20])
    pt_b._observe_packed(b, trans[20:])
    pt_b._observe_packed(b, [])
    ref_b._observe_packed(ref, trans[:20])
    ref_b._observe_packed(ref, trans[20:])
    for buf in (b.buffer, ref.buffer):
        assert np.array_equal(buf.data, a.buffer.data)
        assert np.array_equal(buf.prio, a.buffer.prio)
        assert np.array_equal(buf.write_seq, a.buffer.write_seq)
        assert (buf.ptr, buf.size, buf.seq) == \
            (a.buffer.ptr, a.buffer.size, a.buffer.seq)
    assert b.r_mean == a.r_mean
    if not center:
        rows = pt_b._pack_rows(trans)
        assert rows.dtype == np.float32
        assert np.array_equal(rows, a.buffer.data[:len(trans)])


@pytest.mark.parametrize("backend", ["py", "vec"])
@pytest.mark.parametrize("arch,variant", [("decomposed", "guided"),
                                          ("mlp", "baseline")])
def test_single_episode_batched_run_matches_sequential_evaluate(
        arch, variant, backend):
    _, cfg, _, agent = _pair(arch, 3, variant=variant)
    reqs_seq = _homogeneous(pt_wl, PT_V100, n=80)(7).requests
    scn = _homogeneous(pt_wl, PT_V100, n=80)(7)
    seq = pt_rl.evaluate(cfg, PT_V100, agent, reqs_seq)
    seq_b = pt_rl.evaluate(cfg, PT_V100, agent,
                           _homogeneous(pt_wl, PT_V100, n=80)(7).requests,
                           backend=backend)
    bat = pt_b.evaluate_scenarios(cfg, agent, [scn], backend=backend)[0]
    assert seq["n"] == bat["n"] == 80
    for a, b in zip(reqs_seq, scn.requests):
        assert (a.finished, a.instance, a.preemptions) == \
            (b.finished, b.instance, b.preemptions)
    for key in ("e2e_mean", "ttft_mean", "makespan", "preemptions",
                "router_wait_mean", "spikes"):
        assert seq[key] == bat[key] == seq_b[key], key


def test_evaluate_scenarios_matches_reference():
    ref_cfg, pt_cfg, ref, pt = _pair("decomposed", 6)
    s_r, s_p = _streams(True)
    want = ref_b.evaluate_scenarios(ref_cfg, ref, [s_r(i) for i in range(3)],
                                    m_max=6, backend="vec")
    got = pt_b.evaluate_scenarios(pt_cfg, pt, [s_p(i) for i in range(3)],
                                  m_max=6, backend="vec")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, val in w.items():
            if isinstance(val, float):
                np.testing.assert_allclose(g[key], val, rtol=RTOL,
                                           err_msg=key)
            else:
                assert g[key] == val, key


def test_scenario_wider_than_m_max_raises():
    _, cfg, _, agent = _pair("decomposed", 3)
    wide = pt_wl.Scenario.homogeneous(PT_V100, 4, [])
    with pytest.raises(ValueError, match="raise BatchedRLConfig.m_max"):
        pt_b.train_batched(cfg, lambda ep: wide, 1,
                           bcfg=pt_b.BatchedRLConfig(m_max=3), agent=agent)


@pytest.fixture(scope="module")
def predictors():
    """A small reference predictor, trained once, and the port's copy."""
    ref = ref_pred.BucketPredictor(ref_pred.PredictorConfig(**SMALL),
                                   REF_V100, seed=0)
    ref.fit(ref_wl.generate(256, seed=1), epochs=1, seed=2)
    pt = pt_pred.BucketPredictor(pt_pred.PredictorConfig(**SMALL),
                                 PT_V100, device="cpu")
    pt.from_reference(jax.tree.map(np.asarray, ref.params))
    return ref, pt


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "sequential"])
def test_train_router_with_a_length_predictor_matches_reference(
        batched, predictors):
    ref_cfg, pt_cfg, ref, pt = _pair("decomposed", 3, nstep=8,
                                     learn_every=2)
    if not batched:
        for agent in (ref, pt):
            agent.cfg = dataclasses.replace(agent.cfg, batch_size=BATCH)
    pred_r, pred_p = predictors
    bk = dict(n_envs=3, m_max=3, backend="vec", learn_batch_size=BATCH)
    out_r = ref_tl.train_router(
        ref_cfg, _homogeneous(ref_wl, REF_V100, samples=True), 3,
        batched=batched, batch_cfg=ref_b.BatchedRLConfig(**bk), agent=ref,
        length_predictor=pred_r,
        valid_fn=lambda: _homogeneous(ref_wl, REF_V100, samples=True,
                                      n=20)(9))
    out_p = pt_tl.train_router(
        pt_cfg, _homogeneous(pt_wl, PT_V100, samples=True), 3,
        batched=batched, batch_cfg=pt_b.BatchedRLConfig(**bk), agent=pt,
        length_predictor=pred_p,
        valid_fn=lambda: _homogeneous(pt_wl, PT_V100, samples=True,
                                      n=20)(9), device="cpu")
    assert out_p["agent"] is pt
    _assert_histories_equal(out_p["history"], out_r["history"])
    assert pt.steps == ref.steps > 0
    assert_params_close(pt, ref)
    with pytest.raises(ValueError, match="either predict_decode"):
        pt_tl.train_router(pt_cfg, _homogeneous(pt_wl, PT_V100), 1,
                           length_predictor=pred_p,
                           predict_decode=lambda r: 1, device="cpu")


def test_train_router_sequential_refuses_heterogeneous_streams():
    _, cfg, _, agent = _pair("decomposed", 3)
    with pytest.raises(ValueError, match="homogeneous"):
        pt_tl.train_router(cfg, pt_wl.scenario_stream(0, n_requests=10), 1,
                           batched=False, agent=agent)


def test_train_batched_builds_its_agent_on_the_card_by_default():
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present: the agent runs on it")
    _, cfg, _, _ = _pair("decomposed", 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_b.train_batched(cfg, _homogeneous(pt_wl, PT_V100, n=5), 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_tl.train_router(cfg, _homogeneous(pt_wl, PT_V100, n=5), 1)
