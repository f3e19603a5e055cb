"""The port's online learner in the gateway (``training/online.py``)
against the JAX package's on the CPU: the recorded transition stream
over the ``py`` and ``vec`` simulators on a drift stream (to 1e-6), the
frozen-policy equivalence, learner steps, publishes and transitions
with learning on, the guardrail, publishes as snapshots, exact resume
from a full learner checkpoint and a warm start from a
reference-written one.  Agents are carried from the reference by
value; streams of 60-160 requests on 3 instances."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_rl_support import assert_params_close, one_torch_thread  # noqa: F401

from repro.core import dqn as ref_dqn
from repro.core import rl_router as ref_rl
from repro.core import workload as ref_wl
from repro.core.profiles import V100_LLAMA2_7B as REF_V100
from repro.serving import gateway as ref_gw
from repro.serving import policies as ref_pol
from repro.serving import request as ref_req
from repro.training import checkpoint as ref_ckpt
from repro.training import online as ref_online
from repro_torch.core import dqn as pt_dqn
from repro_torch.core import rl_router as pt_rl
from repro_torch.core import workload as pt_wl
from repro_torch.core.profiles import V100_LLAMA2_7B as PT_V100
from repro_torch.serving import gateway as pt_gw
from repro_torch.serving import policies as pt_pol
from repro_torch.serving import request as pt_req
from repro_torch.training import checkpoint as pt_ckpt
from repro_torch.training import online as pt_online

RTOL = 1e-6

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _rcfg(rl, m=3, **kw):
    kw.setdefault("include_health_features", True)
    return rl.RouterConfig(variant="guided", n_instances=m,
                           q_arch="decomposed", seed=0, **kw)


def _agents(batch_size=None, m=3):
    """A reference agent and the port's with the same weights; with
    ``batch_size`` both learn from that many rows out of a 4096-row
    replay buffer (so that learn steps come early and checkpoints stay
    small)."""
    ref = ref_rl.make_agent(_rcfg(ref_rl, m), m=m)
    if batch_size:
        cfg = dataclasses.replace(ref.cfg, batch_size=batch_size,
                                  buffer_size=4096)
        params = ref.params
        ref = ref_dqn.DQNAgent(cfg, seed=0)
        ref.params = ref.target = params
        pt = pt_dqn.DQNAgent(pt_dqn.DQNConfig(**dataclasses.asdict(cfg)),
                             seed=0, device="cpu")
    else:
        pt = pt_rl.make_agent(_rcfg(pt_rl, m), m=m, device="cpu")
    pt.from_reference(jax.tree.map(np.asarray, ref.params))
    return ref, pt


def _clone(req, reqs):
    return [req.Request(prompt_tokens=r.prompt_tokens,
                        decode_tokens=r.decode_tokens, arrival=r.arrival,
                        task=r.task, tenant=r.tenant) for r in reqs]


def _spy(tr):
    rows = []
    orig = tr._pack

    def spy(t, s2, mask2, done=1.0):
        rows.append((np.array(t[0]), int(t[1]), float(t[2]),
                     np.array(s2), np.array(mask2), float(done)))
        orig(t, s2, mask2, done)
    tr._pack = spy
    return rows


def _serve(gw, req, tr, scn, backend, drift=True, **gw_kw):
    if drift:
        gw_kw.update(chaos=scn.meta["chaos"], failover=True)
    g = gw.Gateway(gw.GatewayConfig(backend=backend, **gw_kw),
                   scn.profiles, tr.policy, length=gw.OracleLength())
    reqs = _clone(req, scn.requests)
    return g.run(reqs), reqs


def _drift(wl, prof, n=160, rate=14.0, seed=9):
    return wl.make_drift_scenario(seed=seed, n_requests=n, rate=rate,
                                  profiles=(prof,) * 3)


def _run_pair(backend, ocfg_kw, batch_size=None, drift=True, **rcfg_kw):
    ref_a, pt_a = _agents(batch_size)
    tr_r = ref_online.OnlineTrainer(_rcfg(ref_rl, **rcfg_kw),
                                    ref_online.OnlineConfig(**ocfg_kw),
                                    agent=ref_a)
    tr_p = pt_online.OnlineTrainer(_rcfg(pt_rl, **rcfg_kw),
                                   pt_online.OnlineConfig(**ocfg_kw),
                                   agent=pt_a, device="cpu")
    rows_r, rows_p = _spy(tr_r), _spy(tr_p)
    if drift:
        scn_r, scn_p = _drift(ref_wl, REF_V100), _drift(pt_wl, PT_V100)
    else:
        scn_r = ref_wl.make_tenant_scenario(
            seed=3, n_requests=80, rate=20.0, pattern="bursty",
            profiles=(REF_V100,) * 3)
        scn_p = pt_wl.make_tenant_scenario(
            seed=3, n_requests=80, rate=20.0, pattern="bursty",
            profiles=(PT_V100,) * 3)
    want = _serve(ref_gw, ref_req, tr_r, scn_r, backend, drift)
    got = _serve(pt_gw, pt_req, tr_p, scn_p, backend, drift)
    return (tr_r, rows_r, want), (tr_p, rows_p, got)


def _assert_rows_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[0], b[0])          # s
        np.testing.assert_array_equal(a[3], b[3])          # s2
        np.testing.assert_array_equal(a[4], b[4])          # mask2
        assert (a[1], a[5]) == (b[1], b[5])                # action, done
        assert a[2] == pytest.approx(b[2], rel=RTOL, abs=1e-9)


@pytest.mark.parametrize("backend", ["py", "vec"])
def test_shadow_transitions_match_reference_under_drift(backend):
    """learn=False, eps=0, guard off: the transition stream the port
    records over the drift scenario (the mid-stream flip, a straggler
    and a crash with failover) equals the reference's."""
    (tr_r, rows_r, (st_r, reqs_r)), (tr_p, rows_p, (st_p, reqs_p)) = \
        _run_pair(backend, dict(learn=False, eps=0.0, guard=False))
    assert st_p["orphaned"] == st_r["orphaned"] > 0
    _assert_rows_equal(rows_p, rows_r)
    assert [(r.instance, r.finished) for r in reqs_p] == \
        [(r.instance, r.finished) for r in reqs_r]
    assert tr_p.transitions == tr_r.transitions == len(rows_p)
    assert tr_p.agent.buffer.size == tr_r.agent.buffer.size
    np.testing.assert_allclose(
        tr_p.agent.buffer.data[:tr_p.agent.buffer.size],
        tr_r.agent.buffer.data[:tr_r.agent.buffer.size], rtol=RTOL,
        atol=1e-9)


def test_shadow_recorder_decides_as_a_frozen_policy():
    """With learning, exploration and the guardrail off the online policy
    routes exactly as a frozen ``RLPolicy`` over the same weights, on
    both simulators, while it records."""
    out = []
    for backend in ("py", "vec"):
        _, pt_a = _agents()
        frozen = pt_pol.RLPolicy(pt_a, _rcfg(pt_rl))
        _, pt_b = _agents()
        tr = pt_online.OnlineTrainer(
            _rcfg(pt_rl), pt_online.OnlineConfig(learn=False, eps=0.0,
                                                 guard=False),
            agent=pt_b, device="cpu")
        scn = pt_wl.make_tenant_scenario(seed=5, n_requests=120, rate=16.0,
                                         pattern="bursty",
                                         profiles=(PT_V100,) * 3)
        runs = []
        for policy in (frozen, tr.policy):
            g = pt_gw.Gateway(pt_gw.GatewayConfig(backend=backend),
                              scn.profiles, policy,
                              length=pt_gw.OracleLength())
            reqs = _clone(pt_req, scn.requests)
            g.run(reqs)
            runs.append([(r.instance, r.finished) for r in reqs])
        assert runs[0] == runs[1]
        assert tr.transitions > 0 and tr.agent.steps == 0
        out.append(runs[0])
    assert out[0] == out[1]


@pytest.mark.parametrize("backend", ["py", "vec"])
def test_learning_matches_reference(backend):
    """Learning on (8-step returns, a 16-row replay batch, guided
    exploration, the guardrail): learner steps, publishes, transitions, explorations and
    fallback entries equal the reference's, and the learned network
    stays within 1e-5 of it."""
    (tr_r, rows_r, (st_r, _)), (tr_p, rows_p, (st_p, _)) = _run_pair(
        backend, dict(seed=0, eps=0.05, publish_every=20), batch_size=16,
        drift=False, nstep=8)
    assert st_p["n"] == st_r["n"] == 80
    for key in ("steps",):
        assert getattr(tr_p.agent, key) == getattr(tr_r.agent, key) > 20
    t_r, t_p = tr_r.telemetry(), tr_p.telemetry()
    for key in ("decisions", "explored", "forced", "fallback_decisions",
                "fallback_entries", "transitions", "publishes", "mode",
                "learn_steps", "replay_size"):
        assert t_p[key] == t_r[key], key
    assert t_p["publishes"] > 2 and t_p["explored"] > 0
    _assert_rows_equal(rows_p, rows_r)
    assert_params_close(tr_p.agent, tr_r.agent)
    # the served network is the last publish: equal to the learner's,
    # but its own copy
    served = tr_p.policy.agent.params
    assert served is not tr_p.agent.params
    for a, b in zip(served.parameters(), tr_p.agent.params.parameters()):
        assert torch.equal(a, b)


def _filled(agent, n=200, seed=0):
    rng = np.random.default_rng(seed)
    d, na = agent.cfg.state_dim, agent.cfg.n_actions
    for _ in range(n):
        agent.observe(rng.normal(size=d).astype(np.float32),
                      int(rng.integers(na)), float(rng.normal()),
                      rng.normal(size=d).astype(np.float32), 1.0,
                      np.ones(na, bool))
    return agent


def _params(net):
    return [p.detach().clone() for p in net.parameters()]


def test_a_publish_is_a_snapshot():
    """The learner updates its network in place: after a publish, learn
    steps must leave the served network unchanged, and the next publish
    makes it equal to the learner's again."""
    _, pt_a = _agents(batch_size=16)
    tr = pt_online.OnlineTrainer(_rcfg(pt_rl), pt_online.OnlineConfig(),
                                 agent=_filled(pt_a), device="cpu")
    served = tr.policy.agent
    assert served is tr.serve_agent and served.buffer is tr.agent.buffer
    assert served.params is not tr.agent.params
    assert served.target is not tr.agent.target
    published = _params(served.params)
    for a, b in zip(published, tr.agent.params.parameters()):
        assert torch.equal(a, b)
    for _ in range(3):
        tr.agent.learn(sync=False)
    assert tr.agent.steps == 3
    for a, b, c in zip(published, served.params.parameters(),
                       tr.agent.params.parameters()):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, c) for a, c in
               zip(published, tr.agent.params.parameters()))
    tr._publish()
    assert tr.publishes == 1
    for a, b in zip(served.params.parameters(),
                    tr.agent.params.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(served.target.parameters(),
                    tr.agent.target.parameters()):
        assert torch.equal(a, b)
    tr.agent.learn()
    assert any(not torch.equal(a, b) for a, b in
               zip(served.params.parameters(),
                   tr.agent.params.parameters()))


def test_guardrail_trips_to_mixing_and_recovers():
    """An adversarial Q-head (argmin of the guidance bonus) trips the
    regret guardrail; during fallback decisions follow the mixing
    argmax; after the cooldown the trainer re-probes the Q-head -- as
    the reference's does, counter for counter."""
    out = []
    for rl, online, wl, gw, req, prof, kw in (
            (ref_rl, ref_online, ref_wl, ref_gw, ref_req, REF_V100, {}),
            (pt_rl, pt_online, pt_wl, pt_gw, pt_req, PT_V100,
             {"device": "cpu"})):
        tr = online.OnlineTrainer(_rcfg(rl), online.OnlineConfig(
            learn=False, eps=0.0, guard=True, guard_window=8,
            guard_regret=1e-4, guard_cooldown=3.0), **kw)

        class _Adversary:
            cfg = tr.serve_agent.cfg

            def act(self, s, mask, epsilon=0.0, prior=None, q_squash=0.0):
                bonus = prior if prior is not None else np.zeros(len(mask))
                return int(np.argmin(np.where(mask, bonus, np.inf)))
        tr.policy.agent = _Adversary()
        tr.serve_agent = tr.policy.agent
        scn = wl.make_tenant_scenario(seed=2, n_requests=150, rate=16.0,
                                      pattern="bursty",
                                      profiles=(prof,) * 3)
        g = gw.Gateway(gw.GatewayConfig(), scn.profiles, tr.policy,
                       length=gw.OracleLength())
        reqs = _clone(req, scn.requests)
        stats = g.run(reqs)
        assert stats["n"] == 150
        out.append((tr.fallback_entries, tr.fallback_decisions, tr.mode,
                    [(r.instance, r.finished) for r in reqs]))
    assert out[1] == out[0]
    entries, decisions, mode, _ = out[1]
    assert entries >= 1 and decisions > 0
    assert entries > 1 or mode == "rl"


def test_checkpoints_resume_exactly_and_the_writer_is_closed(tmp_path):
    """A learner checkpointed by the online trainer (periodically and at
    run end) restores into a fresh trainer with everything equal --
    networks, optimizer, replay, centering EMA, RNG -- and both then
    learn identically; the writer thread stops at run end."""
    _, pt_a = _agents(batch_size=16)
    ckpt = str(tmp_path / "learner")
    tr = pt_online.OnlineTrainer(_rcfg(pt_rl, nstep=8),
                                 pt_online.OnlineConfig(
                                     checkpoint_dir=ckpt,
                                     checkpoint_every=40, seed=0),
                                 agent=pt_a, device="cpu")
    scn = pt_wl.make_tenant_scenario(seed=3, n_requests=60, rate=20.0,
                                     pattern="bursty",
                                     profiles=(PT_V100,) * 3)
    g = pt_gw.Gateway(pt_gw.GatewayConfig(backend="vec"), scn.profiles,
                      tr.policy, length=pt_gw.OracleLength())
    mgr = tr._mgr              # the gateway binds the trainer at init
    assert mgr is not None and mgr._thread.is_alive()
    g.run(_clone(pt_req, scn.requests))
    assert mgr is not None and tr._mgr is None
    assert not mgr._thread.is_alive()
    assert tr.agent.steps > 20
    _, fresh_a = _agents(batch_size=16)
    fresh = pt_online.OnlineTrainer(
        _rcfg(pt_rl), pt_online.OnlineConfig(warm_start=ckpt),
        agent=fresh_a, device="cpu")
    assert fresh.warm_started_step == tr.agent.steps
    a, b = tr.agent, fresh.agent
    tree_a, extra_a = a.full_state()
    tree_b, extra_b = b.full_state()
    assert extra_a == extra_b
    flat_a, flat_b = pt_ckpt._flatten(tree_a), pt_ckpt._flatten(tree_b)
    assert list(flat_a) == list(flat_b)
    for key in flat_a:
        assert np.array_equal(flat_a[key], flat_b[key]), key
    for p, q in zip(fresh.policy.agent.params.parameters(),
                    b.params.parameters()):
        assert torch.equal(p, q)
    for _ in range(3):
        assert a.learn() == b.learn()
    for p, q in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(p, q)
    tr.close()


def test_warm_start_from_a_reference_checkpoint(tmp_path, monkeypatch):
    """A full learner checkpoint the reference writes (its ``ZLB0`` zlib
    form) warm-starts the port's online trainer."""
    monkeypatch.setattr(ref_ckpt, "zstandard", None)
    ref_a, pt_a = _agents(batch_size=16)
    _filled(ref_a, n=100)
    for _ in range(2):
        ref_a.learn()
    ref_ckpt.save_learner(str(tmp_path / "warm"), step=11, agent=ref_a)
    fresh = pt_dqn.DQNAgent(pt_a.cfg, seed=5, device="cpu")
    tr = pt_online.OnlineTrainer(
        _rcfg(pt_rl), pt_online.OnlineConfig(warm_start=str(
            tmp_path / "warm")), agent=fresh, device="cpu")
    assert tr.warm_started_step == 11
    got = pt_ckpt._flatten(tr.agent.params.tree())
    want = pt_ckpt._flatten(jax.tree.map(np.asarray, ref_a.params))
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    assert tr.agent.buffer.size == ref_a.buffer.size == 100
    assert tr.agent.rng.bit_generator.state == \
        ref_a.rng.bit_generator.state
    served = pt_ckpt._flatten(tr.policy.agent.params.tree())
    for key in want:
        assert np.array_equal(served[key], want[key]), key
    assert tr.policy.agent.params is not tr.agent.params


def test_online_refuses_the_engine_backend():
    tr = pt_online.OnlineTrainer(_rcfg(pt_rl, m=1), m=1, device="cpu")

    class _EngineView:                 # no on_token hook surface
        pass

    class _Cluster:
        is_vec = False
        instances = (_EngineView(),)

    class _Gateway:
        cluster = _Cluster()

    with pytest.raises(ValueError, match="py or vec simulator backend"):
        tr.bind(_Gateway())


def test_online_trainer_builds_its_learner_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the learner runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_online.OnlineTrainer(_rcfg(pt_rl))
    tr = pt_online.OnlineTrainer(_rcfg(pt_rl), device="cpu")
    assert tr.serve_agent.device == tr.agent.device == torch.device("cpu")


def test_online_config_has_every_reference_field():
    assert [f.name for f in dataclasses.fields(pt_online.OnlineConfig)] == \
        [f.name for f in dataclasses.fields(ref_online.OnlineConfig)]
    assert dataclasses.asdict(pt_online.OnlineConfig()) == \
        dataclasses.asdict(ref_online.OnlineConfig())
    assert ref_pol.RLPolicy.name == pt_pol.RLPolicy.name
