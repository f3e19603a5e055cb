"""The port's DQN learning half against the JAX package's, on the CPU.

``train_batch`` (one step: loss, ``td_abs``, params, Adam moments,
target, step) to 1e-5 of each tree's scale, for the mlp and the
decomposed Q-network, under uniform and prioritized-replay weights; the
replay buffer and prioritized replay (sampled indices, IS weights,
priorities, dropped updates for overwritten slots) exactly; ``learn``
over several steps drawing the same rows from the same numpy stream;
reward centring and telemetry; and a bit-exact resume from
``full_state``.  Networks are carried from the reference by value."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dqn as ref_dqn
from repro.core import rl_router as ref_rl
from repro_torch.core import dqn as pt_dqn
from repro_torch.core import rl_router as pt_rl
from repro_torch.training import checkpoint as pt_ckpt

RTOL = 1e-5


def _cfg(mod, arch, **over):
    kw = dict(state_dim=3 * 7 + 5, n_actions=4, hidden=(16, 16),
              lr=3e-4, gamma=0.997, batch_size=32, buffer_size=64,
              q_arch=arch)
    if arch == "decomposed":
        kw.update(inst_dims=7, router_dims=5)
    kw.update(over)
    return mod.DQNConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch, **over):
    ref = ref_dqn.DQNAgent(_cfg(ref_dqn, arch, **over), seed=0)
    pt = pt_dqn.DQNAgent(_cfg(pt_dqn, arch, **over), seed=0, device="cpu")
    pt.from_reference(_np(ref.params))
    return ref, pt


def _assert_tree_close(got, want, what):
    """Torch/numpy tree against a reference tree: same keys, each leaf
    within RTOL of the largest magnitude in the tree."""
    got = pt_ckpt._flatten(got)
    want = pt_ckpt._flatten(_np(want))
    assert list(got) == list(want), what
    scale = max(float(np.abs(v).max()) for v in want.values())
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                   atol=RTOL * scale,
                                   err_msg=f"{what}/{key}")


def _batch(d, n_actions, rows=64, weights="uniform", seed=1):
    rng = np.random.default_rng(seed)
    b = np.zeros((rows, 2 * d + 4 + n_actions), np.float32)
    b[:, :2 * d] = rng.standard_normal((rows, 2 * d))
    b[:, 2 * d] = rng.integers(0, n_actions, rows)
    b[:, 2 * d + 1] = rng.standard_normal(rows) * 3
    b[:, 2 * d + 2] = rng.random(rows) < 0.3
    b[:, 2 * d + 3:2 * d + 3 + n_actions] = rng.random(
        (rows, n_actions)) < 0.7
    b[:, 2 * d + 2 + n_actions] = 1.0          # defer is always valid
    b[:, -1] = 1.0 if weights == "uniform" else rng.random(rows) + 0.05
    return b


def test_config_has_every_reference_field():
    names = [f.name for f in dataclasses.fields(pt_dqn.DQNConfig)]
    assert names == [f.name for f in dataclasses.fields(ref_dqn.DQNConfig)]
    assert pt_dqn.DQNConfig(3, 2) == pt_dqn.DQNConfig(
        **dataclasses.asdict(ref_dqn.DQNConfig(3, 2)))


@pytest.mark.parametrize("arch", ["mlp", "decomposed"])
def test_make_agent_passes_the_learning_fields(arch):
    for kw in ({}, {"potential_shaping": True, "gamma": 0.9, "lr": 1e-2}):
        ref = ref_rl.make_agent(ref_rl.RouterConfig(q_arch=arch, **kw))
        pt = pt_rl.make_agent(pt_rl.RouterConfig(q_arch=arch, **kw),
                              device="cpu")
        assert dataclasses.asdict(pt.cfg) == dataclasses.asdict(ref.cfg)


@pytest.mark.parametrize("weights", ["uniform", "per"])
@pytest.mark.parametrize("arch", ["mlp", "decomposed"])
def test_train_batch_one_step_matches_reference(arch, weights):
    ref, pt = _pair(arch)
    cfg = ref.cfg
    batch = _batch(cfg.state_dim, cfg.n_actions, weights=weights)
    params, opt, target, loss, td = ref_dqn.train_batch(
        cfg, ref.params, ref.opt, ref.target, jnp.asarray(batch))
    loss_pt, td_pt = pt_dqn.train_batch(pt.cfg, pt.params, pt.opt,
                                        pt.target, torch.from_numpy(batch))
    np.testing.assert_allclose(float(loss_pt), float(loss), rtol=RTOL)
    td = np.asarray(td)
    np.testing.assert_allclose(td_pt.numpy(), td, rtol=RTOL,
                               atol=RTOL * float(np.abs(td).max()))
    st = pt.state_dict()
    _assert_tree_close(st["params"], params, "params")
    _assert_tree_close(st["target"], target, "target")
    _assert_tree_close(st["opt"]["m"], opt["m"], "m")
    _assert_tree_close(st["opt"]["v"], opt["v"], "v")
    assert st["opt"]["step"].dtype == torch.int32
    assert st["opt"]["step"].shape == () and int(st["opt"]["step"]) == \
        int(opt["step"]) == 1


@pytest.mark.parametrize("arch", ["mlp", "decomposed"])
def test_train_batch_bootstrapped_target_and_huber_tails(arch):
    """A large-reward batch (|TD| past huber_delta) with done=0 rows, so
    the double-DQN target and both Huber branches carry the step."""
    ref, pt = _pair(arch, huber_delta=0.5)
    cfg = ref.cfg
    batch = _batch(cfg.state_dim, cfg.n_actions, seed=4)
    batch[:32, 2 * cfg.state_dim + 1] *= 10
    batch[32:, 2 * cfg.state_dim + 1] = 0.0
    p0 = pt_ckpt._flatten(_np(ref.params))
    params, opt, _, loss, td = ref_dqn.train_batch(
        cfg, ref.params, ref.opt, ref.target, jnp.asarray(batch))
    assert float(jnp.max(td)) > 0.5 > float(jnp.min(td))
    loss_pt, _ = pt_dqn.train_batch(pt.cfg, pt.params, pt.opt,
                                    pt.target, torch.from_numpy(batch))
    np.testing.assert_allclose(float(loss_pt), float(loss), rtol=RTOL)
    st = pt.state_dict()
    _assert_tree_close(st["opt"]["m"], opt["m"], "m")
    # Adam's first step moves a parameter by lr * g / (|g| + 1e-8): where
    # the gradient is at rounding level (|g| < 1e-6, e.g. a bias behind
    # a unit that almost never fires) the step is any value in [-lr, lr]
    # in either framework, so there it is held to that bound only
    got = pt_ckpt._flatten(st["params"])
    want = pt_ckpt._flatten(_np(params))
    grad = {k: np.abs(v) / 0.1 for k, v in
            pt_ckpt._flatten(_np(opt["m"])).items()}
    scale = max(float(np.abs(v).max()) for v in want.values())
    for key in want:
        sure = grad[key] >= 1e-6
        np.testing.assert_allclose(got[key][sure], want[key][sure],
                                   rtol=RTOL, atol=RTOL * scale,
                                   err_msg=key)
        assert np.all(np.abs(got[key] - p0[key])[~sure]
                      <= cfg.lr * (1 + RTOL)), key


def _fill(agents, n, seed=2, d=None, n_actions=4):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        s = rng.standard_normal(d).astype(np.float32)
        s2 = rng.standard_normal(d).astype(np.float32)
        mask = rng.random(n_actions) < 0.7
        mask[-1] = True
        a, r = int(rng.integers(0, n_actions)), float(rng.normal() * 5)
        done = float(rng.random() < 0.2)
        for agent in agents:
            agent.observe(s, a, r, s2, done, mask)


def test_replay_buffer_and_per_match_reference():
    cfg_r, cfg_p = _cfg(ref_dqn, "mlp"), _cfg(pt_dqn, "mlp")
    rb, pb = ref_dqn.ReplayBuffer(cfg_r), pt_dqn.ReplayBuffer(cfg_p)
    d = cfg_r.state_dim
    rng = np.random.default_rng(0)
    for i in range(90):                       # wraps the 64-slot ring
        row = (rng.standard_normal(d), int(rng.integers(0, 4)),
               float(rng.normal()), rng.standard_normal(d), 0.0,
               rng.random(4) < 0.5)
        rb.add(*row)
        pb.add(*row)
        if i == 40:
            rows = rng.standard_normal((70, rb.data.shape[1]))
            rb.add_rows(rows)
            pb.add_rows(rows)
    for name in ("data", "prio", "write_seq"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(rb, name))
    assert (pb.ptr, pb.size, pb.seq, pb.max_prio) == (
        rb.ptr, rb.size, rb.seq, rb.max_prio)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(pb.sample(r2, 16), rb.sample(r1, 16))
    rows_r, idx_r = rb.sample_prioritized(r1, 16, 0.6, 0.4)
    rows_p, idx_p = pb.sample_prioritized(r2, 16, 0.6, 0.4)
    np.testing.assert_array_equal(idx_p, idx_r)
    np.testing.assert_array_equal(rows_p, rows_r)     # IS weight column
    stamps = rb.write_seq[idx_r].copy()
    td = np.abs(np.random.default_rng(6).normal(size=16)) * 3
    # overwrite some sampled slots before the deferred update lands
    for buf in (rb, pb):
        buf.add(np.ones(d), 1, 0.0, np.ones(d), 0.0, np.ones(4, bool))
        buf.add(np.ones(d), 2, 0.0, np.ones(d), 0.0, np.ones(4, bool))
        buf.update_priorities(idx_r, td, eps=1e-3, expect_seq=stamps)
    np.testing.assert_array_equal(pb.prio, rb.prio)
    assert pb.max_prio == rb.max_prio
    dropped = rb.write_seq[idx_r] != stamps
    assert dropped.any() and not dropped.all()


@pytest.mark.parametrize("prioritized", [False, True])
@pytest.mark.parametrize("arch", ["mlp", "decomposed"])
def test_learn_steps_draw_the_same_rows(arch, prioritized):
    ref, pt = _pair(arch, prioritized=prioritized)
    _fill([ref, pt], 50, d=ref.cfg.state_dim)
    assert pt.r_mean == ref.r_mean and pt._r_init == ref._r_init
    np.testing.assert_array_equal(pt.buffer.data, ref.buffer.data)
    for _ in range(5):
        state_r = ref.rng.bit_generator.state
        loss_r = ref.learn()
        loss_p = pt.learn()
        assert pt.rng.bit_generator.state == ref.rng.bit_generator.state \
            != state_r
        np.testing.assert_allclose(loss_p, loss_r, rtol=RTOL)
    # priorities come from |TD|: equal to RTOL under PER, untouched else
    np.testing.assert_allclose(pt.buffer.prio, ref.buffer.prio,
                               rtol=RTOL if prioritized else 0)
    assert pt.steps == ref.steps == 5
    _assert_tree_close(pt.state_dict()["params"], ref.params, "params")
    _assert_tree_close(pt.state_dict()["target"], ref.target, "target")
    t_ref, t_pt = ref.telemetry(), pt.telemetry()
    assert list(t_pt) == list(t_ref)
    for key in t_ref:
        np.testing.assert_allclose(t_pt[key], t_ref[key], rtol=RTOL,
                                   err_msg=key)


def test_learn_waits_for_a_full_batch_and_sync_false_defers():
    ref, pt = _pair("decomposed", prioritized=True)
    _fill([ref, pt], 31, d=ref.cfg.state_dim)
    assert pt.learn() is None and ref.learn() is None   # 31 < 32
    _fill([ref, pt], 5, seed=3, d=ref.cfg.state_dim)
    assert pt.learn(sync=False) is None and ref.learn(sync=False) is None
    assert pt._pending_prio is not None
    pt.learn()
    ref.learn()
    np.testing.assert_allclose(pt.buffer.prio, ref.buffer.prio, rtol=RTOL)
    assert pt._pending_prio is None


def test_full_state_resume_is_bit_exact(tmp_path):
    def run(agent, n):
        for _ in range(n):
            agent.learn()
            _fill([agent], 3, seed=agent.steps, d=agent.cfg.state_dim)
    a = pt_dqn.DQNAgent(_cfg(pt_dqn, "decomposed", prioritized=True),
                        seed=4, device="cpu")
    _fill([a], 40, d=a.cfg.state_dim)
    run(a, 3)
    pt_ckpt.save_learner(str(tmp_path), 3, a)
    b = pt_dqn.DQNAgent(_cfg(pt_dqn, "decomposed", prioritized=True),
                        seed=9, device="cpu")
    assert pt_ckpt.restore_learner(str(tmp_path), b) == 3
    run(a, 4)
    run(b, 4)
    for x, y in zip(pt_ckpt._flatten(a.full_state()[0]).values(),
                    pt_ckpt._flatten(b.full_state()[0]).values()):
        assert np.array_equal(x, y)
    assert a.full_state()[1] == b.full_state()[1]


def test_restore_learner_warm_starts_from_a_params_only_artifact(
        tmp_path):
    a = pt_dqn.DQNAgent(_cfg(pt_dqn, "mlp"), seed=1, device="cpu")
    _fill([a], 40, d=a.cfg.state_dim)
    a.learn()
    mgr = pt_ckpt.CheckpointManager(str(tmp_path))
    try:
        mgr.save(11, a.state_dict(), sync=True)
    finally:
        mgr.close()
    b = pt_dqn.DQNAgent(_cfg(pt_dqn, "mlp"), seed=2, device="cpu")
    assert pt_ckpt.restore_learner(str(tmp_path), b) == 11
    for x, y in zip(pt_ckpt._flatten(a.state_dict()).values(),
                    pt_ckpt._flatten(b.state_dict()).values()):
        assert np.array_equal(x, y)
    assert b.buffer.size == 0
    assert pt_ckpt.restore_learner(str(tmp_path / "none"), b) is None
