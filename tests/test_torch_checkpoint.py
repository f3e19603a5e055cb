"""The port's checkpoint format against the JAX package's.

A checkpoint written by the reference restores into the port and one
written by the port restores into the reference, leaves bit-equal
(dtype, shape and bytes), for the ``state_dict`` and ``full_state``
trees of an mlp and a decomposed agent.  The reference writes its zlib
fallback (``zstandard`` switched off for it), the only compression the
port reads.  Also: the fall-back past a corrupt newest file, keep-3 GC,
the writer thread's lifetime, and the port's own msgpack codec against
``msgpack`` itself (imported only here).  Every manager a test opens is
closed in a ``finally``."""
import os

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.core import cluster_manager as ref_cm
from repro.core import dqn as ref_dqn
from repro.core import rl_router as ref_rl
from repro.core.profiles import V100_LLAMA2_7B as REF_V100
from repro.training import checkpoint as ref_ckpt
from repro_torch.core import dqn as pt_dqn
from repro_torch.core import rl_router as pt_rl
from repro_torch.serving import policies as pt_pol
from repro_torch.training import checkpoint as pt_ckpt


@pytest.fixture
def ref_zlib(monkeypatch):
    """The reference without zstandard: it writes ``ZLB0`` zlib blobs."""
    monkeypatch.setattr(ref_ckpt, "zstandard", None)


def _cfg(mod, arch):
    kw = dict(state_dim=2 * 6 + 4, n_actions=3, hidden=(8, 8),
              batch_size=8, buffer_size=32, q_arch=arch)
    if arch == "decomposed":
        kw.update(inst_dims=6, router_dims=4)
    return mod.DQNConfig(**kw)


def _feed(agent, seed=0, n=20):
    """The same transitions into either package's agent, then two learn
    steps, so that the optimizer state and the replay ring are live."""
    rng = np.random.default_rng(seed)
    d = agent.cfg.state_dim
    for _ in range(n):
        s = rng.standard_normal(d).astype(np.float32)
        s2 = rng.standard_normal(d).astype(np.float32)
        mask = rng.random(3) < 0.7
        mask[-1] = True
        agent.observe(s, int(rng.integers(0, 3)),
                      float(rng.standard_normal()), s2, 0.0, mask)
    agent.learn()
    agent.learn()


def _ref_leaves(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", "?")))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pt_leaves(tree):
    return pt_ckpt._flatten(tree)


def _assert_bit_equal(got, want):
    assert list(got) == list(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype, key
        assert a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


def _agents(arch):
    ref = ref_dqn.DQNAgent(_cfg(ref_dqn, arch), seed=0)
    _feed(ref)
    pt = pt_dqn.DQNAgent(_cfg(pt_dqn, arch), seed=0, device="cpu")
    _feed(pt, seed=1)
    return ref, pt


def _tree_extra(agent, which):
    if which == "state_dict":
        return agent.state_dict(), {}
    return agent.full_state()


@pytest.mark.parametrize("which", ["state_dict", "full_state"])
@pytest.mark.parametrize("arch", ["mlp", "decomposed"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, ref_zlib,
                                                      arch, which):
    ref, pt = _agents(arch)
    tree, extra = _tree_extra(ref, which)
    mgr = ref_ckpt.CheckpointManager(str(tmp_path))
    try:
        mgr.save(7, tree, extra, sync=True)
    finally:
        mgr.close()
    with open(tmp_path / "step_000000007.ckpt", "rb") as f:
        assert f.read(4) == b"ZLB0"
    like, _ = _tree_extra(pt, which)
    mgr = pt_ckpt.CheckpointManager(str(tmp_path))
    try:
        restored, got_extra = mgr.restore(like)
    finally:
        mgr.close()
    _assert_bit_equal(_pt_leaves(restored), _ref_leaves(tree))
    assert got_extra == {"step": 7, **extra}
    # ...and loads into the port's agent as the same networks/optimizer
    if which == "state_dict":
        pt.load_state_dict(restored)
    else:
        pt.load_full_state(restored, got_extra)
        assert pt.rng.bit_generator.state == ref.rng.bit_generator.state
        assert (pt.steps, pt.r_mean, pt.buffer.ptr, pt.buffer.size) == (
            ref.steps, ref.r_mean, ref.buffer.ptr, ref.buffer.size)
    _assert_bit_equal(_pt_leaves(pt.state_dict()),
                      _ref_leaves(ref.state_dict()))


@pytest.mark.parametrize("which", ["state_dict", "full_state"])
@pytest.mark.parametrize("arch", ["mlp", "decomposed"])
def test_port_checkpoint_restores_into_the_reference(tmp_path, arch,
                                                      which):
    ref, pt = _agents(arch)
    tree, extra = _tree_extra(pt, which)
    mgr = pt_ckpt.CheckpointManager(str(tmp_path))
    try:
        mgr.save(3, tree, extra, sync=True)
    finally:
        mgr.close()
    like, _ = _tree_extra(ref, which)
    with open(tmp_path / "step_000000003.ckpt", "rb") as f:
        restored, got_extra = ref_ckpt.deserialize(f.read(), like)
    _assert_bit_equal(_ref_leaves(restored), _pt_leaves(tree))
    assert _ref_leaves(restored)["opt/step"].dtype == np.int32
    assert got_extra == {"step": 3, **extra}
    if which == "full_state":
        ref.load_full_state(restored, got_extra)
        assert ref.rng.bit_generator.state == pt.rng.bit_generator.state


def test_restore_rl_policy_reads_the_reference_router_checkpoint(
        tmp_path, ref_zlib):
    """``ManagedCluster.save_router``'s artifact (the reference CLI's
    ``--checkpoint``) becomes the port's RL policy, leaves equal."""
    cfg_kw = dict(n_instances=3, q_arch="decomposed")
    ref_agent = ref_rl.make_agent(ref_rl.RouterConfig(**cfg_kw))
    mc = ref_cm.ManagedCluster(
        ref_cm.ManagedClusterConfig(n_instances=3,
                                    checkpoint_dir=str(tmp_path)),
        ref_rl.RouterConfig(**cfg_kw), REF_V100, ref_agent)
    try:
        mc.save_router(5)
    finally:
        mc.ckpt.close()
    pol = pt_pol.restore_rl_policy(pt_rl.RouterConfig(**cfg_kw),
                                   str(tmp_path), m=2, device="cpu")
    _assert_bit_equal(_pt_leaves(pol.agent.state_dict()),
                      _ref_leaves(ref_agent.state_dict()))
    with pytest.raises(FileNotFoundError, match="no router checkpoint"):
        pt_pol.restore_rl_policy(pt_rl.RouterConfig(**cfg_kw),
                                 str(tmp_path / "empty"), device="cpu")


def test_corrupt_newest_falls_back_to_older(tmp_path):
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": [torch.ones((2,), dtype=torch.int32),
                  np.zeros((5,), np.float64)]}
    mgr = pt_ckpt.CheckpointManager(str(tmp_path), keep=2)
    try:
        mgr.save(1, tree, {"note": "x"}, sync=True)
        restored, extra = mgr.restore(tree)
        assert extra == {"step": 1, "note": "x"}
        np.testing.assert_array_equal(restored["a"], tree["a"])
        assert restored["b"][0].dtype == np.int32
        mgr.save(2, tree, sync=True)
        newest = sorted(p for p in os.listdir(tmp_path)
                        if p.startswith("step_"))[-1]
        with open(os.path.join(tmp_path, newest), "r+b") as f:
            f.seek(0)
            f.write(b"garbage!")
        restored, extra = mgr.restore(tree)
        assert extra["step"] == 1
        assert mgr.latest_step() == 2
        # a flipped payload byte fails the zlib stream or the leaf CRC
        with open(os.path.join(tmp_path, newest), "r+b") as f:
            blob = bytearray(pt_ckpt.serialize(tree, {"step": 2}))
            blob[-20] ^= 0xff
            f.seek(0)
            f.truncate()
            f.write(bytes(blob))
        assert mgr.restore(tree)[1]["step"] == 1
    finally:
        mgr.close()
    assert not mgr._thread.is_alive()


def test_gc_keeps_three_and_restores_the_latest(tmp_path):
    mgr = pt_ckpt.CheckpointManager(str(tmp_path))
    try:
        for s in range(6):
            mgr.save(s, {"x": np.asarray([s])})
        mgr.wait()
        ckpts = sorted(p for p in os.listdir(tmp_path)
                       if p.startswith("step_"))
        assert ckpts == [f"step_{s:09d}.ckpt" for s in (3, 4, 5)]
        restored, extra = mgr.restore({"x": np.zeros((1,), np.int64)})
        assert extra["step"] == 5 and restored["x"].tolist() == [5]
        assert not any(p.startswith(".tmp") for p in os.listdir(tmp_path))
    finally:
        mgr.close()


def test_restore_rejects_a_tree_that_does_not_match(tmp_path):
    tree = {"w": np.ones((2, 3), np.float32)}
    blob = pt_ckpt.serialize(tree)
    with pytest.raises(IOError, match="tree mismatch"):
        pt_ckpt.deserialize(blob, {"v": np.ones((2, 3), np.float32)})
    with pytest.raises(IOError, match="shape mismatch"):
        pt_ckpt.deserialize(blob, {"w": np.ones((3, 2), np.float32)})
    with pytest.raises(TypeError, match="bfloat16"):
        pt_ckpt.serialize({"w": torch.ones(2, dtype=torch.bfloat16)})


def test_zstd_blob_raises_the_reference_error():
    blob = b"\x28\xb5\x2f\xfd" + bytes(16)      # zstd frame magic
    with pytest.raises(pt_ckpt.ZstdError,
                       match="zstandard is not installed"):
        pt_ckpt.deserialize(blob, {})


CODEC_CASES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536,
    2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768,
    -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.0, -1.5, 1e300,
    float("inf"), "", "x" * 31, "x" * 32, "x" * 255, "x" * 256,
    "é" * 40000, b"", b"y" * 255, b"y" * 256, b"y" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): [i, {"k": None}] for i in range(70000)}]


@pytest.mark.parametrize("obj", CODEC_CASES,
                         ids=lambda o: f"{type(o).__name__}"
                         f"{len(o) if hasattr(o, '__len__') else o}")
def test_codec_matches_msgpack(obj):
    packed = pt_ckpt.packb(obj)
    assert packed == msgpack.packb(obj, use_bin_type=True)
    assert pt_ckpt.unpackb(packed) == msgpack.unpackb(packed, raw=False)


def test_codec_bytes_equal_msgpack_for_the_checkpoint_payload():
    pt = pt_dqn.DQNAgent(_cfg(pt_dqn, "decomposed"), device="cpu")
    _feed(pt)
    tree, extra = pt.full_state()
    blob = pt_ckpt.serialize(tree, dict(extra, step=9))
    packed = pt_ckpt._decompress(blob)
    payload = msgpack.unpackb(packed, raw=False)
    assert msgpack.packb(payload, use_bin_type=True) == packed
    assert pt_ckpt.unpackb(packed) == payload


@pytest.mark.parametrize("bad", [b"\xca\x00\x00\x80\x3f",     # float32
                                 b"\xd4\x01\x00",             # fixext 1
                                 b"\xc1",                     # never used
                                 b"\xa5abc",                  # truncated
                                 b"\x01\x02",                 # extra byte
                                 b"\x81\x01\x02"])            # int key
def test_codec_rejects_bytes_outside_the_subset(bad):
    with pytest.raises(pt_ckpt.CodecError):
        pt_ckpt.unpackb(bad)


@pytest.mark.parametrize("obj", [np.float32(1.0), np.int64(3), 2 ** 64,
                                 -2 ** 63 - 1, {1.5}])
def test_codec_refuses_objects_outside_the_subset(obj):
    with pytest.raises(pt_ckpt.CodecError):
        pt_ckpt.packb(obj)
