"""The port's train step end to end on reduced models against the JAX
package: ``make_train_step`` over three steps, remat (``torch.utils.
checkpoint``) equal to no remat, a bf16 model, the reference's
end-to-end loss decrease mirrored, the ``launch.train`` CLI on the CPU
with a resume, and train-state checkpoints (bf16 leaves included) that
each package restores from the other bit for bit."""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_support import (GRAD_TOL, _ref_loss_grad,  # noqa: F401
                                   assert_tree_close, batch_np, configs,
                                   grads_of, np32, params_both, pt_batch,
                                   ref_batch, torch_one_thread, trainable)
from repro.training import checkpoint as ref_ckpt
from repro.training import optimizer as ref_opt
from repro.training.train_loop import make_train_step as ref_make_step
from repro_torch.configs import get_config
from repro_torch.launch import train as train_cli
from repro_torch.models import model as pt_model
from repro_torch.models import params as pt_params
from repro_torch.training import checkpoint as pt_ckpt
from repro_torch.training import data as pt_data
from repro_torch.training import optimizer as pt_opt
from repro_torch.training.train_loop import init_train_state, make_train_step

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
PARAM_TOL = 1e-5


def test_three_train_steps_match_reference():
    """Three AdamW steps on reduced qwen3-0.6b: metrics within 1e-4 and
    params within 1e-5 of each leaf's largest magnitude plus 2% of the
    steps' total size (3 lr): Adam's m / sqrt(v) turns the gradients'
    f32-level differences into a fraction of a step wherever an entry's
    first moment nearly cancels across steps (measured: 1% of 3 lr in one
    of wk's 8192 entries, 6e-4 or less elsewhere) -- except where
    the reference's second moment says a gradient never left rounding
    level (sqrt(nu) < 1e-6): Adam moves such an entry by any value in
    [-lr, lr] a step in either framework (ROADMAP §3), so there the two
    may part by at most 2 lr a step."""
    cfg_ref, cfg_pt = configs("qwen3-0.6b")
    pr, pt = params_both(cfg_ref)
    ref_step = jax.jit(ref_make_step(cfg_ref, ref_opt.OptimizerConfig(**OPT)))
    pt_step = make_train_step(cfg_pt, pt_opt.OptimizerConfig(**OPT))
    params = trainable(pt)
    ref_state, pt_state = ref_opt.init(pr), pt_opt.init(params)
    for i in range(3):
        batch = batch_np(cfg_ref, 2, 16, seed=i)
        pr, ref_state, m_r = ref_step(pr, ref_state, ref_batch(batch))
        params, pt_state, m_p = pt_step(params, pt_state, pt_batch(batch))
        assert set(m_p) == set(m_r) == {"loss", "lm_loss", "moe_aux",
                                        "grad_norm", "lr"}
        for k in m_r:
            np.testing.assert_allclose(float(m_p[k]), float(m_r[k]),
                                       rtol=1e-4, atol=1e-7, err_msg=k)
    assert int(pt_state["step"]) == 3
    assert all(p.grad is None for p in pt_params.leaves(params))
    got = dict(pt_ckpt._leaves_with_keys(params))
    want = dict(pt_ckpt._leaves_with_keys(jax.tree.map(np.asarray, pr)))
    nu = dict(pt_ckpt._leaves_with_keys(
        jax.tree.map(np.asarray, ref_state["nu"])))
    for key, w in want.items():
        g = np32(got[key].detach())
        sure = np.sqrt(nu[key]) >= 1e-6
        np.testing.assert_allclose(
            g[sure], w[sure], rtol=0,
            atol=PARAM_TOL * np.abs(w).max() + 2e-2 * 3 * OPT["lr"],
            err_msg=key)
        assert np.all(np.abs(g - w)[~sure] <= 2 * 3 * OPT["lr"]), key


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b",
                                  "deepseek-moe-16b"])
def test_remat_equals_no_remat(arch):
    """``cfg.remat`` recomputes each period in the backward: the loss
    and every gradient are those of the run without it."""
    cfg_ref, cfg_pt = configs(arch)
    _, pt = params_both(cfg_ref)
    batch = pt_batch(batch_np(cfg_ref, 2, 16))
    out = []
    for remat in (False, True):
        params = trainable(pt)
        loss, _ = pt_model.loss_fn(
            params, dataclasses.replace(cfg_pt, remat=remat), batch)
        loss.backward()
        out.append((loss.detach(), grads_of(params)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(pt_params.leaves(g0), pt_params.leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_bf16_model_grads_match_reference():
    """Reduced qwen3-0.6b in bf16 on both sides.  bf16 rounds at other
    places in the two frameworks (each matmul's output, the norms'
    casts), so the loss agrees within 1e-2 and each gradient leaf within
    5e-2 of its largest |g|."""
    cfg_ref, cfg_pt = configs("qwen3-0.6b", dtype="bfloat16")
    pr, pt = params_both(cfg_ref)
    batch = batch_np(cfg_ref, 2, 16)
    (loss_r, _), grads_r = _ref_loss_grad(pr, cfg_ref, ref_batch(batch))
    params = trainable(pt)
    loss_p, _ = pt_model.loss_fn(params, cfg_pt, pt_batch(batch))
    loss_p.backward()
    assert all(p.grad.dtype == p.dtype for p in pt_params.leaves(params))
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_r),
                               rtol=1e-2)
    assert_tree_close(grads_of(params), grads_r, 5e-2)


def test_train_loop_end_to_end_loss_decreases():
    """The reference's end-to-end case: reduced llama-2-7b, 30 steps on
    a 4-batch cycle, the mean of the last 5 losses 0.2 below the first
    5's."""
    cfg = get_config("llama-2-7b").reduced()
    params, opt = init_train_state(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg, pt_opt.OptimizerConfig(
        lr=3e-3, warmup_steps=2, total_steps=60))
    losses = []
    for i in range(30):
        batch = train_cli.to_device(pt_data.synthetic_batch(
            cfg, 8, 32, seed=0, step=i % 4), "cpu")
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


ARGS = ["--arch", "qwen3-0.6b", "--reduced", "--batch", "2", "--seq",
        "32", "--device", "cpu", "--ckpt-every", "3"]


def test_cli_trains_and_resumes_bit_equal(tmp_path, capsys):
    """6 steps with checkpoints at 3 and 6; then a second run from the
    step-3 checkpoint alone resumes at step 3 and ends on the same
    parameters and moments, bit for bit."""
    full, part = tmp_path / "full", tmp_path / "part"
    train_cli.main(ARGS + ["--steps", "6", "--ckpt", str(full)])
    out = capsys.readouterr().out
    assert "arch=qwen3-0.6b" in out and "step     6 loss=" in out
    part.mkdir()
    shutil.copy(full / "step_000000003.ckpt", part)
    (part / "latest").write_text("step_000000003.ckpt")
    train_cli.main(ARGS + ["--steps", "6", "--ckpt", str(part)])
    assert "resumed at step 3" in capsys.readouterr().out
    like = init_train_state(get_config("qwen3-0.6b").reduced(),
                            torch.Generator().manual_seed(1), device="cpu")
    like = {"params": like[0], "opt": like[1]}
    for d in (full, part):
        assert sorted(os.listdir(d))[-1] == "step_000000006.ckpt"
    a, _ = pt_ckpt.deserialize((full / "step_000000006.ckpt").read_bytes(),
                               like)
    b, _ = pt_ckpt.deserialize((part / "step_000000006.ckpt").read_bytes(),
                               like)
    for key, x in pt_ckpt._leaves_with_keys(a):
        np.testing.assert_array_equal(x, dict(pt_ckpt._leaves_with_keys(b))[
            key], err_msg=key)


@pytest.fixture
def ref_zlib(monkeypatch):
    """The reference without zstandard: it writes ``ZLB0`` zlib blobs."""
    monkeypatch.setattr(ref_ckpt, "zstandard", None)


def _bits(x):
    """A leaf's raw bytes and dtype name (bf16 as the reference names
    it)."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16", x.contiguous().view(torch.int16).numpy().tobytes()
    if isinstance(x, torch.Tensor):
        x = x.detach().numpy()
    x = np.asarray(x)
    return str(x.dtype), x.tobytes()


def test_bf16_train_state_checkpoints_cross_restore(tmp_path, ref_zlib):
    """A bf16 LM state {"params", "opt"} saved by the port restores in
    the reference's CheckpointManager bit for bit, and the reference's
    (jax bf16 params) in the port's, bf16 leaves coming back as bf16
    tensors."""
    cfg_ref, cfg_pt = configs("qwen3-0.6b", dtype="bfloat16")
    from repro.models import params as ref_params
    ref_tree = ref_params.init_params(jax.random.PRNGKey(3), cfg_ref)
    ref_state = {"params": ref_tree, "opt": ref_opt.init(ref_tree)}
    pt_state = {"params": pt_params.from_reference(
        jax.tree.map(np.asarray, ref_tree), device="cpu")}
    pt_state["opt"] = pt_opt.init(pt_state["params"])
    # port -> reference
    mgr = pt_ckpt.CheckpointManager(str(tmp_path / "pt"))
    mgr.save(5, pt_state, sync=True)
    mgr.close()
    rmgr = ref_ckpt.CheckpointManager(str(tmp_path / "pt"))
    got, extra = rmgr.restore(ref_state)
    rmgr.close()
    assert extra["step"] == 5
    want = dict(pt_ckpt._leaves_with_keys(pt_state))
    got = dict(pt_ckpt._leaves_with_keys(got))
    assert set(got) == set(want)
    assert any(str(np.asarray(v).dtype) == "bfloat16" for v in got.values())
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k
    # reference -> port
    rmgr = ref_ckpt.CheckpointManager(str(tmp_path / "ref"))
    rmgr.save(7, ref_state, sync=True)
    rmgr.close()
    mgr = pt_ckpt.CheckpointManager(str(tmp_path / "ref"))
    got, extra = mgr.restore(pt_state)
    mgr.close()
    assert extra["step"] == 7
    got = dict(pt_ckpt._leaves_with_keys(got))
    want = dict(pt_ckpt._leaves_with_keys(
        jax.tree.map(np.asarray, ref_state)))
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k
        if str(want[k].dtype) == "bfloat16":
            assert got[k].dtype == torch.bfloat16
