"""The port's LM-training substrate against the JAX package: data
batches (bit-equal), AdamW (``update``, ``schedule``, ``global_norm``),
Adafactor (chunked over the stacked axis) and ``symmetrize_ep_grads``;
plus the reference's ``test_training.py`` optimizer cases
mirrored.  Optimizer states are carried by value and compared within
1e-6 over several steps."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_model_support import torch_one_thread  # noqa: F401
from repro.configs import REGISTRY as REF_REGISTRY
from repro.launch import steps as ref_steps
from repro.training import data as ref_data
from repro.training import optimizer as ref_opt
from repro.training.train_loop import symmetrize_ep_grads as ref_symmetrize
from repro_torch.configs import get_config
from repro_torch.launch import steps as pt_steps
from repro_torch.training import data as pt_data
from repro_torch.training import optimizer as pt_opt
from repro_torch.training.train_loop import (
    symmetrize_ep_grads as pt_symmetrize)

OPT_TOL = 1e-6


def _tree_np(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


# stacked [n_periods, ...] leaves as the models hold them: a weight, a
# norm stacked over periods (decayed, ndim 2), an unstacked norm (not)
SHAPES = {"w": (3, 5, 4), "ln1": (3, 5), "final_norm": (5,)}


def _close(got, want, tol=OPT_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch,seed,step", [("qwen3-0.6b", 7, 42),
                                            ("musicgen-medium", 3, 0),
                                            ("llama-3.2-vision-11b", 1, 9)])
def test_synthetic_batch_bit_equal(arch, seed, step):
    cfg_ref, cfg_pt = REF_REGISTRY[arch].reduced(), \
        get_config(arch).reduced()
    want = ref_data.synthetic_batch(cfg_ref, 4, 16, seed, step)
    got = pt_data.synthetic_batch(cfg_pt, 4, 16, seed, step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    loader = pt_data.PrefetchLoader(cfg_pt, 4, 16, seed, start_step=step)
    try:
        s, b = next(loader)
    finally:
        loader.close()
    assert s == step
    np.testing.assert_array_equal(b["labels"], want["labels"])


@pytest.mark.parametrize("clip_norm,scale", [(1.0, 1.0), (100.0, 1.0),
                                             (0.0, 5.0)],
                         ids=["clipped", "unclipped", "clip-off"])
def test_adamw_update_matches_reference(clip_norm, scale):
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=6,
                  clip_norm=clip_norm)
    ref_cfg = ref_opt.OptimizerConfig(**cfg_kw)
    pt_cfg = pt_opt.OptimizerConfig(**cfg_kw)
    p_np = _tree_np(0, SHAPES)
    ref_p = {k: jnp.asarray(v) for k, v in p_np.items()}
    ref_s = ref_opt.init(ref_p)
    pt_p = {k: torch.tensor(v) for k, v in p_np.items()}
    pt_s = pt_opt.init(pt_p)
    for i in range(5):
        g_np = {k: v * scale for k, v in _tree_np(10 + i, SHAPES).items()}
        ref_p, ref_s, ref_m = ref_opt.update(
            ref_cfg, {k: jnp.asarray(v) for k, v in g_np.items()}, ref_s,
            ref_p)
        pt_p, pt_s, pt_m = pt_opt.update(
            pt_cfg, {k: torch.tensor(v) for k, v in g_np.items()}, pt_s,
            pt_p)
        assert int(pt_s["step"]) == int(ref_s["step"]) == i + 1
        for k in ("grad_norm", "lr"):
            assert isinstance(pt_m[k], torch.Tensor)
            _close(pt_m[k], ref_m[k])
        for k in SHAPES:
            _close(pt_p[k], ref_p[k])
            _close(pt_s["mu"][k], ref_s["mu"][k])
            _close(pt_s["nu"][k], ref_s["nu"][k])
    if clip_norm == 1.0:
        assert float(pt_m["grad_norm"]) > clip_norm       # clipping acted


def test_weight_decay_follows_ndim():
    """Zero gradients: only decay moves a parameter, on leaves of 2 or
    more dims (the stacked ``ln1`` too), never on ``final_norm``."""
    cfg = pt_opt.OptimizerConfig(lr=0.1, warmup_steps=0, clip_norm=0)
    p = {k: torch.ones(s) for k, s in SHAPES.items()}
    st = pt_opt.init(p)
    p, st, _ = pt_opt.update(cfg, {k: torch.zeros(s) for k, s
                                   in SHAPES.items()}, st, p)
    assert torch.all(p["w"] < 1) and torch.all(p["ln1"] < 1)
    assert torch.all(p["final_norm"] == 1)


@pytest.mark.parametrize("step", [0, 1, 10, 55, 100, 150])
def test_schedule_and_global_norm(step):
    cfg_kw = dict(lr=1.0, warmup_steps=10, total_steps=100)
    _close(pt_opt.schedule(pt_opt.OptimizerConfig(**cfg_kw),
                           torch.tensor(step, dtype=torch.int32)),
           ref_opt.schedule(ref_opt.OptimizerConfig(**cfg_kw),
                            jnp.asarray(step, jnp.int32)))
    tree = _tree_np(step, SHAPES)
    _close(pt_opt.global_norm({k: torch.tensor(v) for k, v in tree.items()}),
           ref_opt.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))


@pytest.mark.parametrize("clip,scale", [(1.0, 1.0), (1e3, 1.0),
                                        (1.0, 1e-3)],
                         ids=["clip-active", "clip-inactive", "small-grads"])
def test_adafactor_matches_reference(clip, scale):
    """Five steps; the stacked 3-D leaf goes through the port's
    per-slice path (moments and update a slice at a time, the RMS clip
    over the whole leaf)."""
    p_np = _tree_np(1, SHAPES)
    ref_p = {k: jnp.asarray(v) for k, v in p_np.items()}
    ref_s = ref_steps.adafactor_init(ref_p)
    pt_p = {k: torch.tensor(v) for k, v in p_np.items()}
    pt_s = pt_steps.adafactor_init(pt_p)
    for i in range(5):
        g_np = {k: v * scale for k, v in _tree_np(20 + i, SHAPES).items()}
        ref_p, ref_s = ref_steps.adafactor_update(
            0.05, {k: jnp.asarray(v) for k, v in g_np.items()}, ref_s,
            ref_p, clip=clip)
        pt_p, pt_s = pt_steps.adafactor_update(
            0.05, {k: torch.tensor(v) for k, v in g_np.items()}, pt_s,
            pt_p, clip=clip)
        assert int(pt_s["step"]) == int(ref_s["step"])
        for k in SHAPES:
            _close(pt_p[k], ref_p[k])
            for name, v in ref_s["v"][k].items():
                _close(pt_s["v"][k][name], v)


def test_symmetrize_ep_grads_matches_reference():
    """The reference's test data: 4 stored slots of 2 experts (R=2)."""
    cfg_ref = REF_REGISTRY["grok-1-314b"].reduced()
    cfg_ref = dataclasses.replace(cfg_ref, moe=dataclasses.replace(
        cfg_ref.moe, impl="ep", n_experts=2))
    cfg_pt = get_config("grok-1-314b").reduced()
    cfg_pt = dataclasses.replace(cfg_pt, moe=dataclasses.replace(
        cfg_pt.moe, impl="ep", n_experts=2))
    w = np.arange(4 * 2 * 3, dtype=np.float32).reshape(1, 4, 2, 3)
    other = np.ones((4, 2), np.float32)

    def tree(mk):
        return {"layers": [{"moe": {"routed": {"w_up": mk(w)},
                                    "router": mk(other)}}],
                "first": {"routed": {"w_down": mk(w[0])}}}
    want = ref_symmetrize(cfg_ref, tree(jnp.asarray))
    got = pt_symmetrize(cfg_pt, tree(torch.tensor))
    for path in (("layers", 0, "moe", "routed", "w_up"),
                 ("layers", 0, "moe", "router"),
                 ("first", "routed", "w_down")):
        g, r = got, want
        for k in path:
            g, r = g[k], r[k]
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # without ep the rule is the identity on the port's own configs
    plain = get_config("grok-1-314b").reduced()
    t = tree(torch.tensor)
    assert pt_symmetrize(plain, t) is t


def test_adamw_minimizes_quadratic():
    cfg = pt_opt.OptimizerConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                                 total_steps=200, clip_norm=0)
    target = torch.tensor(np.random.default_rng(0).standard_normal((4, 4)),
                          dtype=torch.float32)
    params = {"w": torch.zeros((4, 4), requires_grad=True)}
    opt = pt_opt.init(params)
    for _ in range(150):
        loss = torch.sum((params["w"] - target) ** 2)
        (g,) = torch.autograd.grad(loss, [params["w"]])
        params, opt, _ = pt_opt.update(cfg, {"w": g}, opt, params)
    assert float(torch.sum((params["w"].detach() - target) ** 2)) < 1e-2


def test_adafactor_memory_and_descent():
    target = torch.tensor(np.random.default_rng(1).standard_normal((8, 6)),
                          dtype=torch.float32)
    params = {"w": torch.zeros((8, 6), requires_grad=True)}
    st = pt_steps.adafactor_init(params)
    assert st["v"]["w"]["vr"].shape == (8,)
    assert st["v"]["w"]["vc"].shape == (6,)
    for _ in range(300):
        loss = torch.sum((params["w"] - target) ** 2)
        (g,) = torch.autograd.grad(loss, [params["w"]])
        params, st = pt_steps.adafactor_update(0.05, {"w": g}, st, params)
    assert float(torch.sum((params["w"].detach() - target) ** 2)) < 0.2
