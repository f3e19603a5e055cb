"""Shared set-up of the LM-training parity tests
(``test_torch_train*.py``): the reference's ``forward_train`` and
``jax.value_and_grad(loss_fn)`` under ``jax.jit`` (one compile for each
config and shape), parameters carried over by value from the reference
(built once a process, ``_torch_model_support.params_both``), seeded
numpy batches handed to both sides, and the comparisons.

Tolerances (f32 reduced configs): logits and losses within 1e-4 (the
serving parity tests' bound), and every gradient leaf within 1e-4 of
that leaf's largest |g| in the reference: the two frameworks sum in
other orders (the attention's softmax, the chunked CE, the scan), so
gradients agree to f32 rounding relative to their own scale.

The files that use this pin torch to one intra-op thread
(``torch_one_thread``), as the model families' files do."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_model_support import (configs, inputs, np32,  # noqa: F401
                                  params_both, torch_one_thread)
from repro.models import model as ref_model
from repro_torch.models import model as pt_model
from repro_torch.models.params import leaves, tree_map
from repro_torch.training.checkpoint import _leaves_with_keys

TOL = 1e-4
GRAD_TOL = 1e-4

_ref_forward = jax.jit(ref_model.forward_train, static_argnames=("cfg",))
_ref_loss_grad = jax.jit(
    jax.value_and_grad(ref_model.loss_fn, has_aux=True),
    static_argnums=(1,))


def batch_np(cfg, b=2, s=16, seed=0):
    """Seeded model inputs and labels (numpy)."""
    out = inputs(cfg, b, s, seed)
    rng = np.random.default_rng(seed + 100)
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s))
    return out


def ref_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if k in ("tokens", "labels")
                           else None) for k, v in batch.items()}


def pt_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def trainable(tree):
    """A fresh copy of a port parameter tree, each leaf requiring grad."""
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)


def grads_of(params):
    return tree_map(lambda p: p.grad, params)


def assert_tree_close(got, want, tol, what="grad"):
    """Every leaf of ``got`` (tensors) within ``tol`` of the largest
    |value| of the same leaf of ``want`` (the reference's arrays)."""
    got = dict(_leaves_with_keys(got))
    want = dict(_leaves_with_keys(jax.tree.map(np.asarray, want)))
    assert set(got) == set(want), set(got) ^ set(want)
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[key]
        assert g is not None, f"{what} {key}: no gradient"
        g = np32(g)
        assert g.shape == w.shape, key
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale + 1e-12,
                                   err_msg=f"{what} {key}")


def loss_and_grads_both(arch, s=16, seed=0, **over):
    """The reference's (loss, aux, grads) and the port's, from the same
    parameters and batch; the port's params carry their ``.grad``."""
    cfg_ref, cfg_pt = configs(arch, **over)
    pr, pt = params_both(cfg_ref, seed)
    batch = batch_np(cfg_ref, 2, s, seed)
    (loss_r, aux_r), grads_r = _ref_loss_grad(pr, cfg_ref, ref_batch(batch))
    params = trainable(pt)
    loss_p, aux_p = pt_model.loss_fn(params, cfg_pt, pt_batch(batch))
    loss_p.backward()
    return (loss_r, aux_r, grads_r), (loss_p, aux_p, params)


def assert_loss_and_grads(arch, s=16, **over):
    (loss_r, aux_r, grads_r), (loss_p, aux_p, params) = \
        loss_and_grads_both(arch, s, **over)
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_r),
                               rtol=TOL)
    for k in ("lm_loss", "moe_aux"):
        np.testing.assert_allclose(float(aux_p[k].detach()), float(aux_r[k]),
                                   rtol=TOL, atol=1e-7, err_msg=k)
    assert all(p.grad is not None for p in leaves(params))
    assert_tree_close(grads_of(params), grads_r, GRAD_TOL)


def assert_forward_train(arch, s=16, **over):
    cfg_ref, cfg_pt = configs(arch, **over)
    pr, pt = params_both(cfg_ref)
    batch = batch_np(cfg_ref, 2, s)
    batch.pop("labels")
    logits_r, aux_r = _ref_forward(pr, cfg=cfg_ref, **ref_batch(batch))
    with torch.no_grad():
        logits_p, aux_p = pt_model.forward_train(pt, cfg_pt,
                                                 **pt_batch(batch))
    assert logits_p.shape == (2, s, cfg_pt.vocab_size)
    np.testing.assert_allclose(np32(logits_p), np32(logits_r), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux_p), float(aux_r), rtol=TOL,
                               atol=1e-7)


@functools.lru_cache(maxsize=None)
def ref_params_tree(cfg_ref, seed=0):
    return params_both(cfg_ref, seed)[0]
