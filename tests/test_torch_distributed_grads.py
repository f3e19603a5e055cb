"""Replicated expert storage in training: a reduced deepseek-moe-16b with
E=2 experts stored for 4 EP shards (R=2), its loss and gradients against
the JAX reference's, and ``symmetrize_ep_grads`` against the
reference's.  f32, 1e-4."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import REGISTRY as REF_REGISTRY
from repro.models import model as ref_model
from repro.models import params as ref_params
from repro.training.train_loop import symmetrize_ep_grads as ref_symmetrize
from repro_torch.configs import get_config
from repro_torch.models import params as pt_params
from repro_torch.training.train_loop import loss_and_grads, \
    symmetrize_ep_grads

from _torch_dist_support import flatten

TOL = 1e-4
ARCH = "deepseek-moe-16b"


def _replicated_model(store):
    cfg = dataclasses.replace(REF_REGISTRY[ARCH].reduced(), n_layers=3)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=2, top_k=1, impl="ep"))
    pr = ref_params.init_params(jax.random.PRNGKey(1), cfg,
                                data_shards=store)
    cfg_pt = dataclasses.replace(get_config(ARCH).reduced(), n_layers=3)
    cfg_pt = dataclasses.replace(cfg_pt, moe=dataclasses.replace(
        cfg_pt.moe, n_experts=2, top_k=1, impl="ep"))
    return cfg, cfg_pt, pr


def test_replicated_storage_gradients_symmetrize_as_the_reference():
    """A reduced deepseek with E=2 stored for 4 EP shards (R=2), no mesh
    (so ``ep`` runs ``ragged`` on one copy of each expert): the loss and
    every gradient leaf equal the reference's, and
    ``symmetrize_ep_grads`` averages the replicas' gradients as the
    reference's does."""
    cfg, cfg_pt, pr = _replicated_model(4)
    assert pr["layers"][0]["moe"]["routed"]["w_up"].shape[1] == 4
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    (loss_r, _), g_r = jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(p, cfg, b), has_aux=True))(
        pr, {"tokens": tokens, "labels": labels})
    sym_r = ref_symmetrize(cfg, g_r)
    pt = pt_params.tree_map(lambda w: w.requires_grad_(True),
                            pt_params.from_reference(
                                jax.tree.map(np.asarray, pr), device="cpu"))
    loss_p, _, g_p = loss_and_grads(cfg_pt, pt, {
        "tokens": torch.from_numpy(tokens),
        "labels": torch.from_numpy(labels)})
    sym_p = symmetrize_ep_grads(cfg_pt, g_p)
    assert abs(float(loss_p) - float(loss_r)) < TOL
    for want, got in ((g_r, g_p), (sym_r, sym_p)):
        fw, fg = flatten(jax.tree.map(np.asarray, want), "g"), flatten(
            pt_params.tree_map(lambda t: t.detach().numpy(), got), "g")
        assert fw.keys() == fg.keys()
        for key in fw:
            np.testing.assert_allclose(fg[key], fw[key], atol=TOL, rtol=0,
                                       err_msg=key)
    w = sym_p["layers"][0]["moe"]["routed"]["w_up"]
    # a replica's gradient is its expert's mean, the same in both slots
    np.testing.assert_array_equal(w[:, 0].detach().numpy(),
                                  w[:, 1].detach().numpy())
    assert float(w.abs().max()) > 0
