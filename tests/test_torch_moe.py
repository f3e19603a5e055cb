"""The port's MoE layer against the JAX reference's: the router, the aux
loss, each implementation (``moe_dense``, ``moe_ragged``,
``moe_gather``) and ``moe_layer``'s dispatch, at deepseek-moe-16b's and
jamba-v0.1-52b's reduced configs, for T = 1, 8, 9 and 37 tokens (both
sides of the 8-token gather threshold); then whole MoE models (prefill
+ 4 decode steps, the last two past the cache, caches equal, the dense
first layer's included).  Their engines are held to the reference's in
``test_torch_engine_families.py``.

Parameters come from the reference by value (``from_reference``), built
once for each config; inputs come from a seeded numpy generator; the
reference's functions run under ``jax.jit``.  The tolerance is 1e-4 on
the f32 reduced configs (the two frameworks sum in different orders)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as REF_REGISTRY
from repro.models import moe as ref_moe
from repro.models import params as ref_params
from repro_torch.configs import get_config
from repro_torch.models import moe as pt_moe
from repro_torch.models import params as pt_params

from _torch_model_support import run_model_both
from _torch_model_support import torch_one_thread  # noqa: F401

TOL = 1e-4
ARCHS = ("deepseek-moe-16b", "jamba-v0.1-52b")
TOKENS = (1, 8, 9, 37)


@functools.lru_cache(maxsize=None)
def _moe_params(arch, seed=0):
    """One MoE layer's parameters, reference and port (same values),
    built once a process; the tests read them and never write them."""
    cfg_ref = REF_REGISTRY[arch].reduced()
    p = jax.tree.map(np.asarray, ref_params.init_moe(
        jax.random.PRNGKey(seed), cfg_ref, jnp.float32, 0))
    return (cfg_ref, get_config(arch).reduced(),
            jax.tree.map(jnp.asarray, p),
            pt_params.from_reference(p, device="cpu"))


@functools.lru_cache(maxsize=None)
def _ref(name):
    """The reference's ``moe.<name>(p, x, cfg)`` or ``(p, cfg, x)``
    under ``jax.jit``, the config static."""
    return jax.jit(getattr(ref_moe, name),
                   static_argnums=2 if name == "_router" else 1)


def _x(cfg, t, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (t, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.as_tensor(x)


def _close(pt, ref, what=""):
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("t", TOKENS)
@pytest.mark.parametrize("arch", ARCHS)
def test_router_and_aux_loss_match_reference(arch, t):
    cfg_ref, cfg_pt, pr, pt = _moe_params(arch)
    xr, xp = _x(cfg_ref, t)
    probs_r, idx_r, w_r = _ref("_router")(pr, xr, cfg_ref)
    probs_p, idx_p, w_p = pt_moe._router(pt, xp, cfg_pt)
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_r))
    _close(probs_p, probs_r)
    _close(w_p, w_r)
    assert w_p.dtype == probs_p.dtype == torch.float32
    _close(pt_moe.aux_loss(probs_p, idx_p, cfg_pt.moe.n_experts),
           ref_moe.aux_loss(probs_r, idx_r, cfg_ref.moe.n_experts))


@pytest.mark.parametrize("impl", ["dense", "ragged", "gather"])
@pytest.mark.parametrize("t", TOKENS)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_implementation_matches_reference(arch, t, impl):
    cfg_ref, cfg_pt, pr, pt = _moe_params(arch)
    xr, xp = _x(cfg_ref, t)
    y_r, aux_r = _ref(f"moe_{impl}")(pr, cfg_ref, xr)
    y_p, aux_p = getattr(pt_moe, f"moe_{impl}")(pt, cfg_pt, xp)
    assert y_p.shape == (t, cfg_pt.d_model) and y_p.dtype == xp.dtype
    _close(y_p, y_r, impl)
    _close(aux_p, aux_r, "aux")


@pytest.mark.parametrize("t", TOKENS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_reference(arch, t):
    """The block as the model calls it: [B,S,d] in, the reference's
    dispatch (the reduced configs' ``ragged``, ``gather`` at 8 tokens or
    fewer), shared experts added (deepseek)."""
    cfg_ref, cfg_pt, pr, pt = _moe_params(arch)
    xr, xp = _x(cfg_ref, t)
    y_r, aux_r = _ref("moe_layer")(pr, cfg_ref, xr.reshape(1, t, -1))
    y_p, aux_p = pt_moe.moe_layer(pt, cfg_pt, xp.reshape(1, t, -1))
    assert y_p.shape == (1, t, cfg_pt.d_model)
    _close(y_p, y_r)
    _close(aux_p, aux_r)


@pytest.mark.parametrize("impl", ["ep", "dense", "ragged"])
def test_dispatch_follows_the_reference(monkeypatch, impl):
    """``ep`` runs ``ragged`` without a mesh; any impl runs ``gather``
    at 8 tokens or fewer."""
    _, cfg_pt, _, pt = _moe_params("deepseek-moe-16b")
    cfg = dataclasses.replace(cfg_pt, moe=dataclasses.replace(
        cfg_pt.moe, impl=impl))
    calls = []
    for name, fn in list(pt_moe.IMPLS.items()):
        monkeypatch.setitem(pt_moe.IMPLS, name,
                            lambda *a, _n=name, _f=fn: calls.append(_n)
                            or _f(*a))
    for t in (8, 9):
        pt_moe.moe_layer(pt, cfg, _x(cfg, t)[1][None])
    assert calls == ["gather", "ragged" if impl == "ep" else impl]


def test_top_k_ties_go_to_the_lower_index():
    """Equal probabilities (a zero router): jax.lax.top_k's order."""
    cfg_ref, cfg_pt, pr, pt = _moe_params("deepseek-moe-16b")
    pr = dict(pr, router=jnp.zeros_like(pr["router"]))
    pt = dict(pt, router=torch.zeros_like(pt["router"]))
    xr, xp = _x(cfg_ref, 5)
    _, idx_r, w_r = _ref("_router")(pr, xr, cfg_ref)
    _, idx_p, w_p = pt_moe._router(pt, xp, cfg_pt)
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_r))
    assert idx_p.tolist() == [list(range(cfg_pt.moe.top_k))] * 5
    _close(w_p, w_r)


@pytest.mark.parametrize("arch", ARCHS)
def test_gather_indexes_no_expert_weights(arch, monkeypatch):
    """The port's gather runs every expert on the call's rows and takes
    each row's top-k outputs: it never indexes the stacked expert
    weights (the reference's ``[T,k,d,f]`` copies), and still equals the
    reference's at 8 rows, its dispatch threshold."""
    cfg_ref, cfg_pt, pr, pt = _moe_params(arch)
    xr, xp = _x(cfg_ref, 8, seed=4)
    weights = list(pt["routed"].values())
    indexed = []
    getitem = torch.Tensor.__getitem__

    def spy(t, idx):
        indexed.extend(w for w in weights if t is w)
        return getitem(t, idx)
    monkeypatch.setattr(torch.Tensor, "__getitem__", spy)
    y_p, _ = pt_moe.moe_gather(pt, cfg_pt, xp)
    monkeypatch.undo()
    assert not indexed
    _close(y_p, _ref("moe_gather")(pr, cfg_ref, xr)[0])


@pytest.mark.parametrize("arch", ARCHS + ("grok-1-314b",))
def test_moe_model_matches_reference(arch):
    """Prefill 12 into a 14-position cache + 4 decode steps (the last
    two past the cache): the prefill's MoE runs ``ragged``, each decode
    step's ``gather``."""
    run_model_both(arch, 12, 14)
