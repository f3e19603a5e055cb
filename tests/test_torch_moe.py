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


# -- the grouped path: device offsets, the grouped kernels' plain version ---

def _loop(p, cfg, x_sorted, sizes):
    """The per-group loop the grouped kernels replaced: one matmul chain
    (``_expert_ffn``) a non-empty group, in the rows' dtype."""
    outs, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            outs.append(pt_moe._expert_ffn(p, cfg, e,
                                           x_sorted[start:start + n]))
            start += n
    return torch.cat(outs) if outs else x_sorted[:0]


def _loop_experts(p, cfg, x_sorted, offsets):
    """``moe._ragged_experts`` on the loop, after one read of the
    offsets."""
    return _loop(p, cfg, x_sorted, torch.diff(offsets).tolist())


@pytest.mark.parametrize("t", (9, 37))
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_path_matches_loop_and_reference(arch, t, monkeypatch):
    """``moe_ragged`` (its experts through ``grouped_ffn``, here the
    offset-driven plain version) against the reference's ``moe_ragged``
    and against the same dispatch on the per-group loop; with
    ``torch.bincount`` and ``Tensor.tolist`` made to raise, so neither the
    dispatch nor the grouped path reads them."""
    cfg_ref, cfg_pt, pr, pt = _moe_params(arch)
    xr, xp = _x(cfg_ref, t)
    with monkeypatch.context() as m:
        m.setattr(pt_moe, "_ragged_experts", _loop_experts)
        y_loop, aux_loop = pt_moe.moe_ragged(pt, cfg_pt, xp)

    def refuse(*a, **k):
        raise AssertionError("the grouped path read group sizes")
    monkeypatch.setattr(torch, "bincount", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    y_p, aux_p = pt_moe.moe_ragged(pt, cfg_pt, xp)
    monkeypatch.undo()
    y_r, aux_r = _ref("moe_ragged")(pr, cfg_ref, xr)
    _close(y_p, y_r, "grouped vs reference")
    _close(aux_p, aux_r, "aux")
    np.testing.assert_allclose(y_p.numpy(), y_loop.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert float(aux_loop) == float(aux_p)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("t", (9, 37))
def test_ragged_dispatch_reads_nothing_to_the_host(arch, t, monkeypatch):
    """The dispatch (sort, row gather, group offsets) calls neither
    ``torch.bincount`` nor ``Tensor.tolist``; the offsets it hands on are
    int32 [E+1] on the rows' device, equal to the running count of the
    router's choices."""
    _, cfg_pt, _, pt = _moe_params(arch)
    xp = _x(cfg_pt, t)[1]
    _, idx, _ = pt_moe._router(pt, xp, cfg_pt)
    e = cfg_pt.moe.n_experts
    want = np.concatenate([[0], np.cumsum(np.bincount(
        idx.reshape(-1).numpy(), minlength=e))])
    seen = {}

    def experts(p, cfg, x_sorted, offsets):
        seen["offsets"] = offsets
        return torch.zeros_like(x_sorted)

    def refuse(*a, **k):
        raise AssertionError("the dispatch read group sizes")
    monkeypatch.setattr(pt_moe, "_ragged_experts", experts)
    monkeypatch.setattr(torch, "bincount", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    pt_moe.moe_ragged(pt, cfg_pt, xp)
    monkeypatch.undo()
    off = seen["offsets"]
    assert off.dtype == torch.int32 and off.device == xp.device
    np.testing.assert_array_equal(off.numpy(), want)


def _grouped_case(sizes, d, f, seed, gated=True):
    """Seeded rows, offsets and weights of ``len(sizes)`` experts (f32),
    scaled as the model's initialiser scales them."""
    rng = np.random.default_rng(seed)
    e = len(sizes)

    def rand(*shape, fan_in=1):
        return torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32) / np.sqrt(fan_in))
    x = rand(sum(sizes), d)
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)]),
                              dtype=torch.int32)
    w = {"w_up": rand(e, d, f, fan_in=d), "w_down": rand(e, f, d, fan_in=f)}
    if gated:
        w["w_gate"] = rand(e, d, f, fan_in=d)
    return x, offsets, w


def _act_cfg(act, gated):
    return dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                               activation=act, gated_mlp=gated)


# hand-made groupings: empty experts (the first and the last among them),
# every pair on one expert, and groups that are not multiples of the
# kernels' 128- and 64-row tiles
GROUPINGS = {
    "empty_experts": [0, 5, 0, 0, 17, 3, 0, 0],
    "one_expert_first": [300, 0, 0, 0, 0, 0, 0, 0],
    "one_expert_middle": [0, 0, 0, 257, 0, 0, 0, 0],
    "one_expert_last": [0, 0, 0, 0, 0, 0, 0, 129],
    "not_tile_multiples": [129, 1, 127, 255, 0, 2, 130, 64],
}
ACTS = [("silu", True), ("gelu", True), ("relu", False)]


@pytest.mark.parametrize("act,gated", ACTS)
@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_grouped_ffn_plain_matches_the_loop(grouping, act, gated):
    """``grouped_ffn`` on CPU tensors (its plain version) against the
    per-group loop fed the same sizes, in f32 at widths that are
    multiples of 64 (d 128, f 64)."""
    from repro_torch.kernels.grouped_ffn import ops as gf
    sizes = GROUPINGS[grouping]
    x, offsets, w = _grouped_case(sizes, 128, 64, seed=len(grouping),
                                  gated=gated)
    y = gf.grouped_ffn(x, offsets, w["w_up"], w.get("w_gate"), w["w_down"],
                       act)
    loop = _loop(w, _act_cfg(act, gated), x, sizes)
    assert y.shape == x.shape and y.dtype == x.dtype
    np.testing.assert_allclose(y.numpy(), loop.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("act,gated", ACTS)
@pytest.mark.parametrize("grouping", ["empty_experts", "not_tile_multiples"])
def test_grouped_ffn_plain_gradients_match_the_loop(grouping, act, gated):
    """Autograd through ``grouped_ffn``'s plain version (the yardstick of
    the kernels' hand-written backward on the card) against autograd
    through the per-group loop, in f32 at widths off the kernels' tiles
    (d 72, f 40): the rows' and every weight's gradient, zero for the
    experts no pair reaches."""
    from repro_torch.kernels.grouped_ffn import ops as gf
    sizes = GROUPINGS[grouping]
    x, offsets, w = _grouped_case(sizes, 72, 40, seed=5, gated=gated)
    dy = torch.as_tensor(np.random.default_rng(6).standard_normal(
        x.shape).astype(np.float32))

    def grads(run):
        leaves = {"x": x.clone().requires_grad_()}
        leaves.update({k: v.clone().requires_grad_() for k, v in w.items()})
        run(leaves).backward(dy)
        return {k: v.grad for k, v in leaves.items()}
    got = grads(lambda p: gf.grouped_ffn(p["x"], offsets, p["w_up"],
                                         p.get("w_gate"), p["w_down"], act))
    want = grads(lambda p: _loop(p, _act_cfg(act, gated), p["x"], sizes))
    assert set(got) == set(want)
    for k in want:
        # the two sum in different orders: 1e-5 of each leaf's largest
        np.testing.assert_allclose(
            got[k].numpy(), want[k].numpy(), rtol=1e-5,
            atol=1e-5 * float(want[k].abs().max()), err_msg=k)
    empty = [e for e, n in enumerate(sizes) if n == 0]
    assert not got["w_up"][empty].any() and not got["w_down"][empty].any()


def test_grouped_ffn_plain_rounds_the_hidden_activation_once():
    """In bf16 the plain version sums in f32 and rounds act(g) * u once,
    as the kernels do, where the loop rounds u, act(g) and their
    product: it lies at least as close to an f32 run of the loop on the
    same bf16 inputs."""
    from repro_torch.kernels.grouped_ffn import ops as gf
    sizes = GROUPINGS["not_tile_multiples"]
    x, offsets, w = _grouped_case(sizes, 128, 64, seed=3)
    cfg = get_config("deepseek-moe-16b").reduced()
    wb = {k: v.to(torch.bfloat16) for k, v in w.items()}
    xb = x.to(torch.bfloat16)
    exact = _loop({k: v.float() for k, v in wb.items()}, cfg, xb.float(),
                  sizes)
    plain = gf.grouped_ffn(xb, offsets, wb["w_up"], wb["w_gate"],
                           wb["w_down"], "silu")
    loop = _loop(wb, cfg, xb, sizes)
    assert plain.dtype == torch.bfloat16
    err_plain = float((plain.float() - exact).abs().max())
    err_loop = float((loop.float() - exact).abs().max())
    assert err_plain <= err_loop


def test_grouped_ffn_cost():
    """``cost``: 2 d f FLOPs a pair a weight matrix, the reached experts'
    weights and the rows in and out once."""
    from repro_torch.kernels.grouped_ffn import ops as gf
    c = gf.cost(16140, 2048, 1408, 64)
    assert c.flops == 2 * 16140 * 2048 * 1408 * 3
    assert c.bytes == 2 * (64 * 3 * 2048 * 1408 + 2 * 16140 * 2048)
    assert gf.cost(60, 2048, 1408, 40, gated=False).flops == \
        2 * 60 * 2048 * 1408 * 2
