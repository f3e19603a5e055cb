"""The port's multi-head latent attention against the JAX reference's, at
minicpm3-4b's reduced config: the two projections, the decompressed
prefill at S=12 and at S=1536 (the reference's q-blocked branch), the
port's blocking at a ragged S against its own unblocked path (the
reference cannot take it: it reshapes by ``S // 512``), the absorbed
decode with the cache written in place, past ``cache_len`` included;
then the whole model (its engine is held to the reference's in
``test_torch_engine_families.py``).

Parameters come from the reference by value, built once; inputs come
from a seeded numpy generator; the reference's functions run under
``jax.jit``.  The tolerance is 1e-4 on the f32 reduced config."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_model_support import configs, run_model_both
from _torch_model_support import torch_one_thread  # noqa: F401
from repro.models import mla as ref_mla
from repro.models import params as ref_params
from repro_torch.models import mla as pt_mla
from repro_torch.models import model as pt_model
from repro_torch.models import params as pt_params

TOL = 1e-4
ARCH = "minicpm3-4b"


@functools.lru_cache(maxsize=None)
def _ref(name):
    """The reference's ``mla.<name>`` under ``jax.jit``, the config (and
    a prefill's cache length) static."""
    return jax.jit(getattr(ref_mla, name), static_argnums=(
        (1, 4) if name == "mla_prefill" else 1))


@functools.lru_cache(maxsize=None)
def _setup(seed=0):
    """One MLA layer's parameters, reference and port (same values),
    built once a process; the tests read them and never write them."""
    cfg_ref, cfg_pt = configs(ARCH)
    pr = ref_params.init_mla(jax.random.PRNGKey(seed), cfg_ref, jnp.float32)
    # non-zero latent norms, so that their scales are exercised too
    rng = np.random.default_rng(seed + 7)
    tree = jax.tree.map(np.asarray, pr)
    for name in ("q_norm_a", "kv_norm_a"):
        tree[name] = rng.standard_normal(tree[name].shape).astype(
            np.float32) * 0.1
    return (cfg_ref, cfg_pt, jax.tree.map(jnp.asarray, tree),
            pt_params.from_reference(tree, device="cpu"))


def _x(cfg, b, s, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.as_tensor(x)


def _pos(b, s):
    p = np.broadcast_to(np.arange(s)[None], (b, s))
    return jnp.asarray(p), torch.as_tensor(p.copy())


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL, err_msg=what)


def _entry(cfg, b, cache_len):
    return pt_model._empty_entry(cfg, "attn", (), b, cache_len, "cpu")


def test_projections_match_reference():
    cfg_ref, cfg_pt, pr, pt = _setup()
    (xr, xp), (qr, qp) = _x(cfg_ref, 2, 9), _pos(2, 9)
    for ref_out, pt_out in zip(
            _ref("_project_q")(pr, cfg_ref, xr, qr)
            + _ref("_project_kv_latent")(pr, cfg_ref, xr, qr),
            pt_mla._project_q(pt, cfg_pt, xp, qp)
            + pt_mla._project_kv_latent(pt, cfg_pt, xp, qp)):
        assert pt_out.shape == ref_out.shape
        _close(pt_out, ref_out)


@pytest.mark.parametrize("s,cache_len,slot", [(12, 16, 0), (12, 16, 1),
                                              (1536, 1536, 0)])
def test_prefill_matches_reference(s, cache_len, slot):
    """S=1536 runs the reference's blocked branch (3 blocks of 512).
    The latents land in rows ``slot:slot+B`` of a larger cache, the rest
    of those rows zeroed and the other rows untouched."""
    cfg_ref, cfg_pt, pr, pt = _setup()
    b = 1 if s > 1024 else 2
    (xr, xp), (qr, qp) = _x(cfg_ref, b, s), _pos(b, s)
    out_r, cache_r = _ref("mla_prefill")(pr, cfg_ref, xr, qr, cache_len)
    entry = _entry(cfg_pt, b + slot + 1, cache_len)
    for t in entry.values():
        t.fill_(3.0)
    out_p = pt_mla.mla_prefill(pt, cfg_pt, xp, qp, entry, slot)
    _close(out_p, out_r)
    for name in ("ckv", "kr"):
        _close(entry[name][slot:slot + b], cache_r[name], name)
        others = torch.cat([entry[name][:slot], entry[name][slot + b:]])
        assert bool((others == 3.0).all())


@pytest.mark.parametrize("s", [1100, 1025])
def test_blocked_prefill_at_ragged_s_equals_unblocked(monkeypatch, s):
    """Above 1024 tokens the port blocks q by 512 with a ragged last
    block; the blocks change no value against one unblocked pass."""
    _, cfg_pt, _, pt = _setup()
    xp, qp = _x(cfg_pt, 1, s)[1], _pos(1, s)[1]
    blocked = pt_mla.mla_prefill(pt, cfg_pt, xp, qp, _entry(cfg_pt, 1, s))
    monkeypatch.setattr(pt_mla, "_BLOCKED_THRESHOLD", 1 << 20)
    whole = pt_mla.mla_prefill(pt, cfg_pt, xp, qp, _entry(cfg_pt, 1, s))
    torch.testing.assert_close(blocked, whole, rtol=1e-5, atol=1e-5)


def test_decode_matches_reference_past_the_cache():
    """Prefill 13 into a 14-position cache, then 4 absorbed decode steps:
    the first fills the last position, the next three run past the end
    (the new latent is dropped and every position stays valid)."""
    cfg_ref, cfg_pt, pr, pt = _setup()
    b, s, cache_len = 2, 13, 14
    (xr, xp), (qr, qp) = _x(cfg_ref, b, s), _pos(b, s)
    _, cache_r = _ref("mla_prefill")(pr, cfg_ref, xr, qr, cache_len)
    entry = _entry(cfg_pt, b, cache_len)
    pt_mla.mla_prefill(pt, cfg_pt, xp, qp, entry)
    steps = np.random.default_rng(5).standard_normal(
        (4, b, 1, cfg_ref.d_model)).astype(np.float32)
    for t, x in enumerate(steps):
        position = np.full((b,), s + t, np.int32)
        out_r, cache_r = _ref("mla_decode")(pr, cfg_ref, jnp.asarray(x),
                                            jnp.asarray(position), cache_r)
        out_p = pt_mla.mla_decode(pt, cfg_pt, torch.as_tensor(x),
                                  torch.as_tensor(position), entry)
        _close(out_p, out_r, f"step {t}")
        for name in ("ckv", "kr"):
            _close(entry[name], cache_r[name], f"step {t} {name}")


@pytest.mark.parametrize("prompt,cache_len", [(12, 32), (13, 14)])
def test_mla_model_matches_reference(prompt, cache_len):
    run_model_both(ARCH, prompt, cache_len)
