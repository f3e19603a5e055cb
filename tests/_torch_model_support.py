"""Shared set-up of the whole-model parity tests of every family
(``test_torch_moe.py``, ``test_torch_mla.py``,
``test_torch_families.py``).

``run_model_both`` builds one reduced config on both sides with the
reference's parameters carried over by value, runs the reference's
``prefill`` and four ``decode_step`` calls and the port's on the same
seeded inputs (token ids, or frame embeddings for
``input_mode="embeddings"``; seeded vision inputs where the config has
cross-attention layers, whose zero-initialised gates are set to 0.5 and
-0.3 on both sides so that the layers add something), and holds logits
and every cache entry (the dense first layer's included) within 1e-4.

The reference's functions run under ``jax.jit`` (one compile for each
config and shape, where an eager call traces its layer scan anew every
time), and a config's parameters are built once in a process and shared.
Torch runs on one intra-op thread in the files that use
``torch_one_thread``: the reduced models are tiny, and parallel test
workers would otherwise oversubscribe the cores."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as REF_REGISTRY
from repro.models import model as ref_model
from repro.models import params as ref_params
from repro_torch.configs import get_config
from repro_torch.models import model as pt_model
from repro_torch.models import params as pt_params

TOL = 1e-4
GATES = {"gate_attn": 0.5, "gate_ffn": -0.3}


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """One torch intra-op thread for the module's tests; the previous
    setting is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def configs(arch, **over):
    """(reference, port) reduced configs; a mamba config's reference
    scan chunk is raised to 128 (the reduced caches' length), so that
    its scans take every prompt (the chunk leaves the function
    unchanged; the port has none)."""
    cfg_ref = dataclasses.replace(REF_REGISTRY[arch].reduced(), **over)
    if cfg_ref.mamba is not None:
        cfg_ref = dataclasses.replace(cfg_ref, mamba=dataclasses.replace(
            cfg_ref.mamba, chunk=128))
    return cfg_ref, dataclasses.replace(get_config(arch).reduced(), **over)


@functools.lru_cache(maxsize=None)
def _ref_tree(cfg_ref, seed):
    tree = jax.tree.map(np.asarray, ref_params.init_params(
        jax.random.PRNGKey(seed), cfg_ref))
    for layer in tree["layers"]:
        for name, g in GATES.items():
            if name in layer:
                layer[name] = np.full_like(layer[name], g)
    return tree


@functools.lru_cache(maxsize=None)
def params_both(cfg_ref, seed=0):
    """The reference's parameters (cross gates set to ``GATES``) and the
    same values in the port, built once a process for each config; the
    callers read them and never write them."""
    tree = _ref_tree(cfg_ref, seed)
    return (jax.tree.map(jnp.asarray, tree),
            pt_params.from_reference(tree, device="cpu"))


_ref_prefill = jax.jit(ref_model.prefill,
                       static_argnames=("cfg", "cache_len"))
_ref_decode = jax.jit(ref_model.decode_step, static_argnames=("cfg",))


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_cache_close(ref_cache, pt_cache):
    assert set(ref_cache) == set(pt_cache)
    np.testing.assert_array_equal(np.asarray(ref_cache["pos"]),
                                  pt_cache["pos"].numpy())
    pairs = list(zip(ref_cache["layers"], pt_cache["layers"]))
    if "first_layer" in ref_cache:
        pairs.append((ref_cache["first_layer"], pt_cache["first_layer"]))
    for ref_e, pt_e in pairs:
        assert set(ref_e) == set(pt_e)
        for name in ref_e:
            np.testing.assert_allclose(np32(pt_e[name]), np32(ref_e[name]),
                                       rtol=TOL, atol=TOL, err_msg=name)


def inputs(cfg, batch, length, seed=0):
    """Seeded model inputs of ``length`` positions: {"tokens"} or
    {"embeds"}, plus {"vision"} for a config with cross-attention."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, length))}
    else:
        out = {"embeds": rng.standard_normal(
            (batch, length, cfg.d_model)).astype(np.float32)}
    if cfg.vision_tokens:
        out["vision"] = rng.standard_normal(
            (batch, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    return out


def _take(inp, start, stop):
    """The prompt's (or a decode step's) slice of each input."""
    out = {k: v[:, start:stop] for k, v in inp.items() if k != "vision"}
    if stop - start == 1 and "tokens" in out:
        out["tokens"] = out["tokens"][:, 0]
    return out


def run_model_both(arch, prompt, cache_len, steps=4, seed=0, **over):
    """Prefill ``prompt`` positions and decode ``steps`` more on both
    sides; logits after each call and both caches after the prefill and
    after the last step agree within 1e-4.  A decode step at or past
    ``cache_len`` runs past the cache (the reference drops the write)."""
    cfg_ref, cfg_pt = configs(arch, **over)
    pr, pt = params_both(cfg_ref, seed)
    inp = inputs(cfg_ref, 2, prompt + steps, seed)
    vis = {"vision": inp["vision"]} if "vision" in inp else {}

    def ref_args(d):
        return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else None)
                for k, v in d.items()}

    def pt_args(d):
        return {k: torch.as_tensor(v) for k, v in d.items()}
    first = dict(_take(inp, 0, prompt), **vis)
    ref_logits, ref_cache = _ref_prefill(pr, cfg=cfg_ref,
                                         cache_len=cache_len,
                                         **ref_args(first))
    with torch.no_grad():
        pt_logits, pt_cache = pt_model.prefill(
            pt, cfg_pt, cache_len=cache_len, **pt_args(first))
    pairs = [(ref_logits, pt_logits)]
    assert_cache_close(ref_cache, pt_cache)
    for t in range(steps):
        step = _take(inp, prompt + t, prompt + t + 1)
        ref_logits, ref_cache = _ref_decode(pr, cfg=cfg_ref,
                                            cache=ref_cache,
                                            **ref_args(step))
        with torch.no_grad():
            pt_logits, pt_cache = pt_model.decode_step(
                pt, cfg_pt, pt_cache, **pt_args(step))
        pairs.append((ref_logits, pt_logits))
    assert_cache_close(ref_cache, pt_cache)
    for i, (ref, got) in enumerate(pairs):
        assert got.shape == ref.shape == (2, cfg_pt.vocab_size)
        np.testing.assert_allclose(np32(got), np32(ref), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
    return pairs
