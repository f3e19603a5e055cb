"""The PyTorch port's model against the JAX reference: prefill + 4 decode
steps on reduced configs, with the reference's parameters carried over by
value.  Logits and cache contents agree within 1e-4 abs/rel (f32 reduced
configs; the two frameworks sum in different orders), with the JAX model
on its jnp path and on its Pallas kernels (interpret mode on the CPU)."""
import dataclasses

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


def _configs(arch, **over):
    return (dataclasses.replace(REF_REGISTRY[arch].reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_cache_equal(ref_cache, pt_cache):
    np.testing.assert_array_equal(np.asarray(ref_cache["pos"]),
                                  pt_cache["pos"].numpy())
    for ref_e, pt_e in zip(ref_cache["layers"], pt_cache["layers"]):
        assert set(ref_e) == set(pt_e)
        for name in ref_e:
            if pt_e[name].dtype == torch.int8:
                # K/V within f32 rounding of a rounding boundary land on
                # the neighbouring int8 level: at most one level, rarely
                diff = np.abs(_np(pt_e[name]) - _np(ref_e[name]))
                assert diff.max() <= 1 and (diff > 0).mean() < 0.02, name
                continue
            np.testing.assert_allclose(_np(pt_e[name]), _np(ref_e[name]),
                                       rtol=TOL, atol=TOL, err_msg=name)


def _run_both(cfg_ref, cfg_pt, prompt, cache_len, steps=4, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg_ref.vocab_size, (2, prompt + steps))
    pr = ref_params.init_params(jax.random.PRNGKey(seed), cfg_ref)
    pt = pt_params.from_reference(jax.tree.map(np.asarray, pr),
                                  device="cpu")
    ref_logits, ref_cache = ref_model.prefill(
        pr, cfg_ref, tokens=jnp.asarray(toks[:, :prompt], jnp.int32),
        cache_len=cache_len)
    pt_logits, pt_cache = pt_model.prefill(
        pt, cfg_pt, torch.as_tensor(toks[:, :prompt]), cache_len=cache_len)
    out = [(ref_logits, pt_logits)]
    _assert_cache_equal(ref_cache, pt_cache)
    for t in range(steps):
        col = toks[:, prompt + t]
        ref_logits, ref_cache = ref_model.decode_step(
            pr, cfg_ref, ref_cache, tokens=jnp.asarray(col, jnp.int32))
        pt_logits, pt_cache = pt_model.decode_step(
            pt, cfg_pt, pt_cache, torch.as_tensor(col))
        out.append((ref_logits, pt_logits))
    _assert_cache_equal(ref_cache, pt_cache)
    return out


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama-2-7b"])
@pytest.mark.parametrize("prompt,cache_len", [
    (12, 32),    # the plain case
    (13, 14),    # ragged prompt; decode runs 3 tokens past cache_len
])
def test_prefill_decode_matches_reference(arch, use_pallas, prompt,
                                          cache_len):
    cfg_ref, cfg_pt = _configs(arch, use_pallas=use_pallas)
    with torch.no_grad():
        pairs = _run_both(cfg_ref, cfg_pt, prompt, cache_len)
    for i, (ref, pt) in enumerate(pairs):
        assert pt.shape == ref.shape
        np.testing.assert_allclose(_np(pt), _np(ref), rtol=TOL, atol=TOL,
                                   err_msg=f"step {i}")


def test_int8_kv_cache_matches_reference():
    """gemma-7b (GeGLU, scaled embeddings, softcap) with the int8 KV
    cache.  Prefill logits (computed before quantization) agree within
    1e-4; decode logits within 2e-2, the int8 bound of
    ``test_kernels.py::test_decode_attention_int8_cache``, since a cached
    value may sit one int8 level apart (see ``_assert_cache_equal``).
    And the port's int8 decode stays within 5% relative logit error of
    its own f32-cache decode, as
    ``test_kernels.py::test_int8_kv_cache_decode_matches_bf16`` holds the
    reference."""
    cfg_ref, cfg_pt = _configs("gemma-7b", kv_cache_dtype="int8")
    with torch.no_grad():
        pairs = _run_both(cfg_ref, cfg_pt, prompt=12, cache_len=16)
        exact = _run_both(*_configs("gemma-7b"), prompt=12, cache_len=16)
    for i, (ref, pt) in enumerate(pairs):
        tol = TOL if i == 0 else 2e-2
        np.testing.assert_allclose(_np(pt), _np(ref), rtol=tol, atol=tol,
                                   err_msg=f"step {i}")
    errs = [float(np.abs(_np(q[1]) - _np(e[1])).max())
            for q, e in zip(pairs, exact)]
    scale = max(float(np.abs(_np(e[1])).max()) for e in exact)
    assert max(errs) / scale < 0.05


def test_unported_layer_kinds_raise():
    for arch in ("falcon-mamba-7b", "minicpm3-4b", "deepseek-moe-16b",
                 "llama-3.2-vision-11b"):
        cfg = get_config(arch).reduced()
        with pytest.raises(NotImplementedError, match="later slice"):
            pt_model.init_cache(cfg, 1, 8, device="cpu")


def test_count_params_matches_reference_and_tree():
    from repro.models.params import count_params as ref_count
    for arch in REF_REGISTRY:
        cfg = get_config(arch)
        assert pt_params.count_params(cfg) == ref_count(REF_REGISTRY[arch])
    cfg = get_config("qwen3-0.6b").reduced()
    gen = torch.Generator().manual_seed(0)
    tree = pt_params.init_params(cfg, gen, device="cpu")
    assert pt_params.count_tensor_params(tree) == cfg.count_params()
