"""The port's Mamba-1 path against the JAX package's: the selective
scan's plain version (against the Pallas kernel in interpret mode and
the sequential oracle), the mamba block's sequence and decode forms,
reduced falcon-mamba prefill + decode, and the serving CLI over reduced
falcon-mamba engines.

Inputs are made with numpy from a seed and handed to both sides;
parameters go from the reference to the port by value.  Tolerances:
1e-4 in f32 (``tests/test_kernels.py``'s bound for this kernel), 2e-2
where xc, b and c are bf16.  The reference's scans assert
``S % min(chunk, S) == 0``; where a length is ragged against its chunk,
the reference's config gets a chunk at least the sequence length (the
chunk leaves the function unchanged), so ragged lengths are held to the
reference too.  The CUDA kernel itself is checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import dataclasses
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as REF_REGISTRY
from repro.kernels.mamba_scan import ops as ref_ms
from repro.models import mamba as ref_mamba
from repro.models import model as ref_model
from repro.models import params as ref_params
from repro_torch.configs import get_config
from repro_torch.kernels.mamba_scan import ops as ms
from repro_torch.launch import serve as pt_serve
from repro_torch.models import mamba as pt_mamba
from repro_torch.models import model as pt_model
from repro_torch.models import params as pt_params

ARCH = "falcon-mamba-7b"
TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x, dtype):
    """The same numpy values as a JAX array and a torch tensor."""
    jdt, tdt = DTYPES[dtype]
    x = x.astype(np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _scan_inputs(rng, b, s, di, ds, act_dtype="float32"):
    """xc, dt, b, c, a_log, d as (jax, torch) pairs, drawn as
    ``tests/test_kernels.py`` draws them; dt and a_log, d stay f32 (the
    model's dtypes), xc/b/c take ``act_dtype``."""
    xc = rng.standard_normal((b, s, di))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)))) * 0.1
    bm = rng.standard_normal((b, s, ds))
    cm = rng.standard_normal((b, s, ds))
    al = np.log(np.abs(rng.standard_normal((di, ds))) + 0.5)
    d = np.ones((di,))
    return (_pair(xc, act_dtype), _pair(dt, "float32"),
            _pair(bm, act_dtype), _pair(cm, act_dtype),
            _pair(al, "float32"), _pair(d, "float32"))


@pytest.mark.parametrize("shape", [
    # (B, S, di, ds, chunk, block_c) -- tests/test_kernels.py's shapes
    (1, 64, 128, 8, 16, 64),
    (2, 32, 256, 16, 32, 128),
    (1, 128, 128, 4, 64, 128),
])
@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_scan_plain_matches_pallas_and_reference(shape, act_dtype):
    b, s, di, ds, chunk, bc = shape
    pairs = _scan_inputs(np.random.default_rng(0), b, s, di, ds, act_dtype)
    jx = [p[0] for p in pairs]
    tx = [p[1] for p in pairs]
    before = ms.launches
    y, hf = ms.mamba_scan(*tx)
    assert ms.launches == before          # the plain version never counts
    assert y.dtype == tx[0].dtype and y.shape == tx[0].shape
    assert hf.dtype == torch.float32 and hf.shape == (b, di, ds)
    tol = TOL if act_dtype == "float32" else 2e-2
    yk, hk = ref_ms.mamba_scan(*jx, chunk=chunk, block_c=bc,
                               interpret=True)
    yr, hr = ref_ms.reference(*jx, jnp.zeros((b, di, ds)))
    for got, want in ((y, yk), (hf, hk), (y, yr), (hf, hr)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("s", [1, 37, 50])
def test_scan_plain_ragged_matches_reference(s):
    """Any S, against the sequential oracle (the Pallas kernel asserts
    S % chunk == 0)."""
    pairs = _scan_inputs(np.random.default_rng(s), 2, s, 128, 8)
    y, hf = ms.mamba_scan(*(p[1] for p in pairs))
    yr, hr = ref_ms.reference(*(p[0] for p in pairs),
                              jnp.zeros((2, 128, 8)))
    np.testing.assert_allclose(_np(y), _np(yr), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(hf), _np(hr), rtol=TOL, atol=TOL)


def _cu_int(name):
    """An integer constant of the scan kernel's source."""
    src = (pathlib.Path(ms.__file__).parent / "csrc"
           / "mamba_scan.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _scan_lanes(xc, dt, b, c, a_log, d, lanes, group):
    """The scan kernel's algorithm in plain f32 torch: the d_state states
    of a channel split over ``lanes`` lanes (ds / lanes consecutive states
    each, summed in order into the lane's part of y, lane 0 starting from
    d * x); exp(dt * a) as exp2(dt * (a * log2 e)); each lane's parts of a
    ``group``-step group kept and reduced over the lanes once per group,
    in the kernel's reduce-scatter order ((p0 + p2) + (p1 + p3))."""
    assert lanes == 4
    bsz, s, di = xc.shape
    ds = b.shape[2]
    ns = ds // lanes
    a2 = -torch.exp(a_log) * math.log2(math.e)               # [di,ds]
    dsel = torch.zeros(lanes, di)
    dsel[0] = d
    h = torch.zeros(bsz, di, ds)
    ys = []
    for t0 in range(0, s, group):
        parts = []                                   # [B,lanes,di] a step
        for t in range(t0, min(t0 + group, s)):
            x_t, dt_t = xc[:, t], dt[:, t]                    # [B,di]
            h = torch.exp2(dt_t[..., None] * a2) * h \
                + (dt_t * x_t)[..., None] * b[:, t, None, :]
            hc = (h * c[:, t, None, :]).reshape(bsz, di, lanes, ns)
            p = dsel.T[None] * x_t[..., None]                # [B,di,lanes]
            for j in range(ns):
                p = p + hc[..., j]
            parts.append(p)
        p = torch.stack(parts, 1)                     # [B,steps,di,lanes]
        ys.append((p[..., 0] + p[..., 2]) + (p[..., 1] + p[..., 3]))
    return torch.cat(ys, 1), h


@pytest.mark.parametrize("s,ds", [(1, 16), (64, 8), (150, 16), (97, 4)])
def test_scan_lane_partition_matches_plain_and_reference(s, ds):
    """The scan kernel's lane partition, exp2 and per-group reduction
    (its constants read from ``mamba_scan.cu``), in plain torch, against
    the plain version and the JAX reference with a random a_log per
    (channel, state), S one step, a multiple of the kernel's 8-step
    groups and 64-step chunks, and ragged against both: 1e-5.  This
    holds the algorithm, not the kernel: the kernel is held on the card
    by ``test_torch_cuda.py``."""
    lanes, group = _cu_int("kLanes"), _cu_int("kGroup")
    assert (lanes, group) == (4, 8)
    pairs = _scan_inputs(np.random.default_rng(s), 2, s, 24, ds)
    tx = [p[1] for p in pairs]
    y, hf = _scan_lanes(*tx, lanes, group)
    y_plain, h_plain = ms.mamba_scan_plain(*tx)
    yr, hr = ref_ms.reference(*(p[0] for p in pairs), jnp.zeros((2, 24, ds)))
    for got, want in ((y, y_plain), (hf, h_plain), (y, yr), (hf, hr)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)


def test_scan_wrapper_refuses_other_devices():
    # a device with no kernel and no plain branch (meta has the dry-run's)
    from _torch_device_support import no_kernel_tensor
    t = no_kernel_tensor((1, 4, 128))
    bm = no_kernel_tensor((1, 4, 8))
    with pytest.raises(ValueError, match="no kernel for device"):
        ms.mamba_scan(t, t, bm, bm, no_kernel_tensor((128, 8)),
                      no_kernel_tensor((128,)))


def _configs(over_ref=None, **over):
    """(reference, port) reduced falcon-mamba configs; ``over_ref``
    replaces fields of the reference's ``mamba`` config only."""
    ref = REF_REGISTRY[ARCH].reduced(**over)
    if over_ref:
        ref = dataclasses.replace(ref, mamba=dataclasses.replace(
            ref.mamba, **over_ref))
    return ref, get_config(ARCH).reduced(**over)


def _layer_params(cfg_ref):
    """One mamba layer's parameters (position 0 of the stack) on both
    sides; dt_bias is randomised so that softplus sees both signs."""
    pr = ref_params.init_params(jax.random.PRNGKey(0), cfg_ref)
    p = jax.tree.map(lambda a: a[0], pr["layers"][0]["mamba"])
    p["dt_bias"] = jnp.asarray(np.random.default_rng(5).standard_normal(
        p["dt_bias"].shape), p["dt_bias"].dtype)
    return p, pt_params.from_reference(jax.tree.map(np.asarray, p),
                                       device="cpu")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("s", [32, 12])
def test_mamba_block_matches_reference(use_pallas, s):
    """``mamba_seq`` and three ``mamba_decode`` steps on its states:
    outputs and conv/ssm states within 1e-4 of the reference's (jnp
    chunked scan, or the Pallas kernel in interpret mode)."""
    cfg_ref, cfg_pt = _configs()
    pr, pt = _layer_params(cfg_ref)
    x = np.random.default_rng(1).standard_normal((2, s + 3, cfg_pt.d_model))
    xj, xt = _pair(x, "float32")
    yr, st_r = ref_mamba.mamba_seq(pr, cfg_ref, xj[:, :s],
                                   use_pallas=use_pallas)
    with torch.no_grad():
        yp, st_p = pt_mamba.mamba_seq(pt, cfg_pt, xt[:, :s])
    pairs = [(yp, yr)] + [(st_p[k], st_r[k]) for k in ("conv", "ssm")]
    for t in range(s, s + 3):
        yr, st_r = ref_mamba.mamba_decode(pr, cfg_ref, xj[:, t:t + 1], st_r)
        with torch.no_grad():
            yp, st_p = pt_mamba.mamba_decode(pt, cfg_pt, xt[:, t:t + 1],
                                             st_p)
        pairs += [(yp, yr)] + [(st_p[k], st_r[k]) for k in ("conv", "ssm")]
    for i, (got, want) in enumerate(pairs):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL,
                                   err_msg=f"output {i}")


@pytest.mark.parametrize("prompt,over_ref", [
    (32, None),               # a multiple of the reduced chunk (16)
    (37, {"chunk": 64}),      # ragged: the reference's chunk raised
])
def test_prefill_decode_matches_reference(prompt, over_ref):
    """Reduced falcon-mamba (2 layers, each mamba + FFN): prefill and 4
    decode steps; logits and every cache entry within 1e-4."""
    cfg_ref, cfg_pt = _configs(over_ref)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_ref.vocab_size, (2, prompt + 4))
    pr = ref_params.init_params(jax.random.PRNGKey(0), cfg_ref)
    pt = pt_params.from_reference(jax.tree.map(np.asarray, pr),
                                  device="cpu")
    ref_logits, ref_cache = ref_model.prefill(
        pr, cfg_ref, tokens=jnp.asarray(toks[:, :prompt], jnp.int32),
        cache_len=16)
    with torch.no_grad():
        # cache_len is shorter than the prompt: an SSM state has no length
        pt_logits, pt_cache = pt_model.prefill(
            pt, cfg_pt, torch.as_tensor(toks[:, :prompt]), cache_len=16)
    pairs = [(pt_logits, ref_logits)]
    _assert_cache_close(pt_cache, ref_cache)   # the port's is updated
    for t in range(prompt, prompt + 4):        # in place from here on
        col = toks[:, t]
        ref_logits, ref_cache = ref_model.decode_step(
            pr, cfg_ref, ref_cache, tokens=jnp.asarray(col, jnp.int32))
        with torch.no_grad():
            pt_logits, pt_cache = pt_model.decode_step(
                pt, cfg_pt, pt_cache, torch.as_tensor(col))
        pairs.append((pt_logits, ref_logits))
    _assert_cache_close(pt_cache, ref_cache)
    for i, (got, want) in enumerate(pairs):
        assert tuple(got.shape) == (2, cfg_pt.vocab_size)
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL,
                                   err_msg=f"step {i}")


def _assert_cache_close(got, want):
    np.testing.assert_array_equal(got["pos"].numpy(),
                                  np.asarray(want["pos"]))
    for e_pt, e_ref in zip(got["layers"], want["layers"]):
        assert set(e_pt) == set(e_ref) == {"conv", "ssm"}
        for name in e_ref:
            np.testing.assert_allclose(_np(e_pt[name]), _np(e_ref[name]),
                                       rtol=TOL, atol=TOL, err_msg=name)


def test_params_and_cache_layout():
    """The reference's tree and cache layout, and the analytic count:
    full width 7,272,665,088 parameters; the reduced config has an FFN
    (d_ff=128), the full one none (d_ff=0)."""
    cfg_ref, cfg_pt = _configs()
    tree = pt_params.init_params(cfg_pt, torch.Generator().manual_seed(0),
                                 device="cpu")
    ref_tree = ref_params.init_params(jax.random.PRNGKey(0), cfg_ref)
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                          ref_tree)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace(
        "torch.", "")), tree) == shapes
    assert pt_params.count_tensor_params(tree) == cfg_pt.count_params()
    assert get_config(ARCH).count_params() == 7_272_665_088
    assert "ffn" in tree["layers"][0]
    ref_cache = ref_model.init_cache(cfg_ref, 3, 16)
    cache = pt_model.init_cache(cfg_pt, 3, 16, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), cache) == jax.tree.map(
        lambda a: tuple(a.shape), ref_cache)


def test_serve_cli_runs_falcon_mamba(capsys):
    """The port's CLI serves its own stream (prompts 10-79 tokens, most
    ragged against the reduced chunk of 16, which the reference's
    engine refuses) over reduced falcon-mamba engines to the end."""
    with torch.no_grad():
        pt_serve.main(["--mode", "gateway", "--backend", "engine",
                       "--arch", ARCH, "--requests", "6", "--instances",
                       "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served n=6 admitted=6 shed=0" in out
    with torch.no_grad():
        pt_serve.main(["--mode", "engine", "--arch", ARCH,
                       "--requests", "4", "--instances", "2",
                       "--device", "cpu"])
    assert "'n': 4" in capsys.readouterr().out
