"""The two training kernels' plain backward formulas
(``flash_attention_bwd_plain``, ``mamba_scan_bwd_plain``) against
``jax.grad`` of the kernels' refs (``repro.kernels.*.ref``) and against
torch autograd of the plain forwards, ragged S included: the yardsticks
``chip_smoke.py`` holds the CUDA backwards to on the card."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_model_support import torch_one_thread  # noqa: F401
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.mamba_scan import ops as ms


def _jax_fa_grads(q, k, v, do):
    def f(q, k, v):
        return jnp.sum(flash_attention_ref(q, k, v) * do)
    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("b,s,h,kvh,hd", [(2, 13, 4, 2, 16),
                                          (1, 1, 4, 4, 32),
                                          (2, 33, 8, 2, 32),
                                          (1, 70, 2, 1, 16)])
def test_flash_attention_bwd_plain_against_jax_grad(b, s, h, kvh, hd):
    rng = np.random.default_rng(s)
    q, k, v, do = (rng.standard_normal(sh).astype(np.float32) for sh in
                   ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd),
                    (b, s, h, hd)))
    want = _jax_fa_grads(*(jnp.asarray(x) for x in (q, k, v, do)))
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_lse_plain(tq, tk, tv)
    np.testing.assert_allclose(
        o.numpy(), np.asarray(flash_attention_ref(q, k, v)), atol=1e-5)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo)
    # and torch autograd of the plain forward
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    (fa.flash_attention_plain(*leaves) * tdo).sum().backward()
    # each gradient within 1e-5 of its own max |g|, floored at a tenth of
    # the largest of the three: at S=1 each row sees one key, and dq, dk
    # are exactly zero (rounding level on both sides)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w, a in zip(got, want, leaves):
        scale = max(float(np.abs(np.asarray(w)).max()), 0.1 * top)
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=1e-5 * scale, rtol=0)
        np.testing.assert_allclose(g.numpy(), a.grad.numpy(),
                                   atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("s", [1, 7, 16, 17, 32, 37])
def test_mamba_scan_bwd_plain_against_jax_grad(s):
    rng = np.random.default_rng(s)
    bsz, di, ds = 2, 12, 8
    xc = rng.standard_normal((bsz, s, di)).astype(np.float32)
    dt = (rng.random((bsz, s, di)) * 0.2).astype(np.float32)
    b = rng.standard_normal((bsz, s, ds)).astype(np.float32)
    c = rng.standard_normal((bsz, s, ds)).astype(np.float32)
    a_log = (rng.random((di, ds)) * 2 - 1).astype(np.float32)
    d = rng.standard_normal(di).astype(np.float32)
    dy = rng.standard_normal((bsz, s, di)).astype(np.float32)
    dh = rng.standard_normal((bsz, di, ds)).astype(np.float32)
    h0 = np.zeros((bsz, di, ds), np.float32)

    def f(xc, dt, b, c, a_log, d):
        y, h = mamba_scan_ref(xc, dt, b, c, a_log, d, h0)
        return jnp.sum(y * dy) + jnp.sum(h * dh)
    want = jax.grad(f, argnums=tuple(range(6)))(
        *(jnp.asarray(x) for x in (xc, dt, b, c, a_log, d)))
    ts = [torch.tensor(x) for x in (xc, dt, b, c, a_log, d)]
    got = ms.mamba_scan_bwd_plain(*ts, torch.tensor(dy), torch.tensor(dh))
    leaves = [t.clone().requires_grad_() for t in ts]
    y, h = ms.mamba_scan_plain(*leaves)
    ((y * torch.tensor(dy)).sum() + (h * torch.tensor(dh)).sum()).backward()
    for name, g, w, a in zip(("xc", "dt", "b", "c", "a_log", "d"), got,
                             want, leaves):
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=1e-5 * scale, rtol=0, err_msg=name)
        np.testing.assert_allclose(g.numpy(), a.grad.numpy(),
                                   atol=1e-5 * scale, rtol=0, err_msg=name)


def test_scan_backward_constants_match_the_source():
    """The wrapper sizes the saved states and the backward's scratch from
    ``kStateChunk``, ``kThreads``, ``kBwdLanes`` and ``kBwdCluster`` of the
    CUDA source: the states every STATE_CHUNK steps, a db/dc partial a
    cluster of BWD_CLUSTER blocks of BWD_THREADS / min(BWD_LANES, ds)
    channels."""
    src = (Path(ms.__file__).parent / "csrc" / "mamba_scan.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kStateChunk|kThreads|kBwdLanes|kBwdCluster) = "
        r"(\d+);", src)}
    assert consts == {"kStateChunk": ms.STATE_CHUNK,
                      "kThreads": ms.BWD_THREADS,
                      "kBwdLanes": ms.BWD_LANES,
                      "kBwdCluster": ms.BWD_CLUSTER}


_ATOMICS = re.compile(r"\batomic[A-Z]\w*\s*\(|\bred\.|\batom\.|"
                      r"cp\.reduce\.async\.bulk")


@pytest.mark.parametrize("kernel", ["flash_attention", "mamba_scan"])
def test_backward_kernels_use_no_atomics(kernel):
    """No atomic operation on a value in the training backwards (atomicAdd,
    PTX red. / atom., cp.reduce.async.bulk): every sum is taken in a fixed
    order, which the bit-equal resume of a training run depends on."""
    ops = {"flash_attention": fa, "mamba_scan": ms}[kernel]
    src = (Path(ops.__file__).parent / "csrc" / f"{kernel}.cu").read_text()
    code = re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)
    backward = code[code.index("_bwd"):]  # the first backward kernel on
    assert not _ATOMICS.search(backward)
    # the pattern does find one
    assert _ATOMICS.search("atomicAdd(p, x); red.global.add.f32 [p], x;")
