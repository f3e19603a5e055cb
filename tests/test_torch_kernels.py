"""The port's attention kernels against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; those are held
against ``repro.kernels.*.ref`` and against the Pallas kernels in
interpret mode, on ``tests/test_kernels.py``'s shape sweep (2e-5 in f32,
2e-2 in bf16, as there).  Ragged query lengths and ``kv_len > S`` go
against the oracles only: the Pallas kernels assert divisibility.  The
CUDA kernels themselves are checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as ref_da
from repro.kernels.flash_attention import ops as ref_fa
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(rng, shape, dtype):
    """The same seeded values as a JAX array and a torch tensor."""
    x = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(pt, ref, tol):
    np.testing.assert_allclose(pt.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [
    # (B, S, H, KV, hd, bq, bk) -- tests/test_kernels.py's sweep
    (1, 128, 4, 4, 32, 64, 64),
    (2, 256, 8, 2, 64, 128, 64),
    (1, 512, 4, 1, 128, 128, 128),     # MQA
    (2, 128, 6, 2, 64, 128, 128),      # blocks > S get clamped
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_matches_reference_and_pallas(shape, dtype):
    b, s, h, kv, hd, bq, bk = shape
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, (b, s, n, hd), dtype)
                                    for n in (h, kv, kv))
    before = fa.launches
    out = fa.flash_attention(qt, kt, vt)
    assert fa.launches == before          # the plain version never counts
    assert out.dtype == qt.dtype and out.shape == qt.shape
    tol = DTYPES[dtype][2]
    _close(out, ref_fa.reference(qj, kj, vj), tol)
    _close(out, ref_fa.flash_attention(qj, kj, vj, block_q=bq, block_k=bk,
                                       interpret=True), tol)


@pytest.mark.parametrize("sq,skv,q_offset,causal", [
    (37, 37, 0, True),       # ragged prompt length
    (1, 1, 0, True),
    (200, 200, 0, True),     # the length the Pallas kernel refuses
    (5, 21, 16, True),       # a query chunk after a cached prefix
    (19, 45, 0, False),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_ragged_matches_reference(sq, skv, q_offset, causal,
                                              dtype):
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, (2, sq, 4, 32), dtype)
    kj, kt = _pair(rng, (2, skv, 2, 32), dtype)
    vj, vt = _pair(rng, (2, skv, 2, 32), dtype)
    out = fa.flash_attention(qt, kt, vt, causal=causal, q_offset=q_offset)
    ref = ref_fa.reference(qj, kj, vj, causal=causal, q_offset=q_offset)
    _close(out, ref, DTYPES[dtype][2])


@pytest.mark.parametrize("shape", [
    # (B, S, H, KV, hd, bk) -- tests/test_kernels.py's sweep
    (2, 256, 8, 2, 64, 64),
    (1, 512, 4, 4, 32, 128),
    (3, 128, 16, 2, 64, 128),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_plain_matches_reference_and_pallas(shape, dtype):
    b, s, h, kv, hd, bk = shape
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng, (b, 1, h, hd), dtype)
    kj, kt = _pair(rng, (b, s, kv, hd), dtype)
    vj, vt = _pair(rng, (b, s, kv, hd), dtype)
    lens = rng.integers(1, s + 1, b).astype(np.int32)
    before = da.launches
    out = da.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    assert da.launches == before
    assert out.dtype == qt.dtype and out.shape == qt.shape
    tol = DTYPES[dtype][2]
    lj = jnp.asarray(lens)
    _close(out, ref_da.reference(qj, kj, vj, lj), tol)
    _close(out, ref_da.decode_attention(qj, kj, vj, lj, block_k=bk,
                                        interpret=True), tol)


@pytest.mark.parametrize("lens", [
    [1, 24, 24, 0],          # 0: every position masked (uniform average)
    [25, 30, 1000, 7],       # past the cache: all S positions valid
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_plain_kv_len_edges_match_reference(lens, dtype):
    rng = np.random.default_rng(3)
    b, s = len(lens), 24
    qj, qt = _pair(rng, (b, 1, 8, 32), dtype)
    kj, kt = _pair(rng, (b, s, 4, 32), dtype)
    vj, vt = _pair(rng, (b, s, 4, 32), dtype)
    lens = np.asarray(lens, np.int32)
    out = da.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    ref = ref_da.reference(qj, kj, vj, jnp.asarray(lens))
    _close(out, ref, DTYPES[dtype][2])


def test_wrappers_refuse_other_devices():
    q = torch.empty((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.flash_attention(q, q, q)
    qd = torch.empty((1, 1, 2, 32), device="meta")
    kv = torch.empty((1, 8, 2, 32), device="meta")
    lens = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        da.decode_attention(qd, kv, kv, lens)

