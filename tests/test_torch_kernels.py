"""The port's attention kernels against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; those are held
against ``repro.kernels.*.ref`` and against the Pallas kernels in
interpret mode, on ``tests/test_kernels.py``'s shape sweep (2e-5 in f32,
2e-2 in bf16, as there).  Ragged query lengths and ``kv_len > S`` go
against the oracles only: the Pallas kernels assert divisibility.  The
CUDA kernels themselves are checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import kernel as ref_da_kernel
from repro.kernels.decode_attention import ops as ref_da
from repro.kernels.flash_attention import ops as ref_fa
from repro.models.attention import quantize_kv as ref_quantize_kv
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


def _int8_pair(rng, shape):
    """The same int8 cache and bf16 scales [B,S,KV] on both sides: seeded
    normal K/V quantized by the JAX model's ``quantize_kv``, as the
    engines' caches and ``tests/test_kernels.py``'s int8 test hold them."""
    vals, scale = ref_quantize_kv(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32)))
    return ((vals, scale),
            (torch.from_numpy(np.array(vals)),
             torch.from_numpy(np.array(scale.astype(jnp.float32))).to(
                 torch.bfloat16)))


@pytest.mark.parametrize("kv_len", [1, 100, 256, 300])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_int8_plain_matches_pallas(kv_len, dtype):
    """The int8-cache mode's plain version against the Pallas kernel's
    int8 mode in interpret mode: atol 1e-2 (its output is bf16), at
    B=2, S=256, H=8, KV=2, hd=64, block_k=64, one kv_len past S."""
    b, s, h, kv, hd = 2, 256, 8, 2, 64
    rng = np.random.default_rng(4)
    qj, qt = _pair(rng, (b, 1, h, hd), dtype)
    (kj, ksj), (kt, kst) = _int8_pair(rng, (b, s, kv, hd))
    (vj, vsj), (vt, vst) = _int8_pair(rng, (b, s, kv, hd))
    lens = np.full((b,), kv_len, np.int32)
    before = (da.launches, da.launches_int8)
    out = da.decode_attention(qt, kt, vt, torch.from_numpy(lens),
                              k_scale=kst, v_scale=vst)
    assert (da.launches, da.launches_int8) == before
    assert out.dtype == qt.dtype and out.shape == qt.shape
    ref = ref_da_kernel.decode_attention_kernel(
        qj, kj, vj, jnp.asarray(lens), block_k=64, k_scale=ksj,
        v_scale=vsj, interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=1e-2)
    if dtype == np.float32:
        # the stated deviation, pinned: for an f32 q the port returns
        # the f32 result unrounded, where the Pallas kernel rounds it
        # through bf16 -- so the two differ by at most one bf16 ulp
        got, want = out.numpy(), np.asarray(ref, np.float32)
        mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-30)
        ulp = np.exp2(np.floor(np.log2(mag)) - 7)
        assert np.all(np.abs(got - want) <= ulp)
        assert np.array_equal(
            want, np.asarray(ref.astype(jnp.bfloat16).astype(jnp.float32)))
        assert bool((out != out.bfloat16().float()).any())


def test_decode_int8_plain_is_the_dequantized_float_mode():
    """The int8 plain version equals the float mode's plain version on
    the f32-dequantized cache, kv_len edges included."""
    rng = np.random.default_rng(5)
    _, (k, ks) = _int8_pair(rng, (4, 24, 2, 32))
    _, (v, vs) = _int8_pair(rng, (4, 24, 2, 32))
    q = torch.from_numpy(rng.standard_normal((4, 1, 4, 32)).astype(
        np.float32))
    lens = torch.tensor([0, 1, 24, 40], dtype=torch.int32)
    got = da.decode_attention(q, k, v, lens, k_scale=ks, v_scale=vs)
    want = da.decode_attention_plain(q, k.float() * ks.float()[..., None],
                                     v.float() * vs.float()[..., None],
                                     lens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="both"):
        da.decode_attention(q, k, v, lens, k_scale=ks)


def _cu_int(name):
    """An integer constant of the decode kernels' source."""
    src = (pathlib.Path(da.__file__).parent / "csrc"
           / "decode_attention.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _split_merge(q, k, v, lens, n_split, granule, k_scale=None,
                 v_scale=None):
    """The split kernel's algorithm (``dec_split``) in plain f32 torch,
    over a bf16 cache or an int8 one with its scales: block ``rank`` of
    ``n_split`` sweeps positions [rank * chunk, (rank + 1) * chunk) of
    min(kv_len, S) -- all S, masked, for kv_len below 1 -- with chunk =
    ceil(len / n_split) rounded up to ``granule``, and leaves (m, l,
    acc); the partials are merged in rank order.  Returns the output and
    each row's partials' l."""
    b, _, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale.float()[..., None]
        vf = vf * v_scale.float()[..., None]
    out, ls = torch.empty(b, 1, h, hd), []
    for bi in range(b):
        n = int(lens[bi])
        none = n <= 0
        n = s if none else min(n, s)
        chunk = -(-(-(-n // n_split)) // granule) * granule
        qg = q[bi, 0].float().reshape(kv, h // kv, hd)
        parts = []
        for rank in range(n_split):
            lo = min(rank * chunk, n)
            hi = min(lo + chunk, n)
            sc = torch.einsum("kgd,skd->kgs", qg, kf[bi, lo:hi]) / math.sqrt(
                hd)
            if none:
                sc = torch.full_like(sc, -1e30)
            m = (sc.amax(-1) if hi > lo
                 else torch.full(sc.shape[:2], -1e30))
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1),
                          torch.einsum("kgs,skd->kgd", p, vf[bi, lo:hi])))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        den = sum(l_ * torch.exp(m - mx) for m, l_, _ in parts)
        num = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
        out[bi, 0] = (num / den.clamp_min(1e-20)[..., None]).reshape(h, hd)
        ls.append([l_ for _, l_, _ in parts])
    return out, ls


@pytest.mark.parametrize("cache", ["int8", "bfloat16"])
@pytest.mark.parametrize("lens", [
    [0, 1, 63, 64, 65],          # all masked; one block exactly full
    [255, 256, 257, 511, 512],   # a block's tail; all 8 blocks full
    [513, 575, 576, 600, 900],   # the next granule; S; past S
])
def test_decode_int8_split_merge_matches_plain(lens, cache):
    """The split kernel's split-and-merge algorithm, for the int8 cache
    and the bf16 cache alike, written here in plain torch with the
    kernel's constants (8 blocks per cluster, 64-row granule), equals the
    plain version at the split's edges; empty blocks contribute l = 0.
    This holds the algorithm, not the kernel: the kernel itself is held
    at these edges by ``test_torch_cuda.py``'s
    ``test_cuda_decode_int8_split_edges_match_plain`` and
    ``test_cuda_decode_bf16_split_edges_match_plain``."""
    n_split = _cu_int("kSplit")
    granule = _cu_int("kWarps") * _cu_int("kWarpRows")
    assert (n_split, granule) == (8, 64)
    rng = np.random.default_rng(6)
    b, s, h, kv, hd = len(lens), 600, 4, 2, 32
    if cache == "int8":
        _, (k, ks) = _int8_pair(rng, (b, s, kv, hd))
        _, (v, vs) = _int8_pair(rng, (b, s, kv, hd))
    else:
        (_, k), (_, v) = (_pair(rng, (b, s, kv, hd), cache)
                          for _ in range(2))
        ks = vs = None
    q = torch.from_numpy(rng.standard_normal((b, 1, h, hd)).astype(
        np.float32))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    got, ls = _split_merge(q, k, v, lens_t, n_split, granule, ks, vs)
    want = da.decode_attention_plain(q, k, v, lens_t, ks, vs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for n, row in zip(lens, ls):
        n = s if n <= 0 else min(n, s)
        chunk = -(-(-(-n // n_split)) // granule) * granule
        used = -(-n // chunk)
        assert all(bool((l_ > 0).all()) for l_ in row[:used])
        assert all(bool((l_ == 0).all()) for l_ in row[used:])


def test_wrappers_refuse_other_devices():
    # a device with no kernel and no plain branch (meta has the dry-run's)
    from _torch_device_support import no_kernel_tensor
    q = no_kernel_tensor((1, 4, 2, 32))
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.flash_attention(q, q, q)
    qd = no_kernel_tensor((1, 1, 2, 32))
    kv = no_kernel_tensor((1, 8, 2, 32))
    lens = no_kernel_tensor((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel for device"):
        da.decode_attention(qd, kv, kv, lens)

