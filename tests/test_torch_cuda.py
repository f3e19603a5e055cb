"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and nvcc; without a card they skip.  The
file imports nothing of JAX, so it runs where only PyTorch is installed:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.mamba_scan import ops as ms
from repro_torch.models import model as model_lib
from repro_torch.models import params as params_lib

# bf16 / f32 tolerances of tests/test_kernels.py
TOLS = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have "
                    "no CPU mode (chip_smoke.py also runs them on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, dev, dtype, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    tol = TOLS[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for sq, h, kv, hd in ((1, 16, 8, 128), (37, 16, 8, 128),
                          (128, 16, 8, 128), (901, 16, 8, 128),
                          (200, 8, 1, 64), (45, 4, 4, 32)):
        q = _rand(g, cuda_device, dtype, 2, sq, h, hd)
        k = _rand(g, cuda_device, dtype, 2, sq, kv, hd)
        v = _rand(g, cuda_device, dtype, 2, sq, kv, hd)
        before = fa.launches
        out = fa.flash_attention(q, k, v)
        assert fa.launches == before + 1
        torch.testing.assert_close(
            out.float(), fa.flash_attention_plain(q, k, v).float(),
            rtol=tol, atol=tol)
    q = _rand(g, cuda_device, dtype, 8, 1, 16, 128)
    k = _rand(g, cuda_device, dtype, 8, 1024, 8, 128)
    v = _rand(g, cuda_device, dtype, 8, 1024, 8, 128)
    lens = torch.tensor([1, 5, 100, 513, 1000, 1023, 1024, 1030],
                        dtype=torch.int32, device=cuda_device)
    before = da.launches
    out = da.decode_attention(q, k, v, lens)
    assert da.launches == before + 1
    torch.testing.assert_close(
        out.float(), da.decode_attention_plain(q, k, v, lens).float(),
        rtol=tol, atol=tol)
    torch.cuda.synchronize()


def _int8_cache(g, dev, b, s, kv, hd):
    """A random int8 cache and its bf16 scales, as the model's
    ``quantize_kv`` lays them out ([B,S,KV,hd] and [B,S,KV])."""
    vals = torch.randint(-127, 128, (b, s, kv, hd), generator=g,
                         device=dev).to(torch.int8)
    scale = (torch.rand((b, s, kv), generator=g, device=dev) * 0.05
             + 1e-3).to(torch.bfloat16)
    return vals, scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_decode_int8_matches_plain(cuda_device, dtype):
    """The int8-cache mode against its plain version, at llama-2-7b's
    decode shapes (MHA, hd=128) and a GQA shape, kv_len incl. 1, S and
    past S; 2e-2 as for the bf16 mode."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for b, s, h, kv, hd in ((8, 2048, 32, 32, 128), (2, 256, 8, 2, 64),
                            (3, 96, 4, 4, 32)):
        q = _rand(g, cuda_device, dtype, b, 1, h, hd)
        k, ks = _int8_cache(g, cuda_device, b, s, kv, hd)
        v, vs = _int8_cache(g, cuda_device, b, s, kv, hd)
        lens = torch.tensor([1, s, s + 52, 0, 17, s // 2, s - 1, 100][:b],
                            dtype=torch.int32, device=cuda_device)
        before, before_f = da.launches_int8, da.launches
        out = da.decode_attention(q, k, v, lens, k_scale=ks, v_scale=vs)
        assert (da.launches_int8, da.launches) == (before + 1, before_f)
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(
            out.float(),
            da.decode_attention_plain(q, k, v, lens, ks, vs).float(),
            rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_cuda_flash_bf16_tensor_cores_match_plain(cuda_device, hd):
    """The bf16 kernel (tensor cores, 64-row q tiles, 64-key K/V tiles)
    against its plain version: Sq across the tiles' edges, GQA and MHA,
    a query chunk after a cached prefix (q_offset > 0) and non-causal;
    2e-2 covers P rounded to bf16 before P V."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for b, sq, skv, h, kv, off, causal in (
            (1, 1, 1, 8, 2, 0, True), (2, 63, 63, 8, 2, 0, True),
            (1, 64, 64, 4, 4, 0, True), (1, 65, 65, 8, 1, 0, True),
            (2, 200, 200, 8, 2, 0, True), (1, 130, 300, 4, 2, 170, True),
            (1, 77, 150, 8, 2, 0, False), (1, 129, 64, 4, 4, 0, False)):
        q = _rand(g, cuda_device, torch.bfloat16, b, sq, h, hd)
        k = _rand(g, cuda_device, torch.bfloat16, b, skv, kv, hd)
        v = _rand(g, cuda_device, torch.bfloat16, b, skv, kv, hd)
        before = fa.launches
        out = fa.flash_attention(q, k, v, causal=causal, q_offset=off)
        assert fa.launches == before + 1
        assert out.dtype == torch.bfloat16 and out.shape == q.shape
        torch.testing.assert_close(
            out.float(), fa.flash_attention_plain(
                q, k, v, causal=causal, q_offset=off).float(),
            rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_decode_int8_split_edges_match_plain(cuda_device, dtype):
    """kv_len at the edges of the int8 kernel's split of S (8 blocks of
    ceil(len/8) positions rounded up to 64): 0 (all masked), 1, one
    block exactly full (64) and the next taking one row (65), all 8 full
    (512) and the next granule (513), S and past S."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    b, s, h, kv, hd = 12, 1100, 4, 2, 128
    q = _rand(g, cuda_device, dtype, b, 1, h, hd)
    k, ks = _int8_cache(g, cuda_device, b, s, kv, hd)
    v, vs = _int8_cache(g, cuda_device, b, s, kv, hd)
    lens = torch.tensor([0, 1, 63, 64, 65, 511, 512, 513, 1024, 1025, s,
                         s + 900], dtype=torch.int32, device=cuda_device)
    out = da.decode_attention(q, k, v, lens, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(
        out.float(), da.decode_attention_plain(q, k, v, lens, ks,
                                               vs).float(),
        rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,hd", [(4, 2, 128), (8, 1, 64), (8, 8, 32)])
def test_cuda_decode_bf16_split_edges_match_plain(cuda_device, h, kv, hd):
    """kv_len at the edges of the bf16 cache's split of S (the kernel the
    int8 cache takes: 8 blocks of ceil(len/8) positions rounded up to
    64): 0 (all masked), 1, one block exactly full (64) and the next
    taking one row (65), all 8 full (512) and the next granule (513), S
    and past S; group sizes 2, 8 and 1."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    b, s = 12, 1100
    q = _rand(g, cuda_device, torch.bfloat16, b, 1, h, hd)
    k = _rand(g, cuda_device, torch.bfloat16, b, s, kv, hd)
    v = _rand(g, cuda_device, torch.bfloat16, b, s, kv, hd)
    lens = torch.tensor([0, 1, 63, 64, 65, 511, 512, 513, 1024, 1025, s,
                         s + 900], dtype=torch.int32, device=cuda_device)
    before, before_int8 = da.launches, da.launches_int8
    out = da.decode_attention(q, k, v, lens)
    assert (da.launches, da.launches_int8) == (before + 1, before_int8)
    torch.testing.assert_close(
        out.float(), da.decode_attention_plain(q, k, v, lens).float(),
        rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_redesigned_kernels_repeat_bit_for_bit(cuda_device):
    """Two calls on the same inputs give identical bits: the bf16 and
    int8 decode modes merge their splits in a fixed order, flash has no
    cross-block sum, the scan sums each step's lanes in a fixed order."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = _rand(g, cuda_device, torch.bfloat16, 8, 1, 32, 128)
    k, ks = _int8_cache(g, cuda_device, 8, 2048, 32, 128)
    v, vs = _int8_cache(g, cuda_device, 8, 2048, 32, 128)
    lens = torch.tensor([279, 752, 1269, 1684, 1519, 2035, 466, 2100],
                        dtype=torch.int32, device=cuda_device)
    first, second = (da.decode_attention(q, k, v, lens, k_scale=ks,
                                         v_scale=vs) for _ in range(2))
    assert torch.equal(first, second)
    q = _rand(g, cuda_device, torch.bfloat16, 1, 300, 32, 128)
    k = _rand(g, cuda_device, torch.bfloat16, 1, 300, 32, 128)
    v = _rand(g, cuda_device, torch.bfloat16, 1, 300, 32, 128)
    assert torch.equal(fa.flash_attention(q, k, v),
                       fa.flash_attention(q, k, v))
    q = _rand(g, cuda_device, torch.bfloat16, 8, 1, 16, 128)
    k = _rand(g, cuda_device, torch.bfloat16, 8, 1024, 8, 128)
    v = _rand(g, cuda_device, torch.bfloat16, 8, 1024, 8, 128)
    lens = torch.tensor([874, 341, 201, 376, 482, 853, 517, 1100],
                        dtype=torch.int32, device=cuda_device)
    assert torch.equal(da.decode_attention(q, k, v, lens),
                       da.decode_attention(q, k, v, lens))
    args = _scan_inputs(g, cuda_device, 1, 1017, 8192, 16, torch.bfloat16)
    (y1, h1), (y2, h2) = (ms.mamba_scan(*args) for _ in range(2))
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.cuda
def test_cuda_decode_int8_rejects_what_the_kernel_does_not_take(
        cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = _rand(g, cuda_device, torch.bfloat16, 2, 1, 4, 64)
    k, ks = _int8_cache(g, cuda_device, 2, 32, 4, 64)
    lens = torch.tensor([3, 4], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="k_scale"):
        da.decode_attention(q, k, k, lens)          # int8 without scales
    with pytest.raises(TypeError, match="bfloat16"):
        da.decode_attention(q, k, k, lens, k_scale=ks.float(),
                            v_scale=ks.float())
    with pytest.raises(ValueError, match="shapes"):
        da.decode_attention(q, k, k, lens, k_scale=ks[:, :16].contiguous(),
                            v_scale=ks[:, :16].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, k, k, lens, k_scale=ks.transpose(0, 1),
                            v_scale=ks)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((1, 4, 4, 16), device=cuda_device)   # head_dim 16
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 4, 4, 32), device=cuda_device)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), q, q)


def _scan_inputs(g, dev, b, s, di, ds, act_dtype):
    """xc/b/c in ``act_dtype``, f32 dt (softplus-positive), a_log and d
    as the model holds them (f32)."""
    xc = _rand(g, dev, act_dtype, b, s, di)
    dt = (torch.nn.functional.softplus(torch.randn(
        (b, s, di), generator=g, device=dev)) * 0.1).contiguous()
    bm = _rand(g, dev, act_dtype, b, s, ds)
    cm = _rand(g, dev, act_dtype, b, s, ds)
    a_log = torch.log(torch.randn((di, ds), generator=g,
                                  device=dev).abs() + 0.5)
    return xc, dt, bm, cm, a_log, torch.ones(di, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("act_dtype", [torch.float32, torch.bfloat16])
def test_cuda_mamba_scan_matches_plain(cuda_device, act_dtype):
    """S=1, a ragged S and falcon-mamba-7b's width (di=8192, ds=16), plus
    the reduced config's d_state 8 and d_state 4; y within 1e-4 in f32
    (tests/test_kernels.py's bound) and 2e-2 with bf16 xc/b/c, h_final
    within 1e-4 of its scale."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for b, s, di, ds in ((2, 1, 256, 16), (2, 50, 384, 16),
                         (1, 300, 8192, 16), (3, 37, 128, 8),
                         (1, 64, 200, 4)):
        args = _scan_inputs(g, cuda_device, b, s, di, ds, act_dtype)
        before = ms.launches
        y, hf = ms.mamba_scan(*args)
        assert ms.launches == before + 1
        assert y.dtype == act_dtype and hf.dtype == torch.float32
        y_ref, h_ref = ms.mamba_scan_plain(*args)
        tol = 1e-4 if act_dtype == torch.float32 else 2e-2
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol,
                                   atol=tol)
        scale = float(h_ref.abs().max())
        torch.testing.assert_close(hf, h_ref, rtol=1e-4,
                                   atol=1e-4 * max(scale, 1.0))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("act_dtype", [torch.float32, torch.bfloat16])
def test_cuda_mamba_scan_ragged_s_matches_plain(cuda_device, act_dtype):
    """S ragged against the kernel's 64-step chunks (1, 31, 33, 65, 1017)
    at falcon-mamba-7b's width with a random a_log per (channel, state),
    and the element-by-element staging: di=100 (bf16 rows of 200 bytes,
    not 16-byte multiples) with d_state 4 at B=2, S=33 (the second
    sequence's b and c off 16-byte alignment).  Tolerances as in
    test_cuda_mamba_scan_matches_plain."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    for b, s, di, ds in ((1, 1, 8192, 16), (1, 31, 8192, 16),
                         (1, 33, 8192, 16), (1, 65, 8192, 16),
                         (1, 1017, 8192, 16), (2, 33, 100, 4)):
        args = _scan_inputs(g, cuda_device, b, s, di, ds, act_dtype)
        y, hf = ms.mamba_scan(*args)
        y_ref, h_ref = ms.mamba_scan_plain(*args)
        tol = 1e-4 if act_dtype == torch.float32 else 2e-2
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol,
                                   atol=tol)
        scale = float(h_ref.abs().max())
        torch.testing.assert_close(hf, h_ref, rtol=1e-4,
                                   atol=1e-4 * max(scale, 1.0))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_mamba_scan_rejects_what_the_kernel_does_not_take(
        cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    args = _scan_inputs(g, cuda_device, 1, 8, 64, 8, torch.float32)
    xc, dt, bm, cm, a_log, d = args
    with pytest.raises(ValueError, match="on cpu"):
        ms.mamba_scan(xc, dt.cpu(), bm, cm, a_log, d)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ms.mamba_scan(xc.half(), dt, bm, cm, a_log, d)
    with pytest.raises(TypeError, match="a_log must be float32"):
        ms.mamba_scan(xc, dt, bm, cm, a_log.to(torch.bfloat16), d)
    with pytest.raises(ValueError, match="contiguous"):
        ms.mamba_scan(xc.transpose(1, 2).contiguous().transpose(1, 2), dt,
                      bm, cm, a_log, d)
    with pytest.raises(ValueError, match="shapes"):
        ms.mamba_scan(xc, dt[:, :4].contiguous(), bm, cm, a_log, d)
    b32 = _rand(g, cuda_device, torch.float32, 1, 8, 32)
    with pytest.raises(ValueError, match="d_state 32"):
        ms.mamba_scan(xc, dt, b32, b32, a_log.repeat(1, 4).contiguous(), d)


@pytest.mark.cuda
def test_cuda_model_matches_cpu(cuda_device):
    """Reduced qwen3-0.6b (head_dim 32, f32): prefill + 4 decode steps
    (two past the cache) on the card through the kernels, against the
    CPU's plain versions; 1e-3 covers the card's other summation order.
    Reduced falcon-mamba (prefill through the scan kernel) likewise."""
    _model_on_card_vs_cpu(cuda_device, get_config("qwen3-0.6b").reduced(
        head_dim=32))
    before = ms.launches
    cfg = get_config("falcon-mamba-7b").reduced()
    _model_on_card_vs_cpu(cuda_device, cfg)
    assert ms.launches == before + cfg.n_layers


def _model_on_card_vs_cpu(cuda_device, cfg):
    p_cpu = params_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    p_gpu = params_lib.from_reference(
        _numpy_tree(p_cpu), device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 41),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        lc, cc = model_lib.prefill(p_cpu, cfg, toks[:, :37], cache_len=39)
        lg, cg = model_lib.prefill(p_gpu, cfg, toks[:, :37].to(cuda_device),
                                   cache_len=39)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
        for t in range(37, 41):
            lc, cc = model_lib.decode_step(p_cpu, cfg, cc, toks[:, t])
            lg, cg = model_lib.decode_step(p_gpu, cfg, cg,
                                           toks[:, t].to(cuda_device))
            torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()
