"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and nvcc; without a card they skip.  The
file imports nothing of JAX, so it runs where only PyTorch is installed:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
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
    return tree.detach().numpy()


# -- the router's learning path on the card (no kernel of its own) ----------

def _tree_close(got, want, tol, grad=None, lr=0.0):
    """Two parameter trees within ``tol`` of the larger tree's scale.
    With ``grad`` (|g| per leaf) and ``lr``: where a first Adam step saw
    a rounding-level gradient (|g| < 1e-6) its step may be anything in
    [-lr, lr] on either device, so there it is held to that bound."""
    from repro_torch.training.checkpoint import _flatten
    got, want = _flatten(got), _flatten(want)
    assert list(got) == list(want)
    scale = max(float(abs(v).max()) for v in want.values())
    for key in want:
        sure = (grad[key] >= 1e-6) if grad is not None else slice(None)
        torch.testing.assert_close(torch.as_tensor(got[key][sure]),
                                   torch.as_tensor(want[key][sure]),
                                   rtol=tol, atol=tol * scale,
                                   msg=lambda m, k=key: f"{k}: {m}")
        if grad is not None:
            assert float(abs(got[key] - want[key]).max()) <= 2 * lr + tol


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mlp", "decomposed"])
def test_cuda_train_batch_matches_cpu(cuda_device, arch):
    """One double-DQN step at the router's width (4 instances, batch
    512) on the card against the CPU, 1e-5 of each tree's scale."""
    from repro_torch.core import dqn, rl_router as rl
    cfg = rl.RouterConfig(n_instances=4, q_arch=arch)
    cpu = rl.make_agent(cfg, device="cpu")
    card = rl.make_agent(cfg, device=cuda_device)
    card.from_reference(cpu.params.reference_tree())
    d, n_a = cpu.cfg.state_dim, cpu.cfg.n_actions
    g = torch.Generator().manual_seed(0)
    batch = torch.randn((512, 2 * d + 4 + n_a), generator=g)
    batch[:, 2 * d] = torch.randint(0, n_a, (512,), generator=g)
    batch[:, 2 * d + 2] = (torch.rand(512, generator=g) < 0.5).float()
    batch[:, 2 * d + 3:2 * d + 3 + n_a] = (
        torch.rand((512, n_a), generator=g) < 0.7).float()
    batch[:, 2 * d + 2 + n_a] = 1.0
    batch[:, -1] = torch.rand(512, generator=g) + 0.1
    loss_c, td_c = dqn.train_batch(cpu.cfg, cpu.params, cpu.opt,
                                   cpu.target, batch)
    loss_g, td_g = dqn.train_batch(card.cfg, card.params, card.opt,
                                   card.target, batch.to(cuda_device))
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=0)
    torch.testing.assert_close(td_g.cpu(), td_c, rtol=1e-5,
                               atol=1e-5 * float(td_c.abs().max()))
    sc, sg = cpu.state_dict(), card.state_dict()
    from repro_torch.training.checkpoint import _flatten
    grad = {k: abs(v) / 0.1 for k, v in _flatten(sc["opt"]["m"]).items()}
    for key in ("m", "v"):
        _tree_close(sg["opt"][key], sc["opt"][key], 1e-5)
    _tree_close(sg["params"], sc["params"], 1e-5, grad, cpu.cfg.lr)
    assert int(sg["opt"]["step"]) == 1 and \
        sg["opt"]["step"].dtype == torch.int32


@pytest.mark.cuda
def test_cuda_predictor_forward_and_train_step_match_cpu(cuda_device):
    """The length predictor at the reference CLI's width (seq 64, d 64,
    4 heads, 2 layers): logits of 512 prompts and one train step of 128
    on the card against the CPU."""
    import numpy as np

    from repro_torch.core import predictor as pred_lib
    from repro_torch.core import workload as wl
    from repro_torch.core.profiles import V100_LLAMA2_7B
    cfg = pred_lib.PredictorConfig()
    cpu = pred_lib.BucketPredictor(cfg, V100_LLAMA2_7B, device="cpu")
    card = pred_lib.BucketPredictor(cfg, V100_LLAMA2_7B,
                                    device=cuda_device)
    card.params.load_reference(cpu.params.reference_tree())
    samples = wl.generate(512, seed=3)
    lc, lg = cpu.logits(samples), card.logits(samples)
    np.testing.assert_allclose(lg, lc, rtol=1e-5,
                               atol=1e-5 * float(np.abs(lc).max()))
    # cuBLAS picks its kernel by the row count, so the serving path's
    # 16-row windows may round differently from 512-row chunks (the CPU
    # forward is row-independent bit for bit, test_torch_predictor.py)
    l16 = card.logits(samples, chunk=16)
    np.testing.assert_allclose(l16, lg, rtol=1e-5,
                               atol=1e-5 * float(np.abs(lg).max()))
    top2 = np.sort(lg, -1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2e-5 * float(np.abs(lg).max())
    np.testing.assert_array_equal(l16.argmax(-1)[decided],
                                  lg.argmax(-1)[decided])
    tok = torch.from_numpy(np.stack([pred_lib.encode_sample(cfg, s)
                                     for s in samples[:128]])).long()
    lab = torch.tensor([cpu.label(s) for s in samples[:128]])
    loss_c = pred_lib._train_step(cpu.params, cpu.opt, cfg, tok, lab)
    loss_g = pred_lib._train_step(card.params, card.opt, cfg,
                                  tok.to(cuda_device), lab.to(cuda_device))
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=0)
    grad = {k: abs(v.numpy()) / 0.1 for k, v in cpu.opt["m"].items()}
    _tree_close({k: p.detach().cpu().numpy()
                 for k, p in card.params.named_parameters()},
                {k: p.detach().numpy()
                 for k, p in cpu.params.named_parameters()},
                1e-5, grad, cfg.lr)


@pytest.mark.cuda
def test_cuda_agent_checkpoint_round_trip(cuda_device, tmp_path):
    """A card agent's state through the checkpoint file into a second
    card agent and a CPU agent, every leaf bit-equal."""
    import numpy as np

    from repro_torch.core import rl_router as rl
    from repro_torch.training.checkpoint import CheckpointManager, _flatten
    cfg = rl.RouterConfig(n_instances=4, q_arch="decomposed")
    card = rl.make_agent(cfg, device=cuda_device)
    rng = np.random.default_rng(0)
    d = card.cfg.state_dim
    for _ in range(600):
        card.observe(rng.standard_normal(d), int(rng.integers(0, 5)),
                     float(rng.normal()), rng.standard_normal(d), 1.0,
                     np.ones(5, bool))
    assert card.learn() is not None
    mgr = CheckpointManager(str(tmp_path))
    try:
        mgr.save(1, card.state_dict(), sync=True)
        for dev in (cuda_device, "cpu"):
            other = rl.make_agent(cfg, device=dev)
            other.load_state_dict(mgr.restore(other.state_dict())[0])
            for key, val in _flatten(other.state_dict()).items():
                assert np.array_equal(val, _flatten(card.state_dict())[key])
    finally:
        mgr.close()


@pytest.mark.cuda
def test_cuda_batched_training_on_vec_matches_cpu(cuda_device):
    """Two batched episodes on the ``vec`` simulator with the agent on
    the card (4 instances, 8 environments' width of the reference bench,
    a 256-row learn batch): at every round's act the card's Q-values
    match the same network on the CPU within 1e-5 of their scale, and
    the CPU picks the same actions wherever the selection margin is
    above 1e-4."""
    import numpy as np

    from repro_torch.core import batched_rl, dqn, rl_router as rl
    from repro_torch.core import workload as wl
    from repro_torch.core.profiles import V100_LLAMA2_7B
    cfg = rl.RouterConfig(variant="guided", n_instances=4,
                          explore_episodes=1, q_arch="decomposed", seed=0)
    card = rl.make_agent(cfg, device=cuda_device)
    cpu = dqn.DQNAgent(card.cfg, device="cpu")
    checked = []
    act_batch = card.act_batch

    def checked_act(states, masks, epsilon=None, prior=None, q_squash=0.0):
        acts = act_batch(states, masks, epsilon=epsilon, prior=prior,
                         q_squash=q_squash)
        cpu.params.load_reference(card.params.reference_tree())
        q_card = dqn.q_values(card.params, states)
        q_cpu = dqn.q_values(cpu.params, states)
        scale = max(float(np.abs(q_cpu).max()), 1.0)
        assert float(np.abs(q_card - q_cpu).max()) <= 1e-5 * scale
        q = q_cpu.astype(np.float64)
        if q_squash > 0:
            ref = np.max(np.where(masks, q, -np.inf), axis=1)
            q = q_squash * np.tanh(q - np.where(np.isfinite(ref), ref,
                                                0.0)[:, None])
        if prior is not None:
            q = q + prior
        q[~masks] = -np.inf
        top2 = np.sort(q, axis=1)[:, -2:]
        with np.errstate(invalid="ignore"):     # all-masked padding rows
            sure = masks.any(1) & ((top2[:, 1] - top2[:, 0]) > 1e-4)
        assert np.array_equal(np.argmax(q, 1)[sure], acts[sure])
        checked.append(int(sure.sum()))
        return acts
    card.act_batch = checked_act

    def scenario(ep):
        return wl.Scenario.homogeneous(
            V100_LLAMA2_7B, 4, wl.to_requests(wl.generate(200, seed=ep),
                                              rate=20.0, seed=ep + 5000))
    out = batched_rl.train_batched(
        cfg, scenario, 2, bcfg=batched_rl.BatchedRLConfig(
            n_envs=2, m_max=4, backend="vec"), agent=card)
    assert [h["n"] for h in out["history"]] == [200, 200]
    assert card.steps > 0 and sum(checked) > 100


@pytest.mark.cuda
def test_cuda_online_publish_is_a_snapshot(cuda_device):
    """On the card too, learn steps after a publish leave the served
    network unchanged; the next publish makes it equal the learner's."""
    import numpy as np

    from repro_torch.core import rl_router as rl
    from repro_torch.training.online import OnlineConfig, OnlineTrainer
    cfg = rl.RouterConfig(variant="guided", n_instances=4,
                          q_arch="decomposed", seed=0,
                          include_health_features=True)
    tr = OnlineTrainer(cfg, OnlineConfig(), device=cuda_device)
    agent = tr.agent
    assert tr.serve_agent.device == agent.device
    rng = np.random.default_rng(0)
    d, n_a = agent.cfg.state_dim, agent.cfg.n_actions
    for _ in range(agent.cfg.batch_size + 10):
        agent.observe(rng.standard_normal(d), int(rng.integers(0, n_a)),
                      float(rng.normal()), rng.standard_normal(d), 1.0,
                      np.ones(n_a, bool))
    served = tr.policy.agent
    before = [p.detach().clone() for p in served.params.parameters()]
    for _ in range(3):
        agent.learn(sync=False)
    torch.cuda.synchronize()
    for a, b in zip(before, served.params.parameters()):
        assert torch.equal(a, b) and b.device.type == "cuda"
    assert any(not torch.equal(a, b) for a, b in
               zip(before, agent.params.parameters()))
    tr._publish()
    for a, b in zip(served.params.parameters(), agent.params.parameters()):
        assert torch.equal(a, b)


# -- the simulator<->engine loop on the card ---------------------------------

@pytest.mark.cuda
def test_cuda_calibration_of_reduced_qwen3(cuda_device):
    """The sweeps on the card (the kernels launched once a layer a
    prefill and a decode step), the grids as x values, and a sane fit.
    The 2-layer model's decode step is host-bound: its host time is flat
    in the batch and jitters by about a millisecond between calls
    (chip_smoke.py phase 8e), so its fitted slope is that jitter over the
    grid's span of resident tokens; the grid spans 512 to 32768 of them
    to keep that slope small.  The prompts run to 16384 tokens, where the
    f32 flash kernel's quadratic device time outgrows the host's dispatch
    time, so the prefill slope is the card's and not host noise (the
    kernel takes head_dim 32, 64 or 128)."""
    from repro_torch.core import calibrate as cal
    cfg = get_config("qwen3-0.6b").reduced(head_dim=32)
    params = params_lib.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device)
    ccfg = cal.CalibrationConfig(
        prompt_grid=(2048, 4096, 8192, 12288, 16384),
        decode_grid=((1, 512), (2, 1024), (4, 2048), (8, 4096)),
        decode_steps_per_call=4, repeats=5, warmup=2,
        prefill_cache_len=16384)
    fa0, da0 = fa.launches, da.launches
    res = cal.calibrate(cfg, params, ccfg)
    calls = ccfg.warmup + ccfg.repeats
    assert fa.launches - fa0 == cfg.n_layers * 5 * calls
    assert da.launches - da0 == cfg.n_layers * 4 * calls * 4
    assert [x for x, _ in res.prefill_samples] == [2048, 4096, 8192,
                                                   12288, 16384]
    assert [x for x, _ in res.decode_samples] == [512, 2048, 8192, 32768]
    assert all(t > 0 for _, t in res.prefill_samples + res.decode_samples)
    assert res.ok, cal.format_result(res)


@pytest.mark.cuda
@pytest.mark.parametrize("saturate", [False, True])
def test_cuda_fidelity_engine_leg_equals_cpu(cuda_device, saturate):
    """The reduced engine leg on the card gives the report the same leg
    gives on the CPU: every clock is virtual (head_dim 32: the flash
    kernel's smallest)."""
    from repro_torch.core.profiles import V100_LLAMA2_7B
    from repro_torch.serving import fidelity as fid
    cfg = get_config("qwen3-0.6b").reduced(head_dim=32)
    p_cpu = params_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    p_gpu = params_lib.from_reference(_numpy_tree(p_cpu), device=cuda_device)
    fcfg = fid.FidelityConfig(
        backends=("py", "engine"), n_requests=12, n_instances=1, n_slots=2,
        cache_len=64, capacity_tokens=80 if saturate else 200,
        prompt_lengths=(16, 32), decode_range=(4, 12), rate=6.0,
        saturate=saturate)
    card = fid.run_fidelity(V100_LLAMA2_7B, fcfg, model_cfg=cfg,
                            params=p_gpu)
    assert card == fid.run_fidelity(V100_LLAMA2_7B, fcfg, model_cfg=cfg,
                                    params=p_cpu)
    assert card["backends"]["engine"]["completed"] == 12
    if saturate:
        assert card["deltas"]["engine_vs_py"]["preemptions"]["both_preempt"]


@pytest.mark.cuda
def test_cuda_kernels_at_musicgen_heads_match_plain(cuda_device):
    """musicgen-medium's heads (MHA, H=KV=24, hd=64): bf16 flash across
    the 64-row q tiles' edges and the bf16 decode mode across its split's
    edges, each against its plain version at 2e-2."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    for sq in (1, 63, 65, 300, 1500):
        q, k, v = (_rand(g, cuda_device, torch.bfloat16, 1, sq, 24, 64)
                   for _ in range(3))
        torch.testing.assert_close(
            fa.flash_attention(q, k, v).float(),
            fa.flash_attention_plain(q, k, v).float(), rtol=2e-2,
            atol=2e-2)
    b, s = 8, 2048
    q = _rand(g, cuda_device, torch.bfloat16, b, 1, 24, 64)
    k, v = (_rand(g, cuda_device, torch.bfloat16, b, s, 24, 64)
            for _ in range(2))
    lens = torch.tensor([0, 1, 64, 65, 513, 1500, s, s + 3],
                        dtype=torch.int32, device=cuda_device)
    torch.testing.assert_close(
        da.decode_attention(q, k, v, lens).float(),
        da.decode_attention_plain(q, k, v, lens).float(), rtol=2e-2,
        atol=2e-2)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("t", [8, 512])
def test_cuda_moe_implementations_agree_at_deepseek_width(cuda_device, t):
    """deepseek-moe-16b's MoE layer at full width (64 experts of 1408,
    top-6, 2 shared; bf16, seeded): ``gather``, ``ragged`` and ``dense``
    route the same rows the same way, so their outputs agree within
    2e-2 of the largest output."""
    from repro_torch.models import moe
    cfg = get_config("deepseek-moe-16b")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = params_lib._init_moe(gen, cfg, (), torch.bfloat16, cuda_device, 1)
    x = _rand(gen, cuda_device, torch.bfloat16, t, cfg.d_model)
    outs = {name: fn(p, cfg, x) for name, fn in moe.IMPLS.items()}
    ref = outs["dense"][0].float()
    scale = float(ref.abs().max())
    assert scale > 0 and bool(torch.isfinite(ref).all())
    for name, (y, aux) in outs.items():
        assert y.shape == (t, cfg.d_model) and y.dtype == torch.bfloat16
        assert float((y.float() - ref).abs().max()) <= 2e-2 * scale, name
        assert abs(float(aux) - float(outs["dense"][1])) < 1e-5


def _skewed_sizes(rng, pairs, n_experts):
    """Group sizes of ``pairs`` pairs over ``n_experts``: a quarter of the
    experts (the first among them) empty, the rest drawn with weights
    falling as 1 / rank, so a few groups are large and most are small."""
    w = 1.0 / np.arange(1, n_experts + 1) ** 1.2
    w[rng.permutation(n_experts)[:n_experts // 4]] = 0.0
    w[0] = 0.0
    return rng.multinomial(pairs, w / w.sum()).tolist()


def _grouped_inputs(gen, dev, sizes, d):
    x = _rand(gen, dev, torch.bfloat16, sum(sizes), d)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                           dtype=torch.int32, device=dev)
    return x, offsets


def _max_rel(got, want):
    return float((got.float() - want.float()).abs().max()) / float(
        want.float().abs().max())


def _loop(p, cfg, x_sorted, sizes):
    """The per-group loop the grouped kernels replaced: one matmul chain
    a non-empty group, in the rows' dtype."""
    from repro_torch.models import moe
    outs, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            outs.append(moe._expert_ffn(p, cfg, e, x_sorted[start:start + n]))
            start += n
    return torch.cat(outs) if outs else x_sorted[:0]


@pytest.fixture(scope="module")
def deepseek_routed():
    """deepseek-moe-16b's routed experts at full width (64 of 1408, bf16,
    seeded), built once for the module's grouped-kernel tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    cfg = get_config("deepseek-moe-16b")
    gen = torch.Generator(device="cuda").manual_seed(5)
    p = params_lib._init_moe(gen, cfg, (), torch.bfloat16,
                             torch.device("cuda"), 1)
    return cfg, p


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [9, 512, 16128])
def test_cuda_grouped_ffn_matches_the_loop(cuda_device, deepseek_routed,
                                           pairs):
    """The grouped kernel at deepseek-moe-16b's widths against the loop
    it replaces (one bf16 matmul chain a group) and its plain version,
    over skewed groups with empty experts (the first among them), to 2e-2
    of the largest output; two launches a call."""
    from repro_torch.kernels.grouped_ffn import ops as gf
    cfg, p = deepseek_routed
    r = p["routed"]
    sizes = _skewed_sizes(np.random.default_rng(pairs), pairs, 64)
    gen = torch.Generator(device=cuda_device).manual_seed(pairs)
    x, offsets = _grouped_inputs(gen, cuda_device, sizes, cfg.d_model)
    before = gf.launches
    with torch.no_grad():
        y = gf.grouped_ffn(x, offsets, r["w_up"], r["w_gate"], r["w_down"],
                           "silu")
        loop = _loop(r, cfg, x, sizes)
        plain = gf.grouped_ffn_plain(x, offsets, r["w_up"], r["w_gate"],
                                     r["w_down"], "silu")
    torch.cuda.synchronize()
    assert gf.launches == before + 2
    assert y.shape == (pairs, cfg.d_model) and y.dtype == torch.bfloat16
    assert bool(torch.isfinite(y).all())
    assert _max_rel(y, loop) <= 2e-2
    assert _max_rel(y, plain) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("expert", [0, 37, 63])
def test_cuda_grouped_ffn_every_pair_on_one_expert(cuda_device,
                                                   deepseek_routed, expert):
    """512 pairs all on one expert (the first, a middle one, the last):
    four full row tiles of one group, every other group empty."""
    from repro_torch.kernels.grouped_ffn import ops as gf
    cfg, p = deepseek_routed
    r = p["routed"]
    sizes = [0] * 64
    sizes[expert] = 512
    gen = torch.Generator(device=cuda_device).manual_seed(expert)
    x, offsets = _grouped_inputs(gen, cuda_device, sizes, cfg.d_model)
    with torch.no_grad():
        y = gf.grouped_ffn(x, offsets, r["w_up"], r["w_gate"], r["w_down"],
                           "silu")
        loop = _loop(r, cfg, x, sizes)
    torch.cuda.synchronize()
    assert _max_rel(y, loop) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False), ("relu", False)])
def test_cuda_grouped_ffn_modes_and_edges(cuda_device, act, gated):
    """Each activation, gated and not, at widths that are multiples of 64
    but not of the kernel's 128- and 256-column tiles (d 320, f 192), over
    groups that are not multiples of its 128-row tile, with empty ones
    (the first and the last): against the plain version to 2e-2."""
    from repro_torch.kernels.grouped_ffn import ops as gf
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    e, d, f = 6, 320, 192
    sizes = [0, 130, 1, 127, 300, 0]
    w_up = _rand(gen, cuda_device, torch.bfloat16, e, d, f) / d ** 0.5
    w_gate = (_rand(gen, cuda_device, torch.bfloat16, e, d, f) / d ** 0.5
              if gated else None)
    w_down = _rand(gen, cuda_device, torch.bfloat16, e, f, d) / f ** 0.5
    x, offsets = _grouped_inputs(gen, cuda_device, sizes, d)
    y = gf.grouped_ffn(x, offsets, w_up, w_gate, w_down, act)
    want = gf.grouped_ffn_plain(x, offsets, w_up, w_gate, w_down, act)
    torch.cuda.synchronize()
    assert _max_rel(y, want) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "grok-1-314b"])
def test_cuda_grouped_ffn_at_the_other_moe_widths(cuda_device, arch):
    """The two other MoE models that serve through ``ragged``: jamba's
    16 experts (d 4096, f 14336, gated SiLU) and grok's 8 (d 6144, f
    32768, gated GELU), bf16 on the warpgroup kernel, 300 pairs with an
    empty expert and groups off the 128-row tile, against the plain
    version and the loop to 2e-2 of the largest output."""
    from repro_torch.kernels.grouped_ffn import ops as gf
    cfg = get_config(arch)
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    gen = torch.Generator(device=cuda_device).manual_seed(e)
    w = {"w_up": _rand(gen, cuda_device, torch.bfloat16, e, d, f) / d ** 0.5,
         "w_gate": _rand(gen, cuda_device, torch.bfloat16, e, d, f)
         / d ** 0.5,
         "w_down": _rand(gen, cuda_device, torch.bfloat16, e, f, d)
         / f ** 0.5}
    sizes = [0] + [300 // (e - 1)] * (e - 2)
    sizes.append(300 - sum(sizes))
    x, offsets = _grouped_inputs(gen, cuda_device, sizes, d)
    with torch.no_grad():
        y = gf.grouped_ffn(x, offsets, w["w_up"], w["w_gate"], w["w_down"],
                           cfg.activation)
        plain = gf.grouped_ffn_plain(x, offsets, w["w_up"], w["w_gate"],
                                     w["w_down"], cfg.activation)
        loop = _loop(w, cfg, x, sizes)
    torch.cuda.synchronize()
    assert _max_rel(y, plain) <= 2e-2
    assert _max_rel(y, loop) <= 2e-2


def _expert_stores(gen, dev, dtype, e, d, f, gated, spread=1, cut=1):
    """Seeded stores of ``e * spread`` experts of width ``f * cut``; the
    calls read every ``spread``-th expert (replicated storage's
    ``w[::R]``) and its first ``f`` (a tensor-parallel block of f)."""
    w = {"w_up": _rand(gen, dev, dtype, e * spread, d, f * cut) / d ** 0.5,
         "w_down": _rand(gen, dev, dtype, e * spread, f * cut, d)
         / f ** 0.5}
    if gated:
        w["w_gate"] = (_rand(gen, dev, dtype, e * spread, d, f * cut)
                       / d ** 0.5)
    return w


def _views(stores, spread, f=None):
    return {k: v[::spread, :f] if k == "w_down" else v[::spread, :, :f]
            for k, v in stores.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,f,spread,cut", [
    (torch.float32, 64, 32, 1, 1),     # the reduced configs' f32: CUDA cores
    (torch.float32, 72, 40, 2, 2),
    (torch.bfloat16, 72, 40, 1, 1),    # bf16 off the 64-column blocks
    (torch.bfloat16, 320, 192, 2, 1),  # replicated storage, warpgroups
    (torch.bfloat16, 320, 192, 1, 2)])  # a TP block of f, warpgroups
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False)])
def test_cuda_grouped_ffn_f32_odd_widths_and_strided_experts(
        cuda_device, dtype, d, f, spread, cut, act, gated):
    """Every call the card takes goes to a kernel: f32 and bf16 at widths
    that are not multiples of 64 on the CUDA cores, and strided experts
    (every second of a store, the first half of each expert's f) on
    either, against the plain version on the same tensors: 1e-5 of the
    largest output in f32, 2e-2 in bf16."""
    from repro_torch.kernels.grouped_ffn import ops as gf
    gen = torch.Generator(device=cuda_device).manual_seed(d + f)
    sizes = [0, 70, 1, 63, 130, 0]
    w = _views(_expert_stores(gen, cuda_device, dtype, len(sizes), d, f,
                              gated, spread, cut), spread, f)
    assert (spread == cut == 1) == w["w_up"].is_contiguous()
    x = _rand(gen, cuda_device, dtype, sum(sizes), d)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                           dtype=torch.int32, device=cuda_device)
    before = gf.launches
    with torch.no_grad():
        y = gf.grouped_ffn(x, offsets, w["w_up"], w.get("w_gate"),
                           w["w_down"], act)
        want = gf.grouped_ffn_plain(x, offsets, w["w_up"], w.get("w_gate"),
                                    w["w_down"], act)
    torch.cuda.synchronize()
    assert gf.launches == before + 2
    assert _max_rel(y, want) <= (1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,f", [(torch.float32, 64, 32),
                                       (torch.float32, 72, 40),
                                       (torch.bfloat16, 256, 192)])
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("relu", False)])
def test_cuda_grouped_ffn_bwd_matches_plain(cuda_device, dtype, d, f, act,
                                            gated):
    """The hand-written backward (under autograd, through
    ``GroupedFFNFn``) against autograd of the plain version on the same
    card tensors, with empty experts and strided (replicated) weights:
    every gradient within 1e-4 (f32) or 2e-2 (bf16) of its largest |g|,
    zero for the experts no pair reaches; one backward launch."""
    from repro_torch.kernels.grouped_ffn import ops as gf
    gen = torch.Generator(device=cuda_device).manual_seed(d * 3 + f)
    sizes = [0, 70, 1, 63, 130, 0]
    stores = _expert_stores(gen, cuda_device, dtype, len(sizes), d, f,
                            gated, 2)
    x = _rand(gen, cuda_device, dtype, sum(sizes), d)
    dy = _rand(gen, cuda_device, dtype, sum(sizes), d)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                           dtype=torch.int32, device=cuda_device)

    def grads(fn):
        leaves = {"x": x.clone().requires_grad_()}
        leaves.update({k: v.clone().requires_grad_()
                       for k, v in stores.items()})
        w = _views({k: v for k, v in leaves.items() if k != "x"}, 2)
        fn(leaves["x"], offsets, w["w_up"], w.get("w_gate"), w["w_down"],
           act).backward(dy)
        return {k: v.grad for k, v in leaves.items()}
    before = gf.launches_bwd
    got = grads(gf.grouped_ffn)
    want = grads(gf.grouped_ffn_plain)
    torch.cuda.synchronize()
    assert gf.launches_bwd == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for k, g in want.items():
        assert got[k].shape == g.shape and got[k].dtype == g.dtype, k
        assert _max_rel(got[k], g) <= tol, (k, _max_rel(got[k], g))
    # the experts no pair reaches, and the store's unread copies
    idle = [i for i in range(2 * len(sizes)) if i % 2 or sizes[i // 2] == 0]
    assert not got["w_up"][idle].any() and not got["w_down"][idle].any()


@pytest.mark.cuda
def test_cuda_moe_ragged_reads_nothing_to_the_host(cuda_device,
                                                   deepseek_routed):
    """``moe_ragged`` at deepseek-moe-16b's width on 512 tokens runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so no operation of the
    call copies to the host or waits for the card; its experts take two
    grouped launches, and it agrees with ``moe_dense``."""
    from repro_torch.kernels.grouped_ffn import ops as gf
    from repro_torch.models import moe
    cfg, p = deepseek_routed
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = _rand(gen, cuda_device, torch.bfloat16, 512, cfg.d_model)
    with torch.no_grad():
        moe.moe_ragged(p, cfg, x)           # builds and warms up
        torch.cuda.synchronize()
        before = gf.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, _ = moe.moe_ragged(p, cfg, x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        dense, _ = moe.moe_dense(p, cfg, x)
    assert gf.launches == before + 2
    assert _max_rel(y, dense) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "minicpm3-4b",
                                  "jamba-v0.1-52b", "llama-3.2-vision-11b",
                                  "musicgen-medium"])
def test_cuda_new_families_match_cpu(cuda_device, arch):
    """Reduced models of the families added last (head_dim 32 where a
    kernel runs, cross gates 0.5 / -0.3, seeded vision and frame
    inputs): prefill + 4 decode steps on the card against the CPU, within
    1e-3 (``chip_smoke.py`` phase 4's tolerance)."""
    cfg = get_config(arch).reduced(head_dim=32)
    p_cpu = params_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    for layer in p_cpu["layers"]:
        if "gate_attn" in layer:
            layer["gate_attn"].fill_(0.5)
            layer["gate_ffn"].fill_(-0.3)
    p_gpu = params_lib.from_reference(_numpy_tree(p_cpu), device="cuda")
    g = torch.Generator().manual_seed(1)
    kw = {}
    if cfg.input_mode == "tokens":
        seq = torch.randint(0, cfg.vocab_size, (2, 41), generator=g)
    else:
        seq = torch.randn((2, 41, cfg.d_model), generator=g)
    if cfg.vision_tokens:
        kw["vision"] = torch.randn((2, cfg.vision_tokens, cfg.vision_dim),
                                   generator=g)

    def step_kw(t):
        x = seq[:, t] if cfg.input_mode == "tokens" else seq[:, t:t + 1]
        return {"tokens" if cfg.input_mode == "tokens" else "embeds": x}
    first = {"tokens" if cfg.input_mode == "tokens" else "embeds":
             seq[:, :37]}
    with torch.no_grad():
        lc, cc = model_lib.prefill(p_cpu, cfg, cache_len=39, **first, **kw)
        lg, cg = model_lib.prefill(
            p_gpu, cfg, cache_len=39,
            **{k: v.cuda() for k, v in dict(first, **kw).items()})
        pairs = [(lc, lg)]
        for t in range(37, 41):
            lc, cc = model_lib.decode_step(p_cpu, cfg, cc, **step_kw(t))
            lg, cg = model_lib.decode_step(
                p_gpu, cfg, cg, **{k: v.cuda()
                                   for k, v in step_kw(t).items()})
            pairs.append((lc, lg))
    for c, gpu in pairs:
        assert bool(torch.isfinite(gpu).all())
        torch.testing.assert_close(gpu.cpu(), c, rtol=1e-3, atol=1e-3)



# -- training: the hand-written backwards and the train step -------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,kv,hd", [
    (2, 130, 16, 8, 128), (1, 63, 24, 24, 64), (2, 65, 4, 2, 32),
    (1, 1, 4, 4, 32),
    # S across the 64-row wgmma tiles and 128-row blocks, G = H / KV of 1,
    # 2 and 4 at each head dimension
    (1, 64, 8, 4, 128), (1, 127, 8, 2, 128), (1, 128, 4, 4, 128),
    (1, 129, 16, 4, 128), (1, 1000, 16, 8, 128), (1, 65, 8, 8, 64),
    (1, 129, 8, 2, 64), (1, 64, 8, 2, 64), (1, 127, 4, 1, 32),
    (1, 128, 4, 4, 32), (1, 63, 8, 4, 32)])
def test_cuda_flash_attention_bwd_matches_plain(cuda_device, dtype, b, s, h,
                                                kv, hd):
    """The training forward (o and lse) and the backward against their
    plain versions; dq/dk/dv within 2e-2 (bf16) or 1e-4 (f32) of the
    largest |grad| of the three (dq and dk are exactly zero at S=1); a
    second launch bit-equal."""
    g = torch.Generator(device=cuda_device).manual_seed(s)
    q, do = (_rand(g, cuda_device, dtype, b, s, h, hd) for _ in range(2))
    k, v = (_rand(g, cuda_device, dtype, b, s, kv, hd) for _ in range(2))
    o, lse = fa.flash_attention_train_fwd(q, k, v)
    o_p, lse_p = fa.flash_attention_lse_plain(q, k, v)
    torch.testing.assert_close(o.float(), o_p.float(), rtol=TOLS[dtype],
                               atol=TOLS[dtype])
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse_p, do)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    top = max(float(w.float().abs().max()) for w in want)
    for x, w in zip(got, want):
        assert float((x.float() - w.float()).abs().max()) <= tol * top
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


_BF, _F32 = torch.bfloat16, torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(_F32,) * 4, (_BF, _F32, _BF, _BF),
                                    (_BF, _BF, _F32, _BF),
                                    (_F32, _BF, _BF, _F32)])
@pytest.mark.parametrize("s", [1, 4, 15, 16, 17, 31, 32, 33, 64, 200])
@pytest.mark.parametrize("di,ds", [(300, 16), (257, 4), (65, 8)])
def test_cuda_mamba_scan_bwd_matches_plain(cuda_device, dtypes, s, di, ds):
    """The scan backward against its plain version: S across the kernel's
    4-step groups, 16-step saved states and 32-step chunks; di off its
    blocks' 32 (64 at ds 4) channels and its clusters' 256; xc, dt, b, c
    each bf16 or f32; a second launch bit-equal."""
    g = torch.Generator(device=cuda_device).manual_seed(s)
    args = _scan_inputs(g, cuda_device, 2, s, di, ds, _F32)
    xc, dt, b, c = (t.to(dt_) for t, dt_ in zip(args[:4], dtypes))
    a_log, d = args[4:]
    act_dtype = _BF if _BF in dtypes else _F32
    dy = _rand(g, cuda_device, xc.dtype, 2, s, di)
    dh = _rand(g, cuda_device, torch.float32, 2, di, ds)
    y, hf, hc = ms.mamba_scan_train_fwd(xc, dt, b, c, a_log, d)
    y_s, hf_s = ms.mamba_scan(xc, dt, b, c, a_log, d)
    assert torch.equal(y, y_s) and torch.equal(hf, hf_s)
    got = ms.mamba_scan_bwd(xc, dt, b, c, a_log, d, hc, dy, dh)
    want = ms.mamba_scan_bwd_plain(xc, dt, b, c, a_log, d, dy, dh)
    tol = 2e-2 if act_dtype == torch.bfloat16 else 1e-4
    for x, w in zip(got, want):
        assert x.dtype == w.dtype and x.shape == w.shape
        assert float((x.float() - w.float()).abs().max()) <= \
            tol * float(w.float().abs().max())
    again = ms.mamba_scan_bwd(xc, dt, b, c, a_log, d, hc, dy, dh)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_cuda_flash_grads_only_for_training(cuda_device):
    """A grad is taken only for causal attention with q_offset 0 and
    Sq == Skv; anything else raises (no fallback to the plain version)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = _rand(g, cuda_device, torch.bfloat16, 1, 8, 4, 32)
    k = _rand(g, cuda_device, torch.bfloat16, 1, 12, 4, 32)
    q.requires_grad_()
    with pytest.raises(ValueError, match="gradients"):
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="gradients"):
        fa.flash_attention(q, q, q, causal=False)
    with torch.no_grad():
        fa.flash_attention(q, k, k, q_offset=4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b",
                                  "deepseek-moe-16b", "minicpm3-4b"])
def test_cuda_train_step_matches_cpu(cuda_device, arch):
    """One f32 loss and backward of a reduced model (head_dim 32) on the
    card through the backward kernels, against the CPU's autograd of the
    plain versions: loss within 1e-5, every grad leaf within 1e-4 of its
    largest |g|."""
    from repro_torch.models.params import leaves
    from repro_torch.training.train_loop import init_train_state
    cfg = get_config(arch).reduced(head_dim=32)
    p_cpu, _ = init_train_state(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    p_gpu = params_lib.from_reference(_numpy_tree(p_cpu), device="cuda")
    for p in leaves(p_gpu):
        p.requires_grad_()
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 48),
                                     generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (2, 48),
                                     generator=g)}
    losses = []
    from repro_torch.kernels.grouped_ffn import ops as gf
    for params, dev in ((p_cpu, "cpu"), (p_gpu, "cuda")):
        fa.launches_bwd = ms.launches_bwd = gf.launches_bwd = 0
        loss, _ = model_lib.loss_fn(params, cfg, {k: v.to(dev) for k, v
                                                  in batch.items()})
        loss.backward()
        losses.append(float(loss.detach()))
    assert fa.launches_bwd + ms.launches_bwd > 0 or arch == "minicpm3-4b"
    # the MoE layers' experts train through the grouped backward
    assert (gf.launches_bwd > 0) == (arch == "deepseek-moe-16b")
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0])
    for pc, pg in zip(leaves(p_cpu), leaves(p_gpu)):
        scale = float(pc.grad.abs().max())
        assert float((pg.grad.cpu() - pc.grad).abs().max()) <= 1e-4 * scale


# -- the device-resident simulator on the card --------------------------------

def _sim_pool_run(monkeypatch, backend, n_eps=32, capture=()):
    """benchmarks/bench_jaxsim.py's drive over a pool of ``n_eps``
    episodes x 4 lanes (30 requests each); with ``capture``, copies of
    the staged blocks of those call numbers, taken before their launch."""
    from _torch_jaxsim_support import drive_pooled, reqs, stamps
    from repro_torch.core.jaxsim import JaxSimPool
    from repro_torch.core.vecsim import VecSimPool
    from repro_torch.kernels.sim_rounds import ops as sim_ops
    caps, real, calls = [], sim_ops.sim_rounds, [0]

    def launch(layout, fb, ib):
        if calls[0] in capture:
            caps.append((layout, fb[:layout.n_f].clone(),
                         ib[:layout.n_i].clone()))
        calls[0] += 1
        real(layout, fb, ib)
    monkeypatch.setattr(sim_ops, "sim_rounds", launch)
    pool = (VecSimPool(n_eps) if backend == "vec"
            else JaxSimPool(n_eps, min_span_ticks=0))
    streams = [reqs(30, seed=900 + e) for e in range(n_eps)]
    drive_pooled(pool, streams, m=4)
    return [stamps(rs) for rs in streams], pool, caps


@pytest.mark.cuda
def test_cuda_sim_rounds_matches_plain_on_a_pools_calls(cuda_device,
                                                         monkeypatch):
    """The round-loop kernel against its plain version on the card, on
    staged calls of a 32-episode pool: every decision, clock and time
    bit-equal, the backlog sums and span buckets within 1e-9 of their
    scale (a summation order), and a second launch bit-equal."""
    from repro_torch.kernels.sim_rounds import ops as sim_ops
    sim_ops.launches = 0
    _, pool, caps = _sim_pool_run(monkeypatch, "jax",
                                  capture=(0, 3, 10, 30, 60))
    monkeypatch.undo()
    assert sim_ops.launches == pool.n_jax_calls > 30 and len(caps) >= 4
    for layout, fb, ib in caps:
        runs = []
        for plain in (False, False, True):
            f, i = fb.clone(), ib.clone()
            (sim_ops.sim_rounds_plain if plain else sim_ops.sim_rounds)(
                layout, f, i)
            runs.append(layout.carry_out(f, i))
        torch.cuda.synchronize()
        k1, k2, want = runs
        for name, w in want.items():
            if name in ("bk_s", "bk_t", "d_lane", "lane_ivv"):
                scale = float(w.abs().max())
                assert float((k1[name] - w).abs().max()) <= 1e-9 * max(
                    scale, 1e-300), name
            elif w.dtype == torch.float64:
                assert torch.equal(k1[name].view(torch.int64),
                                   w.view(torch.int64)), name
            else:
                assert torch.equal(k1[name], w), name
            bits = (lambda t: t.view(torch.int64)
                    if t.dtype == torch.float64 else t)
            assert torch.equal(bits(k1[name]), bits(k2[name])), name
        assert int(want["round_no"]) > 0


@pytest.mark.cuda
def test_cuda_jax_pool_matches_vec(cuda_device, monkeypatch):
    """The pool on the card (every call through the kernel) serves the
    same 32 episodes as the numpy pool, request by request."""
    want, _, _ = _sim_pool_run(monkeypatch, "vec")
    got, pool, _ = _sim_pool_run(monkeypatch, "jax")
    assert pool.n_jax_calls > 0 and pool.n_numpy_calls == 0
    assert got == want
