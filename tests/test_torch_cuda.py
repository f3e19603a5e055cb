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


@pytest.mark.cuda
def test_cuda_model_matches_cpu(cuda_device):
    """Reduced qwen3-0.6b (head_dim 32, f32): prefill + 4 decode steps
    (two past the cache) on the card through the kernels, against the
    CPU's plain versions; 1e-3 covers the card's other summation order."""
    cfg = get_config("qwen3-0.6b").reduced(head_dim=32)
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
