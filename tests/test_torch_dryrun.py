"""The dry-run's pieces that need no reference: each kernel's ``cost``
against ``chip_smoke.py``'s Bound column (PERF.md §6), the wrappers'
``meta`` branches against their plain versions' shapes and dtypes (and
every other device still refused), ``moe_ep``'s all-to-all bytes as the
meta program counts them against a 4-rank gloo run's, the spec helpers,
and the CLI on one full-width cell with nothing allocated off ``meta``."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.common.config import ShapeConfig
from repro_torch.configs import get_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import context as dist_ctx
from repro_torch.distributed import sharding
from repro_torch.kernels import meta as kmeta
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.grouped_ffn import ops as gf
from repro_torch.kernels.mamba_scan import ops as ms
from repro_torch.launch import dryrun
from repro_torch.models import moe
from repro_torch.models.params import init_params

from _torch_dist_support import REPO, run_ranks

# chip_smoke.py's rates (H100 SXM datasheet) for the Bound column
PEAK_BF16, PEAK_F32, HBM = 989e12, 67e12, 3.35e12
SFU_RATE = 16 * 132 * 1.98e9


def _bound_ms(c, peak=PEAK_BF16):
    return max(c.flops / peak, c.bytes / HBM, c.exps / SFU_RATE) * 1e3


def _lens():
    """Phase 3's kv_len draws (``chip_smoke.py`` main, seed 2)."""
    rng = np.random.default_rng(2)
    lens = [int(x) for x in rng.integers(100, 1025, 7)] + [1100]
    return lens, [int(x) for x in rng.integers(100, 2049, 7)] + [2100]


# (name, cost, peak, PERF.md §6's bound ms to its printed digits, bytes
# where the table prints them)
BOUNDS = [
    ("flash qwen3 Sq=512", lambda: fa.cost(1, 512, 512, 16, 8, 128),
     PEAK_BF16, "0.0019", None),
    ("flash llama Sq=1024", lambda: fa.cost(1, 1024, 1024, 32, 32, 128),
     PEAK_BF16, "0.0100", None),
    ("decode bf16", lambda: da.cost(8, 16, 8, 128,
                                    da.valid_positions(_lens()[0], 1024)),
     PEAK_BF16, "0.0057", None),
    ("decode int8", lambda: da.cost(8, 32, 32, 128, da.valid_positions(
        _lens()[1], 2048), int8=True), PEAK_BF16, "0.0250", 83_763_744),
    ("scan S=1024", lambda: ms.cost(1, 1024, 8192, 16), PEAK_F32, "0.0204",
     68_255_744),
    ("flash backward", lambda: fa.cost_bwd(8, 1024, 16, 8, 128), PEAK_BF16,
     "0.0869", None),
    ("scan backward", lambda: ms.cost_bwd(1, 1024, 8192, 16), PEAK_BF16,
     "0.0379", 127_074_304),
    # the document cell's mean prefill: 2,690 tokens x top-6 over all 64
    # of deepseek-moe-16b's experts
    ("grouped ffn P=16140", lambda: gf.cost(16140, 2048, 1408, 64),
     PEAK_BF16, "0.3700", 1_239_515_136),
]


@pytest.mark.parametrize("name,cost,peak,printed,nbytes", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_cost_reproduces_the_bound_column(name, cost, peak, printed,
                                          nbytes):
    """Each kernel's ``cost`` gives PERF.md §6's Bound column at phase 3's
    shapes to its printed digits (the int8 mode's bytes are 83.8 MB)."""
    c = cost()
    assert f"{_bound_ms(c, peak):.4f}" == printed
    if nbytes is not None:
        assert c.bytes == nbytes


def test_causal_pairs():
    for sq, skv, off in ((5, 5, 0), (3, 8, 5), (4, 2, 0), (6, 3, 10),
                         (1, 1, 0)):
        want = sum(min(skv, i + off + 1) for i in range(sq))
        assert kmeta.causal_pairs(sq, skv, off) == want


def _meta_like(*ts):
    return [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in ts]


def _same(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert g.shape == w.shape and g.dtype == w.dtype


def _randn(*shape, dtype=torch.float32):
    return torch.randn(shape, generator=torch.Generator().manual_seed(
        sum(shape)), dtype=torch.float32).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_meta_branches(dtype):
    """Serving (causal, a q offset, non-causal), the training forward and,
    under autograd, the backward: the plain version's shapes and dtypes,
    and each kernel's cost in the tally."""
    q, k, v = _randn(2, 5, 4, 16, dtype=dtype), \
        _randn(2, 9, 2, 16, dtype=dtype), _randn(2, 9, 2, 16, dtype=dtype)
    item = q.element_size()
    for causal, off in ((True, 4), (False, 0)):
        kmeta.reset()
        _same(fa.flash_attention(*_meta_like(q, k, v), causal=causal,
                                 q_offset=off),
              fa.flash_attention_plain(q, k, v, causal=causal, q_offset=off))
        assert kmeta.tally["flash_attention"] == [
            1, *fa.cost(2, 5, 9, 4, 2, 16, item, causal, off)[:2]]
    kmeta.reset()
    qs = _randn(2, 7, 4, 16, dtype=dtype)
    ks, vs = _randn(2, 7, 2, 16, dtype=dtype), _randn(2, 7, 2, 16,
                                                      dtype=dtype)
    _same(fa.flash_attention_train_fwd(*_meta_like(qs, ks, vs)),
          fa.flash_attention_lse_plain(qs, ks, vs))
    mq, mk, mv = (t.requires_grad_() for t in _meta_like(qs, ks, vs))
    kmeta.reset()
    fa.flash_attention(mq, mk, mv).sum().backward()
    for t, ref in zip((mq, mk, mv), (qs, ks, vs)):
        _same(t.grad, ref)
    assert kmeta.tally["flash_attention"] == [
        1, *fa.cost(2, 7, 7, 4, 2, 16, item, lse=True)[:2]]
    assert kmeta.tally["flash_attention_bwd"] == [
        1, *fa.cost_bwd(2, 7, 4, 2, 16, item)[:2]]
    with pytest.raises(ValueError, match="gradients"):
        fa.flash_attention(mq, mk[:, :3], mv[:, :3])


def test_decode_meta_branches():
    """Both modes: the plain version's shape and dtype, every cached
    position counted."""
    from repro_torch.models.attention import quantize_kv
    q = _randn(3, 1, 4, 16, dtype=torch.bfloat16)
    k, v = (_randn(3, 10, 2, 16, dtype=torch.bfloat16) for _ in range(2))
    lens = torch.tensor([1, 5, 10], dtype=torch.int32)
    kmeta.reset()
    _same(da.decode_attention(*_meta_like(q, k, v, lens)),
          da.decode_attention_plain(q, k, v, lens))
    assert kmeta.tally["decode_attention"] == [
        1, *da.cost(3, 4, 2, 16, 30, 2)[:2]]
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    mq, mk, mv, ml, mks, mvs = _meta_like(q, kq, vq, lens, ks, vs)
    _same(da.decode_attention(mq, mk, mv, ml, k_scale=mks, v_scale=mvs),
          da.decode_attention_plain(q, kq, vq, lens, ks, vs))
    assert kmeta.tally["decode_attention_int8"] == [
        1, *da.cost(3, 4, 2, 16, 30, 2, int8=True)[:2]]


def test_scan_meta_branches():
    """Serving, the training forward (its saved states at the kernel's
    interval) and, under autograd, the backward."""
    xc, dt = _randn(2, 37, 24), _randn(2, 37, 24).abs()
    b, c = _randn(2, 37, 8), _randn(2, 37, 8)
    a_log, d = _randn(24, 8), _randn(24)
    args = (xc, dt, b, c, a_log, d)
    kmeta.reset()
    _same(ms.mamba_scan(*_meta_like(*args)), ms.mamba_scan_plain(*args))
    assert kmeta.tally["mamba_scan"] == [
        1, *ms.cost(2, 37, 24, 8, (4, 4, 4, 4))[:2]]
    y, hf, hc = ms.mamba_scan_train_fwd(*_meta_like(*args))
    assert tuple(hc.shape) == (2, 3, 24, 8) and hc.dtype == torch.float32
    margs = [t.requires_grad_() for t in _meta_like(*args)]
    kmeta.reset()
    y, hf = ms.mamba_scan(*margs)
    y.sum().backward()
    for t, ref in zip(margs, args):
        _same(t.grad, ref)
    assert kmeta.tally["mamba_scan_bwd"][0] == 1
    assert kmeta.tally["mamba_scan_bwd"][1:] == list(
        ms.cost_bwd(2, 37, 24, 8, (4, 4, 4, 4))[:2])


@pytest.mark.parametrize("call", [
    lambda t: fa.flash_attention(t, t, t),
    lambda t: da.decode_attention(t, t, t, t),
    lambda t: ms.mamba_scan(t, t, t, t, t, t),
    lambda t: gf.grouped_ffn(t, t, t, t, t, "silu")],
    ids=["flash", "decode", "scan", "grouped_ffn"])
def test_other_devices_still_raise(call):
    from _torch_device_support import no_kernel_tensor
    with pytest.raises(ValueError, match="no kernel for device"):
        call(no_kernel_tensor((1, 1, 1, 16)))


def test_local_shape_and_bytes():
    axes = (("pod", "data", "model"), (2, 4, 2))
    spec = (("pod", "data"), None, ("model",))
    assert sharding.local_shape((16, 3, 6), spec, axes) == (2, 3, 3)
    assert sharding.local_nbytes((16, 3, 6), torch.bfloat16, spec,
                                 axes) == 2 * 3 * 3 * 2
    full = torch.zeros((16, 3, 6))
    coords = {"pod": 1, "data": 2, "model": 1}
    assert tuple(sharding.local_shard(full, spec, axes, coords).shape) == \
        sharding.local_shape(full.shape, spec, axes)
    with pytest.raises(ValueError):
        sharding.local_shape((6, 3, 6), spec, axes)


def _ep_cfg(experts, top_k, cf):
    import dataclasses
    cfg = get_config("deepseek-moe-16b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=experts, top_k=top_k, impl="ep",
        capacity_factor=cf))


def _meta_all_to_all(cfg, data, model, tokens):
    """The bytes ``moe_ep``'s meta path records for one rank."""
    axes = (("data", "model"), (data, model))
    ctx = dist_ctx.ParallelContext(mesh=axes, batch_axes=("data",),
                                   model_axis="model", ep_axes=("data",))
    p = init_params(cfg, None, device="meta", data_shards=data)
    p = p["layers"][0]["moe"]
    p = {k: (v[0] if not isinstance(v, dict) else
             {n: w[0] for n, w in v.items()}) for k, v in p.items()}
    coll.reset_counts()
    with torch.no_grad(), dist_ctx.use(ctx):
        y, aux = moe.moe_ep(p, cfg, torch.empty(
            (tokens, cfg.d_model), device="meta"))
    assert tuple(y.shape) == (tokens, cfg.d_model) and aux.shape == ()
    return coll.bytes_moved["all-to-all"]


@pytest.mark.parametrize("data,model,experts,top_k", [
    (4, 1, 8, 2), (2, 2, 4, 2), (4, 1, 2, 1)],
    ids=["data4-e8", "data2-model2-e4", "data4-e2-replicated"])
def test_moe_ep_all_to_all_bytes_match_gloo(tmp_path, data, model,
                                            experts, top_k):
    """The dry-run's count of ``moe_ep``'s all-to-all bytes (the meta
    path: the dispatched rows, their expert ids and the returned rows at
    the static capacity) equals what ``distributed/collectives.py`` moves
    on each of 4 gloo CPU ranks running ``moe_ep`` at the same shape."""
    tokens, cf = 24, 1.25
    np.savez(tmp_path / "in.npz", dummy=np.zeros(1))
    outs = run_ranks("moe_bytes", 4, tmp_path, arch="deepseek-moe-16b",
                     data=data, model=model, experts=experts, top_k=top_k,
                     cf=cf, tokens=tokens)
    want = _meta_all_to_all(_ep_cfg(experts, top_k, cf), data, model,
                            tokens)
    cap = moe.ep_capacity(tokens, top_k, data, cf)
    d = get_config("deepseek-moe-16b").reduced().d_model
    assert want == data * cap * (4 * d * 2 + 8)     # f32 rows x 2, int64
    for o in outs:
        assert int(o["all_to_all"]) == want


def test_meta_moe_ep_backward_counts_four_all_to_alls():
    """Under autograd the meta path's two row all-to-alls are counted
    again by their backward (the expert ids carry no gradient)."""
    cfg = _ep_cfg(8, 2, 1.25)
    axes = (("data", "model"), (4, 1))
    ctx = dist_ctx.ParallelContext(mesh=axes, batch_axes=(),
                                   model_axis=None, ep_axes=("data",))
    p = init_params(cfg, None, device="meta", data_shards=4)
    p = p["layers"][0]["moe"]
    p = {k: (v[0].detach().requires_grad_() if not isinstance(v, dict)
             else {n: w[0].detach().requires_grad_() for n, w in v.items()})
         for k, v in p.items()}
    x = torch.empty((16, cfg.d_model), device="meta", requires_grad=True)
    coll.reset_counts()
    with dist_ctx.use(ctx):
        y, aux = moe.moe_ep(p, cfg, x)
    fwd = coll.bytes_moved["all-to-all"]
    (y.sum() + aux).backward()
    cap = moe.ep_capacity(16, 2, 4, 1.25)
    rows = 4 * cap * cfg.d_model * 4
    assert fwd == 2 * rows + 4 * cap * 8
    assert coll.bytes_moved["all-to-all"] == fwd + 2 * rows
    assert x.grad.shape == x.shape
    assert p["routed"]["w_up"].grad.shape == p["routed"]["w_up"].shape


def test_local_config_checks_the_rules_blocks():
    """The local config of a production cell matches the rules' blocks
    (the expanded heads where KV does not divide the model axis), and a
    wrong local config raises."""
    import dataclasses
    cfg = get_config("qwen3-0.6b")
    shape = ShapeConfig("d", 1024, 32, "decode")
    axes = dryrun.production_axes(False)
    args = dryrun.arguments(cfg, shape, axes)
    lcfg = dryrun.local_config(cfg, shape, axes)
    assert (lcfg.n_heads, lcfg.n_kv_heads, lcfg.d_ff,
            lcfg.vocab_size) == (1, 1, 192, 9496)
    assert dryrun.check_local_params(lcfg, args, axes) > 10
    with pytest.raises(ValueError, match="rules' block"):
        dryrun.check_local_params(dataclasses.replace(lcfg, d_ff=384),
                                  args, axes)


class _OnlyMeta(TorchDispatchMode):
    """Fails on any op whose tensors are not on ``meta``."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                assert t.device.type == "meta", (func, t.device)
        return out


def test_cli_full_width_cell(tmp_path):
    """``--arch qwen3-0.6b --shape decode_32k --mesh single``: exit 0, one
    JSON with every key of the record, a peak under the card's 80 GB; the
    same cell in this process allocates nothing off ``meta``."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--shape", "decode_32k", "--mesh", "single", "--out",
         str(tmp_path)], env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "dry-run complete" in out.stdout
    with open(tmp_path / "single" / "qwen3-0.6b__decode_32k.json") as f:
        r = json.load(f)
    for key in ("arch", "shape", "mesh", "n_chips", "params",
                "active_params", "argument_bytes_per_device",
                "output_bytes_per_device", "temp_bytes_per_device",
                "peak_bytes_per_device", "collective_bytes",
                "model_flops_global", "useful_flop_ratio", "compute_s",
                "memory_s", "collective_s", "dominant", "flops_per_device",
                "hbm_bytes_per_device", "trace_s"):
        assert key in r, key
    assert r["n_chips"] == 256 and r["mesh"] == "single"
    assert r["peak_bytes_per_device"] == r["argument_bytes_per_device"] \
        + r["temp_bytes_per_device"] < 80e9
    assert r["kernels"]["decode_attention"][0] == 28
    assert r["dominant"] == "memory_s"
    # the cache dominates: every layer's K and V, the rank's 8 slots, one
    # expanded head of 128 a layer
    assert r["argument_bytes_per_device"] > 28 * 2 * 8 * 32768 * 128 * 2
    with _OnlyMeta():
        again = dryrun.analyse(get_config("qwen3-0.6b"), ShapeConfig(
            "decode_32k", 32768, 128, "decode"),
            dryrun.production_axes(False), False)
    assert again["argument_bytes_per_device"] == \
        r["argument_bytes_per_device"]
    assert again["flops_per_device"] == r["flops_per_device"]
