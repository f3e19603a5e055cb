#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

  python3 chip_smoke.py [--json PATH]

Phases, in order; any failure raises and the process exits non-zero:
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the build of the hand-written kernels from the
     sources in this checkout (``build/repro_torch_kernels/``);
  2. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes, in bf16 (tolerance 2e-2) and f32 (2e-5);
  3. timing with CUDA events (median of 30 runs after warm-up, L2 flushed
     before each run): kernel, plain version, and one PyTorch library call
     of the same function (``scaled_dot_product_attention``, a yardstick
     only), beside the least time the card could take;
  4. a small reduced model on the card (kernels) against the same model
     on the CPU (plain versions), logits within 1e-3;
  5. serving: full-width qwen3-0.6b (28 layers, bf16, seeded random
     weights) on two ``LLMInstance`` engines through the port's
     ``serve_engine``, with the kernels' launch counts read around that
     run alone.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

BF16_TOL, F32_TOL = 2e-2, 2e-5
REDUCED_TOL = 1e-3
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bandwidth
TIMING_RUNS = 30

FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
DA_SOURCE = ("src/repro_torch/kernels/decode_attention/csrc/"
             "decode_attention.cu")
FA_REPLACES = "src/repro/kernels/flash_attention/kernel.py:68"
DA_REPLACES = "src/repro/kernels/decode_attention/kernel.py:64"


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 2: kernels against their plain versions ----------------------------

def check_kernels(torch, fa, da):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def compare(name, out, ref, tol, what):
        err = float((out.float() - ref.float()).abs().max())
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol, msg=lambda m: f"{what}: {m}")
        log(f"  {what}: max_abs_err={err:.3e} (tol {tol})")
        if out.dtype == torch.bfloat16:
            errs[name] = max(errs[name], err)

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for sq in (1, 37, 128, 901):
            q = rand((1, sq, 16, 128), dtype)
            k, v = rand((1, sq, 8, 128), dtype), rand((1, sq, 8, 128), dtype)
            compare("flash_attention", fa.flash_attention(q, k, v),
                    fa.flash_attention_plain(q, k, v), tol,
                    f"flash {dtype} Sq={sq}")
        q = rand((8, 1, 16, 128), dtype)
        k, v = rand((8, 1024, 8, 128), dtype), rand((8, 1024, 8, 128), dtype)
        lens = torch.tensor([1, 2, 37, 500, 1000, 1023, 1024, 1100],
                            dtype=torch.int32, device=dev)
        compare("decode_attention", da.decode_attention(q, k, v, lens),
                da.decode_attention_plain(q, k, v, lens), tol,
                f"decode {dtype} B=8 S=1024 kv_len={lens.tolist()}")
    torch.cuda.synchronize()
    return errs


# -- phase 3: timing ----------------------------------------------------------

def time_ms(torch, fn, flush) -> float:
    """Median milliseconds of one call, CUDA events, L2 flushed before
    each run, after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMING_RUNS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sdpa(torch, q, k, v, **kw):
    """One library attention call on [B,H,S,hd] views (yardstick only)."""
    F = torch.nn.functional
    try:
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except TypeError:   # torch without enable_gqa: expand the KV heads
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), **kw)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_kernels(torch, fa, da, prompt_len: int, kv_lens):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out = {}

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    # prefill: B=1, Sq=Skv=prompt_len, H=16, KV=8, hd=128
    s, h, kvh, hd = prompt_len, 16, 8, 128
    q, k, v = rand(1, s, h, hd), rand(1, s, kvh, hd), rand(1, s, kvh, hd)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v), flush)
    plain = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v), flush)
    lib = time_ms(torch, lambda: sdpa(torch, qt, kt, vt, is_causal=True),
                  flush)
    pairs = s * (s + 1) // 2                       # causal (q, k) pairs
    b_ms, b_by = bound(4 * hd * h * pairs, 2 * (2 * s * h * hd
                                                + 2 * s * kvh * hd))
    out["flash_attention"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                  bound_ms=b_ms, bound_by=b_by,
                                  shape=f"B=1 Sq=Skv={s} H=16 KV=8 hd=128 "
                                  "bf16 causal")
    # decode: B=8, S=1024, H=16, KV=8, hd=128, this run's kv_len
    b, s = len(kv_lens), 1024
    q = rand(b, 1, h, hd)
    k, v = rand(b, s, kvh, hd), rand(b, s, kvh, hd)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[
        :, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = time_ms(torch, lambda: da.decode_attention(q, k, v, lens), flush)
    plain = time_ms(torch, lambda: da.decode_attention_plain(q, k, v, lens),
                    flush)
    lib = time_ms(torch, lambda: sdpa(torch, qt, kt, vt, attn_mask=mask),
                  flush)
    valid = sum(min(max(n, 0), s) for n in kv_lens)
    b_ms, b_by = bound(4 * hd * h * valid,
                       2 * (2 * valid * kvh * hd + 2 * b * h * hd) + 4 * b)
    out["decode_attention"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                   bound_ms=b_ms, bound_by=b_by,
                                   shape=f"B={b} S={s} H=16 KV=8 hd=128 "
                                   f"bf16 kv_len={kv_lens}")
    for name, r in out.items():
        log(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    del flush
    return out


# -- phase 4: reduced model, card against CPU --------------------------------

def check_reduced_model(torch, get_config, params_lib, model_lib):
    cfg = get_config("qwen3-0.6b").reduced(head_dim=32)
    gen = torch.Generator().manual_seed(0)
    p_cpu = params_lib.init_params(cfg, gen, device="cpu")
    p_gpu = params_lib.from_reference(_tree_numpy(p_cpu), device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 41),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        lc, cc = model_lib.prefill(p_cpu, cfg, toks[:, :37], cache_len=39)
        lg, cg = model_lib.prefill(p_gpu, cfg, toks[:, :37].cuda(),
                                   cache_len=39)
        pairs = [(lc, lg)]
        for t in range(37, 41):    # the last two run past the cache
            lc, cc = model_lib.decode_step(p_cpu, cfg, cc, toks[:, t])
            lg, cg = model_lib.decode_step(p_gpu, cfg, cg, toks[:, t].cuda())
            pairs.append((lc, lg))
    err = 0.0
    for i, (c, gpu) in enumerate(pairs):
        gpu = gpu.cpu()
        assert gpu.shape == (2, cfg.vocab_size), gpu.shape
        assert torch.isfinite(gpu).all(), f"step {i}: non-finite logits"
        torch.testing.assert_close(gpu, c, rtol=REDUCED_TOL,
                                   atol=REDUCED_TOL)
        err = max(err, float((gpu - c).abs().max()))
    log(f"  reduced qwen3-0.6b (hd=32, f32) prefill 37 + 4 decode: card vs "
        f"CPU max_abs_err={err:.3e} (tol {REDUCED_TOL})")


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_numpy(v) for v in tree]
    return tree.numpy()


# -- phase 5: serve full-width qwen3-0.6b -------------------------------------

def serve(torch, np, modules):
    (get_config, params_lib, LLMInstance, profiles, get_scheduler,
     Request, serve_mod, fa, da) = modules
    cfg = get_config("qwen3-0.6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype) == (
        28, 1024, 16, 8, 128, 3072, 151936, "bfloat16"), cfg
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = params_lib.init_params(cfg, gen, device="cuda")
    n_params = params_lib.count_tensor_params(params)
    assert n_params == cfg.count_params(), (n_params, cfg.count_params())
    torch.cuda.synchronize()
    log(f"  qwen3-0.6b: {n_params} parameters (bf16) initialised in "
        f"{time.perf_counter() - t0:.2f} s")
    prof = profiles.V100_LLAMA2_7B
    args = argparse.Namespace(requests=0)
    finite = []
    step_s = {"prefill": [], "decode": []}

    def engines():
        insts = [LLMInstance(cfg, params, prof, get_scheduler("fcfs"),
                             n_slots=8, cache_len=1024, instance_id=i,
                             device="cuda") for i in range(2)]
        for inst in insts:
            pre, dec = inst.prefill_fn, inst.decode_fn

            # host clock around each model pass; the engine waits for
            # the logits right after each pass anyway
            def prefill(*a, _f=pre, **kw):
                t = time.perf_counter()
                logits, cache = _f(*a, **kw)
                torch.cuda.synchronize()
                step_s["prefill"].append(time.perf_counter() - t)
                assert logits.shape == (1, cfg.vocab_size)
                finite.append(torch.isfinite(logits).all())
                return logits, cache

            def decode(*a, _f=dec, **kw):
                t = time.perf_counter()
                logits, cache = _f(*a, **kw)
                torch.cuda.synchronize()
                step_s["decode"].append(time.perf_counter() - t)
                assert logits.shape == (8, cfg.vocab_size)
                finite.append(torch.isfinite(logits).all())
                return logits, cache
            inst.prefill_fn, inst.decode_fn = prefill, decode
        return insts

    # warm-up on throwaway engines (cuBLAS handles, allocator)
    serve_mod.serve_engine(args, engines(), [
        Request(prompt_tokens=64, decode_tokens=4, rid=10_000 + i)
        for i in range(2)])
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(16):
        if i in (3, 8, 13):     # these run past the 1024-token cache
            p, d = int(rng.integers(990, 1011)), int(rng.integers(40, 65))
        else:
            p, d = int(rng.integers(100, 901)), int(rng.integers(16, 65))
        reqs.append(Request(prompt_tokens=p, decode_tokens=d, rid=i))
    assert sum(r.prompt_tokens + r.decode_tokens > 1024 for r in reqs) == 3
    insts = engines()
    finite.clear()
    for v in step_s.values():
        v.clear()
    torch.cuda.synchronize()
    fa.launches = 0
    da.launches = 0
    t0 = time.perf_counter()
    stats = serve_mod.serve_engine(args, insts, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches}
    admissions = sum(i.n_prefills for i in insts)
    iters = sum(i.n_decode_steps for i in insts)
    assert stats["n"] == len(reqs), stats
    assert all(r.decoded == r.decode_tokens for r in reqs)
    assert bool(torch.stack(finite).all()), "non-finite logits"
    assert launches["flash_attention"] == cfg.n_layers * admissions > 0, (
        launches, admissions)
    assert launches["decode_attention"] == cfg.n_layers * iters > 0, (
        launches, iters)
    out_tok = sum(r.decode_tokens for r in reqs)
    log(f"  served {len(reqs)} requests ({admissions} admissions, "
        f"{iters} decode iterations, preemptions {stats['preemptions']}) "
        f"in {wall:.3f} s wall on the card: {out_tok / wall:.1f} output "
        f"tok/s, {(out_tok + sum(r.prompt_tokens for r in reqs)) / wall:.1f}"
        f" total tok/s; launches {launches}")
    pre_ms = statistics.median(step_s["prefill"]) * 1e3
    dec_ms = statistics.median(step_s["decode"]) * 1e3
    in_model = sum(map(sum, step_s.values()))
    log(f"  model passes: prefill median {pre_ms:.2f} ms (mean prompt "
        f"{statistics.mean(r.prompt_tokens for r in reqs):.0f} tokens), "
        f"gang decode step median {dec_ms:.2f} ms; {in_model:.3f} s of the "
        f"{wall:.3f} s wall inside model passes")
    log(f"  virtual clock (profile {prof.name}, not a measurement): {stats}")
    device = profile_decode(torch, insts[0], dec_ms)
    return launches, dict(wall_s=wall, output_tokens=out_tok,
                          admissions=admissions, decode_iterations=iters,
                          prefill_median_ms=pre_ms,
                          decode_step_median_ms=dec_ms,
                          in_model_s=in_model, stats=stats,
                          decode_profile=device)


def profile_decode(torch, inst, step_ms: float, steps: int = 5):
    """Device time of the engine's gang decode step, by kernel, from
    torch.profiler over a few steps on a served engine's cache (after the
    counted run), against the served run's median step wall ``step_ms``
    (the profiler's own start-up makes a wall clock under it useless)."""
    from torch.profiler import ProfilerActivity, profile
    toks = torch.zeros(inst.n_slots, dtype=torch.long, device="cuda")
    with torch.no_grad():
        inst.decode_fn(inst.params, cache=inst.cache, tokens=toks)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                inst.decode_fn(inst.params, cache=inst.cache, tokens=toks)
            torch.cuda.synchronize()
    # device-side kernel events: their time range is the kernel's run
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + us, n + 1)
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device kernels")
    rows = [(k, t, n) for k, (t, n) in by_name.items()]
    busy = sum(r[1] for r in rows) / steps / 1e3            # ms per step
    attn = sum(r[1] for r in rows if "dec_fwd" in r[0]) / steps / 1e3
    kernels = sum(r[2] for r in rows) / steps
    top = sorted(rows, key=lambda r: -r[1])[:6]
    log(f"  profiled decode step (B=8): device busy {busy:.3f} ms of the "
        f"served {step_ms:.2f} ms median step (idle "
        f"{1 - busy / step_ms:.1%}), decode_attention {attn:.3f} ms "
        f"({attn / busy:.1%} of device time), {kernels:.0f} kernels/step")
    for key, t, n in top:
        log(f"    {t / steps / 1e3:8.3f} ms/step  {n // steps:5d}x  "
            f"{key[:70]}")
    return dict(device_busy_ms=busy, idle_share=1 - busy / step_ms,
                decode_attention_ms=attn, kernels_per_step=kernels)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None,
                    help="also write the full results to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import profiles
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as model_lib
    from repro_torch.models import params as params_lib
    from repro_torch.serving.engine import LLMInstance
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import get_scheduler
    assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                   or m == "repro" for m in sys.modules), "JAX imported"

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    gpu = gpu_line()
    log(f"[1/5] environment: {gpu}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = build.library_path()
    build.library()
    log(f"  kernels built/loaded in {time.perf_counter() - t0:.2f} s: "
        f"{os.path.relpath(lib_path, ROOT)}")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    log("[2/5] kernels against their plain versions on the card")
    errs = check_kernels(torch, fa, da)

    log("[3/5] timing (CUDA events, median of "
        f"{TIMING_RUNS}, L2 flushed)")
    kv_rng = np.random.default_rng(2)
    kv_lens = [int(x) for x in kv_rng.integers(100, 1025, 7)] + [1100]
    times = time_kernels(torch, fa, da, prompt_len=512, kv_lens=kv_lens)

    log("[4/5] reduced model: card (kernels) against CPU (plain)")
    check_reduced_model(torch, get_config, params_lib, model_lib)

    log("[5/5] serve full-width qwen3-0.6b through serve_engine")
    launches, served = serve(torch, np, (
        get_config, params_lib, LLMInstance, profiles, get_scheduler,
        Request, serve_mod, fa, da))

    kernels = []
    for name, src, rep in (("flash_attention", FA_SOURCE, FA_REPLACES),
                           ("decode_attention", DA_SOURCE, DA_REPLACES)):
        t = times[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": t["ms"],
                        "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    log("kernels: " + ", ".join(
        f"{k['name']} err={k['max_abs_err']:.3e} {k['ms']:.4f} ms "
        f"(plain {k['plain_ms']:.4f}, sdpa {k['library_ms']:.4f}, bound "
        f"{k['bound_ms']:.4f} {k['bound_by']}) launches={k['launches']}"
        for k in kernels))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"gpu": gpu, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "kernels": kernels,
                       "timing_shapes": {n: t["shape"]
                                         for n, t in times.items()},
                       "serve": served}, f, indent=1, default=str)
    log(gpu)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
