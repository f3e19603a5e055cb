#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

  python3 chip_smoke.py [--json PATH] [--kernels-only]

``--kernels-only`` stops after phase 3.  The script imports the port
from the ``src`` beside it; to time another commit's kernels with this
script, copy it into that commit's checkout and run it there.

Phases, in order (but 5b, which launches no kernel of the port, runs
right after phase 1, while nvcc builds the kernels in the background);
any failure raises and the process exits non-zero:
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the build of the hand-written kernels from the
     sources in this checkout (``build/repro_torch_kernels/``);
  2. each kernel against its plain PyTorch version on the card, at the
     serving paths' shapes, in bf16 (tolerance 2e-2) and f32 (2e-5); the
     bf16 flash kernel also at llama-2-7b's heads (H=KV=32, hd=128) across
     its 64-row tiles' edges, after a cached prefix and non-causal; the
     int8-cache decode mode at llama-2-7b's (B=8, S=2048, H=KV=32,
     hd=128, bf16 q, 2e-2), kv_len across its split's edges; the bf16
     decode mode at qwen3-0.6b's heads (B=8, S=1024, H=16, KV=8,
     hd=128), kv_len across the same split's edges; the selective scan
     at falcon-mamba-7b's
     (B=1, S=1024, di=8192, ds=16, bf16 xc/b/c, f32 dt: y within 2e-2,
     the f32 final state within 1e-4 of its scale), at reduced f32
     shapes with a ragged S and S=1 (1e-4), and at falcon-mamba-7b's
     width with a random a_log per (channel, state) at S=1024 and at S
     ragged against the kernel's 64-step chunks (1, 31, 33, 1017), bf16
     and f32; bf16 flash (Sq 1-1500) and the bf16 decode mode (B=8,
     S=2048, kv_len across the split's edges) at phase 9's MHA heads,
     musicgen-medium's (H=KV=24, hd=64) and deepseek-moe-16b's (H=KV=16,
     hd=128), 2e-2; the two training backwards against their plain
     versions, each gradient within 2e-2 (bf16) or 1e-4 (f32) of its
     largest |grad| and a second launch bit-equal: flash (forward with
     its log-sum-exp, then dq/dk/dv) at qwen3-0.6b's (B=2, S=1024, H=16,
     KV=8, hd=128), llama-2-7b's (H=KV=32), musicgen-medium's (H=KV=24,
     hd=64) heads, hd=32, S in {1, 63, 64, 65, 127, 128, 129, 1000} and
     G = H / KV of 1, 2 and 4 at each head dimension; the scan (dxc, ddt,
     db, dc, da_log, dd from the forward's saved states, a nonzero
     h_final gradient, random a_log) at falcon-mamba-7b's width (B=1,
     S=1024, di=8192, ds=16, bf16 xc/b/c, f32 dt), at reduced f32 shapes
     with S across the kernel's 4-, 16- and 32-step edges (1 to 1017),
     and with di off its 32-channel blocks and 256-channel clusters, ds
     4, 8 and 16, bf16 and f32 mixed;
  3. timing with CUDA events (median of 30 runs after warm-up, L2 flushed
     before each run; ``ms`` from the call's enqueue on, ``device_ms``
     with a spin kernel ahead of the start event that keeps the card busy
     past the host's enqueue; the scan's plain versions, Python loops
     over the steps, median of 5): kernel, plain version, and one PyTorch
     library call of the same function
     (``scaled_dot_product_attention``, a yardstick only; for the int8
     mode on the cache dequantized beforehand, the dequantization not
     timed; no single PyTorch call computes a
     selective scan), beside the least time the card could take; flash
     at qwen3-0.6b's prefill shape and at llama-2-7b's, the scan at
     S=1024 and S=100; the flash backward at qwen3-0.6b's training shape
     (B=8, S=1024; library: scaled_dot_product_attention's backward, and
     the ratio of the two device times) and the scan backward at
     falcon-mamba-7b's width, S=1024 (bound: bytes against one exponential
     a (step, channel, state) on the special-function units, the saved
     states counted one every 64 steps; the bytes of its partials and of
     its saved states and its shuffles a (step, channel, state) worked out
     from the code, in the log only), each with its share of its bound and
     the card's name and power limit;
  4. small reduced models of every family on the card (kernels)
     against the same models on the CPU (plain versions), prefill 37 + 4
     decode steps, logits within 1e-3: qwen3-0.6b, falcon-mamba-7b,
     deepseek-moe-16b, minicpm3-4b, jamba-v0.1-52b,
     llama-3.2-vision-11b (cross gates 0.5 / -0.3, seeded vision input)
     and musicgen-medium (seeded frame embeddings), head_dim 32 where a
     kernel runs;
  5. serving: full-width qwen3-0.6b (28 layers, bf16, seeded random
     weights) on two ``LLMInstance`` engines through the port's
     ``serve_engine``, with the kernels' launch counts read around that
     run alone;
  5b. the router's learning path at the reference CLI's sizes (the
     router's full width): the length predictor (seq 64, d 64, 4 heads,
     2 layers, 8 buckets) trained on the card by
     ``quick_bucket_predictor`` (2000 samples, 2 epochs), its accuracy,
     train-step and 16-row micro-batch forward times, its logits on 512
     prompts against a CPU copy (1e-4, buckets equal); the decomposed
     DQN router trained on the card by ``_train_quick_agent`` (4
     instances on the V100 profile, 400 requests at 2.5/s, 8 episodes,
     batch 512, buffer 200,000), ms per act and per learn step, and the
     Q-values of 256 of its states against a CPU copy (Q_TOL); its
     checkpoint written and restored through ``restore_rl_policy``, every
     leaf bit-equal; then ``serve_sim`` with the trained router and
     ``serve_gateway --backend py`` with the learned predictor in the
     loop, under the restored router and under mixing, on the same
     400-request stream, each writing a Chrome trace (validated) and a
     metrics file under ``build/``; the kernels' launch counts read
     around the phase (none of them runs there);
  5c. the router's scale-up on the card (no kernel of the port runs
     there; each part's launch counts are read around it and must be 0):
     (a) benchmarks/bench_batched_rl.py's schedule (V100 x 4, the
     Table-1 mixture, 200 requests at 20/s, 16 episodes) trained three
     ways -- sequential ``rl.train``, ``train_router`` with 8
     environments over the ``py`` stepper and over the ``vec`` pool --
     with decisions/s, learn steps, the vec-trained router's held-out
     E2E beside round robin's and mixing's, and one ``act_batch`` of 8
     rows and one learn step of 256 rows timed and profiled; (b) ``train_router``
     over the heterogeneous scenario stream (400 requests, clusters up to
     6 wide, 16 episodes) on ``vec``, the trained Q on 512 recorded
     states against a CPU copy (Q_TOL); (c) benchmarks/
     bench_online_drift.py at its smoke scale (500 requests at 3.0/s, a
     warm start of 5 offline episodes of 220; ``DRIFT_SCALE`` selects
     the paper scale) served over the ``vec`` gateway frozen, online
     (``OnlineTrainer`` learning on the card) and by mixing, with P95
     E2E overall and after the flip (virtual clock) and the wall time of
     each arm;
  6. the serving gateway: full-width llama-2-7b (32 layers, bf16, seeded
     random weights) on two engines with int8 KV caches (8 slots x 2048
     tokens), one seeded stream of 12 requests served through the port's
     ``serve_gateway`` under the RL policy (phase 5b's trained router,
     restored from its checkpoint by ``restore_rl_policy``, held against
     the same network on the CPU) and under the mixing heuristic, with
     the launch counts read around each run, one decode step and one
     prefill profiled per policy;
  7. the gateway over full-width falcon-mamba-7b (64 Mamba-1 layers,
     bf16, seeded random weights) on two engines x 8 slots, one seeded
     stream of 8 requests served through ``serve_gateway`` under the RL
     policy (phase 5b's restored router), with the launch counts read
     around that run, and one decode step and one prefill profiled;
  8. the simulator<->engine loop (the paper's Fig. 4; what
     benchmarks/bench_fidelity.py runs on a reduced model, here at full
     width with phases 5 and 6's weights), each part's launch counts
     read around it: (a) ``core.calibrate.calibrate`` sweeps llama-2-7b's
     engine functions (int8 KV; prompts 128-1536, decode up to 8 slots
     x 2048, 8 chained steps a call, min of 5 interleaved repeats, host
     clock with the card synchronised) and fits its H100 profile,
     printed with its sanity ordering beside V100's and beside phase 6's
     served walls, saved under ``build/calibration/`` and read back; (b)
     the same for qwen3-0.6b (bf16 cache; prompts 128-896, decode up to
     8 x 1024), beside phase 5's walls; (c)
     ``serving.fidelity.run_fidelity`` replays one 12-request stream
     through the py and vec simulators and two llama-2-7b engines (8
     slots x 2048) under mixing, on the V100 profile and on (a)'s: vec
     equals py and the engine's P95 E2E is within bench_fidelity's band
     (0.35) of py's on both; (d) the
     saturating stream on one qwen3-0.6b engine x 2 slots: both the
     simulator and the engine preempt, and every request completes;
  9. the MoE and MLA families at full width (bf16, seeded random
     weights; phase 8's weights freed first, each model freed before
     the next): (a) deepseek-moe-16b (28 layers, the first dense; 64
     experts top-6 + 2 shared; 16.38 B) and (b) minicpm3-4b (62 MLA
     layers; 4.26 B) each on two engines x 8 slots x 2048 through
     ``serve_gateway`` under ``rl`` (phase 5b's restored router), 8
     requests (prompts 100-1500, outputs 16-64, 1/s), the launch counts
     read around each run (deepseek: flash 28 x admissions, bf16 decode
     28 x iterations; minicpm3: none), one decode step and one prefill
     of the median prompt profiled; (c) model-level: ``gather``,
     ``ragged`` and ``dense`` on the same 8 and 512 rows at deepseek's
     and jamba's widths (within 2e-2 of max |y|, peak memory printed),
     and 3 decode steps after a 300-token prefill against fresh prefills
     of the same positions for minicpm3-4b, llama-3.2-vision-11b (9.78
     B, vision [1, 1024, 1280], cross gates 0.5 / -0.3),
     musicgen-medium (1.36 B, frame embeddings), deepseek-moe-16b and
     jamba-v0.1-52b cut to one period (8 of 32 layers, widths intact,
     13.30 B), each check's launch counts asserted (jamba's scan
     included); the error is asserted within 5% of max |logit| for the
     models without routed experts and printed with the top-1
     agreement for the two with them;
  10. LM training (phase 9's weights freed first), each part's launch
     counts read around it: (a) one f32 AdamW train step of phase 4's
     seven reduced families on the card (the kernels and their
     backwards) against the CPU from the same parameters and batch:
     loss within 1e-5, every gradient leaf within 1e-4 of its largest
     |g|, params after the step within 1e-5; (b) full-width qwen3-0.6b
     through ``repro_torch.launch.train``'s loop (AdamW lr 1e-3, warmup
     20, batch 8 x 1024, 30 steps, checkpoints every 10 under
     ``build/train_ckpt/``), the loss falling, then a second run resumed
     from the step-20 checkpoint alone whose steps 21-30 and final state
     are bit-equal to the first's under
     ``torch.use_deterministic_algorithms``; step wall, tokens/s, peak
     memory, flash launches a step (56 forward, 28 backward) and one
     step profiled; (c) full-width falcon-mamba-7b under
     ``launch.steps.build_train_step(cfg, "adafactor")``, batch 1 x 1024,
     4 steps on one repeated batch: the loss finite and falling, the
     scan 128 forward and 64 backward launches a step, peak memory.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

BF16_TOL, F32_TOL = 2e-2, 2e-5
REDUCED_TOL = 1e-3
Q_TOL = 1e-5                 # RL Q-values, card against CPU (TF32 off)
PRED_TOL = 1e-4              # predictor logits, card against CPU
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bandwidth
TIMING_RUNS = 30
SPIN_CYCLES = 200_000        # ~0.1 ms at the H100's clock (device_ms)

SCAN_TOL = 1e-4              # tests/test_kernels.py's bound for the scan
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores

FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
DA_SOURCE = ("src/repro_torch/kernels/decode_attention/csrc/"
             "decode_attention.cu")
MS_SOURCE = "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu"
# name, source, the TPU kernel it replaces
KERNELS = (
    ("flash_attention", FA_SOURCE,
     "src/repro/kernels/flash_attention/kernel.py:68"),
    ("decode_attention", DA_SOURCE,
     "src/repro/kernels/decode_attention/kernel.py:64"),
    ("decode_attention_int8", DA_SOURCE,
     "src/repro/kernels/decode_attention/kernel.py:98"),
    ("mamba_scan", MS_SOURCE, "src/repro/kernels/mamba_scan/kernel.py:55"),
    # the training backwards: the gradients of what those TPU kernels
    # compute, which the reference takes by jax.grad of plain jnp
    ("flash_attention_bwd", FA_SOURCE,
     "src/repro/kernels/flash_attention/kernel.py:68"),
    ("mamba_scan_bwd", MS_SOURCE,
     "src/repro/kernels/mamba_scan/kernel.py:55"),
)
# llama-2-7b's decode attention: n_slots=8, cache 2048, MHA 32 x 128
LLAMA_DECODE = dict(b=8, s=2048, h=32, kvh=32, hd=128)
# falcon-mamba-7b's selective scan in a 1024-token prefill, and in one of
# phase 7's shortest prompts
FALCON_SCAN = dict(b=1, s=1024, di=8192, ds=16)
SCAN_SHORT_S = 100
# bf16 flash at llama-2-7b's heads, (Sq, Skv, q_offset, causal): Sq across
# the 64-row q tiles' edges, a chunk after a cached prefix, non-causal
FLASH_LLAMA_CASES = ((1, 1, 0, True), (63, 63, 0, True), (64, 64, 0, True),
                     (65, 65, 0, True), (1017, 1017, 0, True),
                     (1500, 1500, 0, True), (100, 400, 300, True),
                     (200, 333, 0, False))
# int8 decode kv_len (B=8, S=2048): 1, S and past S, and the edges of the
# kernel's split (8 blocks of ceil(len/8) positions rounded up to 64): one
# block exactly full (64), the next taking one row (65), ..., all 8 full
# (512, 1024) and the next granule (513, 1025); 0 masks every position
INT8_LENS = ([1, 2, 37, 500, 1000, 2047, 2048, 2100],
             [0, 63, 64, 65, 255, 256, 257, 511],
             [512, 513, 575, 576, 577, 1024, 1025, 2049])
# bf16 decode kv_len (B=8, S=1024), the same split's edges: 0, one block
# exactly full (64) and the next taking one row (65), a block's tail
# (255-257), all 8 full (512) and the next granule (513, 575-577), S and
# past S (1023-1025, 2049)
BF16_LENS = ([0, 63, 64, 65, 255, 256, 257, 2049],
             [511, 512, 513, 575, 576, 577, 1, 1000],
             [1023, 1024, 1025, 2, 37, 300, 700, 900])
# the scan at falcon-mamba-7b's width with a random a_log: S=1024 and S
# ragged against the kernel's 64-step chunks
SCAN_RANDOM_A_S = (1024, 1, 31, 33, 1017)
# llama-2-7b's prefill attention (phase 3's second flash shape)
LLAMA_PREFILL = dict(s=1024, h=32, kvh=32, hd=128)
# phase 9's attention heads (MHA): musicgen-medium's and deepseek-moe-16b's,
# with flash's Sq across the 64-row tiles' edges up to the stream's longest
# prompt and the bf16 decode mode's kv_len across its split's edges
NEW_HEADS = (("musicgen-medium", 24, 64), ("deepseek-moe-16b", 16, 128))
FLASH_NEW_SQ = (1, 63, 65, 300, 1500)
DECODE_NEW_LENS = [0, 1, 64, 65, 513, 1500, 2048, 2051]
# the flash backward's checks (B, S, H, KV, hd, what): qwen3-0.6b's,
# llama-2-7b's and musicgen-medium's heads, hd=32, S across the edges of
# the 64-row wgmma tiles and the 128-row blocks at qwen3's heads, and
# G = H / KV of 1, 2 and 4 at each head dimension
FLASH_BWD_CASES = ((2, 1024, 16, 8, 128, "qwen3-0.6b"),
                   (1, 1024, 32, 32, 128, "llama-2-7b"),
                   (1, 1024, 24, 24, 64, "musicgen-medium"),
                   (2, 300, 8, 4, 32, "hd=32"),
                   (1, 1, 16, 8, 128, "qwen3-0.6b S=1"),
                   (1, 63, 16, 8, 128, "qwen3-0.6b S=63"),
                   (1, 64, 16, 8, 128, "qwen3-0.6b S=64"),
                   (1, 65, 16, 8, 128, "qwen3-0.6b S=65"),
                   (1, 127, 16, 8, 128, "qwen3-0.6b S=127"),
                   (1, 128, 16, 8, 128, "qwen3-0.6b S=128"),
                   (1, 129, 16, 8, 128, "qwen3-0.6b S=129"),
                   (1, 1000, 16, 8, 128, "qwen3-0.6b S=1000"),
                   (1, 129, 16, 4, 128, "G=4"),
                   (1, 127, 8, 4, 64, "hd=64 G=2"),
                   (1, 65, 8, 8, 64, "hd=64 G=1"),
                   (2, 65, 8, 2, 32, "hd=32 G=4"),
                   (1, 129, 4, 4, 32, "hd=32 G=1"))
BWD_TOLS = {"bfloat16": 2e-2, "float32": 1e-4}   # of max |grad|
# the scan backward at reduced shapes (f32 unless named), S across the
# kernel's 4-step groups, 16-step saved states and 32-step chunks; then
# (B, S, di, ds, xc/dt/b/c dtypes): di off the blocks' 32 (64 at ds 4)
# channels and the clusters' 256, every ds, bf16 and f32 mixed
SCAN_BWD_S = (1, 3, 4, 5, 15, 16, 17, 31, 32, 33, 63, 65, 1017)
SCAN_BWD_CASES = ((2, 40, 300, 16, ("bfloat16", "float32", "bfloat16",
                                    "bfloat16")),
                  (1, 100, 257, 4, ("float32", "bfloat16", "float32",
                                    "bfloat16")),
                  (1, 33, 65, 8, ("bfloat16", "bfloat16", "bfloat16",
                                  "float32")),
                  (2, 17, 513, 16, ("float32",) * 4))
# the scan backward's bound counts the forward's saved states one every
# this many steps, whatever interval the kernel saves them at
BOUND_STATE_CHUNK = 64
# the scan's plain versions are Python loops over the steps (0.1-0.5 s a
# call at falcon-mamba-7b's width): timed over fewer runs
PLAIN_SCAN_RUNS = 5
# qwen3-0.6b's training shape: the flash backward's timing
QWEN_TRAIN = dict(b=8, s=1024, h=16, kvh=8, hd=128)
# exponentials a second on the special-function units: 16 a clock per SM,
# 132 SMs at the 1.98 GHz boost clock
SFU_RATE = 16 * 132 * 1.98e9


def log(*a):
    print(*a, flush=True)


def reset_launches(m):
    m.fa.launches = m.da.launches = m.da.launches_int8 = m.ms.launches = 0
    m.fa.launches_bwd = m.ms.launches_bwd = 0


def read_launches(m) -> dict:
    return {"flash_attention": m.fa.launches,
            "decode_attention": m.da.launches,
            "decode_attention_int8": m.da.launches_int8,
            "mamba_scan": m.ms.launches,
            "flash_attention_bwd": m.fa.launches_bwd,
            "mamba_scan_bwd": m.ms.launches_bwd}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 2: kernels against their plain versions ----------------------------

def check_kernels(torch, fa, da, ms, quantize_kv):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    errs = {"flash_attention": 0.0, "decode_attention": 0.0,
            "decode_attention_int8": 0.0, "mamba_scan": 0.0}

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
    # bf16 flash at llama-2-7b's heads: Sq across the 64-row q tiles'
    # edges, a query chunk after a cached prefix, and non-causal
    for sq, skv, off, causal in FLASH_LLAMA_CASES:
        q = rand((1, sq, 32, 128), torch.bfloat16)
        k, v = (rand((1, skv, 32, 128), torch.bfloat16) for _ in range(2))
        compare("flash_attention",
                fa.flash_attention(q, k, v, causal=causal, q_offset=off),
                fa.flash_attention_plain(q, k, v, causal=causal,
                                         q_offset=off), BF16_TOL,
                f"flash bf16 H=KV=32 Sq={sq} Skv={skv} q_offset={off} "
                f"causal={causal}")
    ld = LLAMA_DECODE
    q = rand((ld["b"], 1, ld["h"], ld["hd"]), torch.bfloat16)
    (k, ks), (v, vs) = (int8_cache(torch, quantize_kv, g, **ld)
                        for _ in range(2))
    for lens in INT8_LENS:
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        compare("decode_attention_int8",
                da.decode_attention(q, k, v, lens, k_scale=ks, v_scale=vs),
                da.decode_attention_plain(q, k, v, lens, ks, vs), BF16_TOL,
                f"decode int8 cache, bf16 q, B=8 S=2048 H=KV=32 hd=128 "
                f"kv_len={lens.tolist()}")
    fs = FALCON_SCAN
    cases = [((fs["b"], fs["s"], fs["di"], fs["ds"]), torch.bfloat16, False),
             ((2, 50, 128, 8), torch.float32, False),
             ((2, 1, 128, 8), torch.float32, False),
             ((1, 64, 256, 4), torch.float32, False)]
    cases += [((fs["b"], s, fs["di"], fs["ds"]), act, True)
              for s in SCAN_RANDOM_A_S
              for act in (torch.bfloat16, torch.float32)]
    for (b, s, di, ds), act, random_a in cases:
        args = scan_inputs(torch, g, b, s, di, ds, act, random_a)
        y, hf = ms.mamba_scan(*args)
        y_ref, h_ref = ms.mamba_scan_plain(*args)
        bf16 = act == torch.bfloat16
        what = (f"mamba_scan {'bf16 xc/b/c' if bf16 else 'f32'}, f32 dt, "
                f"B={b} S={s} di={di} ds={ds}"
                + (", random a_log" if random_a else ""))
        compare("mamba_scan", y, y_ref, BF16_TOL if bf16 else SCAN_TOL,
                what + " y")
        err = float((hf - h_ref).abs().max())
        scale = float(h_ref.abs().max())
        assert hf.dtype == torch.float32 and err <= SCAN_TOL * max(
            scale, 1.0), (what, err, scale)
        log(f"  {what} h_final: max_abs_err={err:.3e} (|h| <= {scale:.3f},"
            f" tol {SCAN_TOL} x max(|h|, 1))")
    # bf16 decode at qwen3-0.6b's heads across the split's edges (drawn
    # last, so that the cases above keep their inputs)
    q = rand((8, 1, 16, 128), torch.bfloat16)
    k, v = (rand((8, 1024, 8, 128), torch.bfloat16) for _ in range(2))
    for lens in BF16_LENS:
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        compare("decode_attention", da.decode_attention(q, k, v, lens),
                da.decode_attention_plain(q, k, v, lens), BF16_TOL,
                f"decode bf16 B=8 S=1024 H=16 KV=8 hd=128 "
                f"kv_len={lens.tolist()}")
    # phase 9's MHA shapes (drawn after every case above): bf16 flash
    # across the q tiles' edges up to the stream's longest prompt, and
    # the bf16 decode mode over 8 slots x 2048 across the split's edges
    for name, heads, hd in NEW_HEADS:
        for sq in FLASH_NEW_SQ:
            q, k, v = (rand((1, sq, heads, hd), torch.bfloat16)
                       for _ in range(3))
            compare("flash_attention", fa.flash_attention(q, k, v),
                    fa.flash_attention_plain(q, k, v), BF16_TOL,
                    f"flash bf16 {name} H=KV={heads} hd={hd} Sq={sq}")
        q = rand((8, 1, heads, hd), torch.bfloat16)
        k, v = (rand((8, 2048, heads, hd), torch.bfloat16)
                for _ in range(2))
        lens = torch.tensor(DECODE_NEW_LENS, dtype=torch.int32, device=dev)
        compare("decode_attention", da.decode_attention(q, k, v, lens),
                da.decode_attention_plain(q, k, v, lens), BF16_TOL,
                f"decode bf16 {name} B=8 S=2048 H=KV={heads} hd={hd} "
                f"kv_len={lens.tolist()}")
    torch.cuda.synchronize()
    return errs


def check_backwards(torch, fa, ms):
    """The two hand-written backwards against their plain versions on
    the same inputs: each gradient within ``BWD_TOLS`` of its own
    largest |grad| -- for flash floored at a tenth of the largest of
    dq, dk, dv, since dq and dk are exactly zero at S=1, where every row
    sees one key -- and a second launch bit-equal to the first.
    Returns the largest absolute error of each over the bf16 cases."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    errs = {"flash_attention_bwd": 0.0, "mamba_scan_bwd": 0.0}

    def compare(name, got, want, names, dtype, what, floor=0.0):
        tol = BWD_TOLS[str(dtype).split(".")[-1]]
        top = floor * max(float(w.float().abs().max()) for w in want)
        worst = []
        for n, x, w in zip(names, got, want):
            assert x.dtype == w.dtype and x.shape == w.shape, (what, n)
            err = float((x.float() - w.float()).abs().max())
            scale = max(float(w.float().abs().max()), top)
            assert err <= tol * scale, (what, n, err, scale)
            # a gradient that is exactly zero (da_log at S=1) is zero here
            worst.append(f"{n} {err / scale if scale else 0.0:.1e}")
            if dtype == torch.bfloat16:
                errs[name] = max(errs[name], err)
        log(f"  {what}: error / max|grad| " + ", ".join(worst)
            + f" (tol {tol})")

    for dtype in (torch.bfloat16, torch.float32):
        for b, s, h, kvh, hd, what in FLASH_BWD_CASES:
            q, do = (torch.randn((b, s, h, hd), generator=g,
                                 device=dev).to(dtype) for _ in range(2))
            k, v = (torch.randn((b, s, kvh, hd), generator=g,
                                device=dev).to(dtype) for _ in range(2))
            o, lse = fa.flash_attention_train_fwd(q, k, v)
            o_p, lse_p = fa.flash_attention_lse_plain(q, k, v)
            assert torch.equal(o, fa.flash_attention(q, k, v)), what
            torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do)
            assert all(torch.equal(x, y) for x, y in zip(got, again)), what
            compare("flash_attention_bwd", got,
                    fa.flash_attention_bwd_plain(q, k, v, o, lse_p, do),
                    ("dq", "dk", "dv"), dtype,
                    f"flash bwd {str(dtype)[6:]} {what} B={b} S={s} H={h} "
                    f"KV={kvh} hd={hd}", floor=0.1)
    fs = FALCON_SCAN
    bf, f32 = "bfloat16", "float32"
    cases = [(fs["b"], fs["s"], fs["di"], fs["ds"], (bf, f32, bf, bf))]
    cases += [(2, s, 300, 8, (f32,) * 4) for s in SCAN_BWD_S]
    cases += list(SCAN_BWD_CASES)
    for b, s, di, ds, names in cases:
        dtypes = [getattr(torch, n) for n in names]
        args = scan_inputs(torch, g, b, s, di, ds, torch.float32,
                           random_a=True)
        args = tuple(t.to(d) for t, d in zip(args[:4], dtypes)) + args[4:]
        act = torch.bfloat16 if bf in names else torch.float32
        dy = torch.randn((b, s, di), generator=g,
                         device=dev).to(dtypes[0])
        dh = torch.randn((b, di, ds), generator=g, device=dev)
        y, hf, hc = ms.mamba_scan_train_fwd(*args)
        y_s, hf_s = ms.mamba_scan(*args)
        assert torch.equal(y, y_s) and torch.equal(hf, hf_s)
        got = ms.mamba_scan_bwd(*args, hc, dy, dh)
        again = ms.mamba_scan_bwd(*args, hc, dy, dh)
        assert all(torch.equal(x, z) for x, z in zip(got, again))
        compare("mamba_scan_bwd", got,
                ms.mamba_scan_bwd_plain(*args, dy, dh),
                ("dxc", "ddt", "db", "dc", "da_log", "dd"), act,
                "mamba_scan bwd xc/dt/b/c " + "/".join(
                    n.replace("float32", "f32").replace("bfloat16", "bf16")
                    for n in names) + f", B={b} S={s} di={di} ds={ds}, "
                "random a_log, dh_final != 0")
    torch.cuda.synchronize()
    return errs


def scan_inputs(torch, g, b, s, di, ds, act_dtype, random_a=False):
    """Selective-scan inputs as the model passes them: xc, b, c in
    ``act_dtype``, dt in f32 (softplus-positive, ~0.07), a_log and d in
    f32 (a_log = log(1..ds) per channel, as the model initialises it; with
    ``random_a``, log(|N(0, 1)| + 0.5) per (channel, state), as trained
    weights have no such structure)."""
    dev = torch.device("cuda")

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev)
    dt = torch.nn.functional.softplus(rand(b, s, di)) * 0.1
    if random_a:
        a_log = torch.log(rand(di, ds).abs() + 0.5)
    else:
        a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                       device=dev)).repeat(di, 1)
    return (rand(b, s, di).to(act_dtype), dt.contiguous(),
            rand(b, s, ds).to(act_dtype), rand(b, s, ds).to(act_dtype),
            a_log.contiguous(), torch.ones(di, device=dev))


def int8_cache(torch, quantize_kv, g, b, s, kvh, hd, **_):
    """A random cache as the model writes it: normal K (or V) quantized
    per token and head (int8 [B,S,KV,hd], bf16 scales [B,S,KV])."""
    x = torch.randn((b, s, kvh, hd), generator=g, device="cuda")
    return quantize_kv(x)


# -- phase 3: timing ----------------------------------------------------------

def time_ms(torch, fn, flush, spin: bool = False, runs: int = TIMING_RUNS,
            warmup: int = 3) -> float:
    """Median milliseconds of one call over ``runs`` runs, CUDA events,
    L2 flushed before each run, after ``warmup`` calls.  With ``spin``, a
    spin kernel of ~0.1 ms ahead of the start event keeps the card busy
    while the host enqueues the call, so the time is the card's alone,
    without the wrapper's host-side launch path; without it, the events
    also enclose whatever part of that enqueue outlasts the flush."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
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


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_backwards(torch, fa, ms):
    """Phase 3 for the two backwards: the flash backward at qwen3-0.6b's
    training shape with ``scaled_dot_product_attention``'s backward on
    the same inputs as a yardstick (never called by the port), and the
    scan backward at falcon-mamba-7b's width, S=1024."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out = {}

    def timed(fn):
        return (time_ms(torch, fn, flush),
                time_ms(torch, fn, flush, spin=True))

    qt = QWEN_TRAIN
    b, s, h, kvh, hd = qt["b"], qt["s"], qt["h"], qt["kvh"], qt["hd"]
    q, do = (torch.randn((b, s, h, hd), generator=g, device=dev).to(bf)
             for _ in range(2))
    k, v = (torch.randn((b, s, kvh, hd), generator=g, device=dev).to(bf)
            for _ in range(2))
    o, lse = fa.flash_attention_train_fwd(q, k, v)
    ms_, dev_ms = timed(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))
    plain = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do), flush)
    ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_out = sdpa(torch, ql, kl, vl, is_causal=True)
    dol = do.transpose(1, 2)
    lib, lib_dev = timed(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), dol, retain_graph=True))
    del lib_out
    pairs = s * (s + 1) // 2
    # S and dP recomputed, dV, dQ, dK: five products of 2 hd FLOPs a
    # (q, k) pair; q, k, v, o, do read, dq, dk, dv written (bf16), lse
    # read (f32)
    b_ms, b_by = bound(5 * 2 * hd * h * pairs * b,
                       2 * (3 * b * s * h * hd + 2 * b * s * kvh * hd)
                       + 2 * (b * s * h * hd + 2 * b * s * kvh * hd)
                       + 4 * b * h * s)
    out["flash_attention_bwd"] = dict(
        ms=ms_, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
        library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by,
        share_of_bound=b_ms / dev_ms, library_ratio=dev_ms / lib_dev,
        shape=f"B={b} S={s} H={h} KV={kvh} hd={hd} bf16 causal (qwen3-0.6b"
        " training); library = the backward of scaled_dot_product_attention"
        " on the same inputs")
    fs = FALCON_SCAN
    b, s, di, ds = fs["b"], fs["s"], fs["di"], fs["ds"]
    args = scan_inputs(torch, g, b, s, di, ds, bf)
    dy = torch.randn((b, s, di), generator=g, device=dev).to(bf)
    _, _, hc = ms.mamba_scan_train_fwd(*args)
    ms_, dev_ms = timed(lambda: ms.mamba_scan_bwd(*args, hc, dy, None))
    plain = time_ms(torch, lambda: ms.mamba_scan_bwd_plain(*args, dy),
                    flush, runs=PLAIN_SCAN_RUNS, warmup=1)
    # read: bf16 xc, b, c, dy; f32 dt, a_log, d and the saved states;
    # written: bf16 dxc, db, dc; f32 ddt, da_log, dd.  The states are
    # counted one every BOUND_STATE_CHUNK steps: that the kernel saves
    # them at a finer interval (ms.STATE_CHUNK) is its own cost, not the
    # function's
    n_states = b * -(-s // BOUND_STATE_CHUNK) * di * ds
    nbytes = (2 * 2 * b * s * di + 4 * b * s * di + 2 * 2 * b * s * ds
              + 2 * (4 * di * ds + 4 * di) + 4 * n_states
              + 2 * b * s * di + 4 * b * s * di + 2 * 2 * b * s * ds)
    t_bytes = nbytes / PEAK_BYTES
    # the gradient needs exp(dt a) once a (step, channel, state); that
    # the kernel takes it twice (it recomputes each chunk's states) is
    # its own cost, not the function's
    t_sfu = b * s * di * ds / SFU_RATE
    bound_ms = max(t_bytes, t_sfu) * 1e3
    out["mamba_scan_bwd"] = dict(
        ms=ms_, device_ms=dev_ms, plain_ms=plain, library_ms=None,
        library_device_ms=None, bound_ms=bound_ms,
        bound_by="operations" if t_sfu >= t_bytes else "bytes",
        share_of_bound=bound_ms / dev_ms, bytes=nbytes, sfu_ms=t_sfu * 1e3,
        partial_bytes=scan_bwd_partial_bytes(ms, b, s, di, ds),
        shuffles_per_element=scan_bwd_shuffles(ms, ds),
        shape=f"B={b} S={s} di={di} ds={ds}, bf16 xc/b/c/dy, f32 dt; "
        "operations = 1 exponential a (step, channel, state) on the "
        "special-function units; no library call computes it")
    gpu = gpu_line()
    for name, r in out.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms (device "
               f"{r['library_device_ms']:.4f} ms; kernel / library device "
               f"{r['library_ratio']:.3f})")
        log(f"  {name} [{r['shape']}] on {gpu}: kernel {r['ms']:.4f} ms "
            f"(device {r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} "
            f"ms, library {lib}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {100 * r['share_of_bound']:.1f}% of it)")
    r = out["mamba_scan_bwd"]
    log(f"  mamba_scan_bwd, worked out from the code: db/dc partials "
        f"{r['partial_bytes']:,} bytes written and read "
        f"({100 * r['partial_bytes'] / nbytes:.1f}% of the function's "
        f"{nbytes:,}), saved states {4 * hc.numel():,} bytes at the "
        f"kernel's {ms.STATE_CHUNK}-step interval "
        f"({4 * n_states:,} counted in the bound), "
        f"{r['shuffles_per_element']:.3f} shuffles a (step, channel, "
        "state)")
    del flush
    return out


def scan_bwd_partial_bytes(ms, b, s, di, ds) -> int:
    """Bytes of the scan backward's partials, each written once and read
    once by scan_bwd_reduce: db and dc, one [B, S, ds] f32 partial a
    cluster of blocks (``BWD_CLUSTER`` blocks of ``BWD_THREADS /
    min(BWD_LANES, ds)`` channels), and da, dd, one [di, ds + 1] a
    sequence."""
    nblk = -(-di // (ms.BWD_THREADS // min(ms.BWD_LANES, ds)))
    n_cl = -(-nblk // ms.BWD_CLUSTER)
    return 2 * 4 * (2 * b * n_cl * s * ds + b * di * (ds + 1))


def scan_bwd_shuffles(ms, ds) -> float:
    """Warp shuffles a (step, channel, state) in the scan backward's sweep:
    per group of 4 steps a lane reduce-scatters its 8 (q1, q2) values over
    the channel's lanes (8 (1 - 1/lanes) shuffles, and one more when that
    leaves one value a lane) and its 8 ds/lanes (db, dc) values over the
    warp's 32/lanes channels (8 ds/lanes (1 - lanes/32)), for 4 ds/lanes
    elements."""
    lanes = min(ms.BWD_LANES, ds)
    states = ds // lanes
    q = 8 * (1 - 1 / lanes) + (1 if lanes == 8 else 0)
    bc = 8 * states * (1 - lanes / 32)
    return (q + bc) / (4 * states)


def time_kernels(torch, fa, da, scan, quantize_kv, prompt_len: int,
                 kv_lens, kv_lens_int8):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out = {}

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    def timed(fn):
        """(ms, device_ms) of fn"""
        return (time_ms(torch, fn, flush),
                time_ms(torch, fn, flush, spin=True))

    def prefill(s, h, kvh, hd):
        """flash at B=1, Sq=Skv=s, bf16, causal"""
        q, k, v = rand(1, s, h, hd), rand(1, s, kvh, hd), rand(1, s, kvh, hd)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms, dev_ms = timed(lambda: fa.flash_attention(q, k, v))
        plain = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v),
                        flush)
        lib, lib_dev = timed(lambda: sdpa(torch, qt, kt, vt, is_causal=True))
        pairs = s * (s + 1) // 2                   # causal (q, k) pairs
        b_ms, b_by = bound(4 * hd * h * pairs, 2 * (2 * s * h * hd
                                                    + 2 * s * kvh * hd))
        return dict(ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
                    library_device_ms=lib_dev, bound_ms=b_ms,
                    bound_by=b_by, shape=f"B=1 Sq=Skv={s} H={h} KV={kvh} "
                    f"hd={hd} bf16 causal")

    # qwen3-0.6b's prefill (the record's main fields); llama-2-7b's last
    out["flash_attention"] = prefill(prompt_len, 16, 8, 128)
    # decode: B=8, S=1024, H=16, KV=8, hd=128, this run's kv_len
    b, s, h, kvh, hd = len(kv_lens), 1024, 16, 8, 128
    q = rand(b, 1, h, hd)
    k, v = rand(b, s, kvh, hd), rand(b, s, kvh, hd)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[
        :, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms, dev_ms = timed(lambda: da.decode_attention(q, k, v, lens))
    plain = time_ms(torch, lambda: da.decode_attention_plain(q, k, v, lens),
                    flush)
    lib, lib_dev = timed(lambda: sdpa(torch, qt, kt, vt, attn_mask=mask))
    valid = sum(min(max(n, 0), s) for n in kv_lens)
    b_ms, b_by = bound(4 * hd * h * valid,
                       2 * (2 * valid * kvh * hd + 2 * b * h * hd) + 4 * b)
    # what device_ms holds beside the bytes: the kernel with one cached
    # position a slot (its fixed cost), and one tiny kernel (the method's
    # own floor)
    ones = torch.ones(b, dtype=torch.int32, device=dev)
    fixed = time_ms(torch, lambda: da.decode_attention(q, k, v, ones), flush,
                    spin=True)
    tiny = torch.empty(1, device=dev)
    floor = time_ms(torch, tiny.zero_, flush, spin=True)
    out["decode_attention"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                                   library_ms=lib, library_device_ms=lib_dev,
                                   bound_ms=b_ms, bound_by=b_by,
                                   fixed_device_ms=fixed,
                                   floor_device_ms=floor,
                                   shape=f"B={b} S={s} H=16 KV=8 hd=128 "
                                   f"bf16 kv_len={kv_lens}")
    # decode, int8 cache: llama-2-7b's shapes, this run's kv_len
    ld = LLAMA_DECODE
    b, s, h, kvh, hd = ld["b"], ld["s"], ld["h"], ld["kvh"], ld["hd"]
    q = rand(b, 1, h, hd)
    (k, ks), (v, vs) = (int8_cache(torch, quantize_kv, g, **ld)
                        for _ in range(2))
    lens = torch.tensor(kv_lens_int8, dtype=torch.int32, device=dev)
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[
        :, None, None, :]
    # the yardstick reads a cache dequantized beforehand (not timed)
    kd = (k.float() * ks.float()[..., None]).to(bf)
    vd = (v.float() * vs.float()[..., None]).to(bf)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kd, vd))
    ms, dev_ms = timed(lambda: da.decode_attention(
        q, k, v, lens, k_scale=ks, v_scale=vs))
    plain = time_ms(torch, lambda: da.decode_attention_plain(
        q, k, v, lens, ks, vs), flush)
    lib, lib_dev = timed(lambda: sdpa(torch, qt, kt, vt, attn_mask=mask))
    valid = sum(min(max(n, 0), s) for n in kv_lens_int8)
    # int8 K and V, bf16 scales of both, bf16 q and out, int32 kv_len
    b_ms, b_by = bound(4 * hd * h * valid,
                       2 * valid * kvh * hd + 2 * 2 * valid * kvh
                       + 2 * 2 * b * h * hd + 4 * b)
    out["decode_attention_int8"] = dict(
        ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
        library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by,
        shape=f"B={b} S={s} H=KV={h} hd={hd} int8 cache bf16 q "
        f"kv_len={kv_lens_int8}; library = sdpa on the pre-dequantized "
        "bf16 cache")
    def scan_timing(s, b=FALCON_SCAN["b"], di=FALCON_SCAN["di"],
                    ds=FALCON_SCAN["ds"]):
        """the selective scan at falcon-mamba-7b's width, S steps"""
        args = scan_inputs(torch, g, b, s, di, ds, bf)
        ms, dev_ms = timed(lambda: scan.mamba_scan(*args))
        plain = time_ms(torch, lambda: scan.mamba_scan_plain(*args), flush,
                        runs=PLAIN_SCAN_RUNS, warmup=1)
        # bf16 xc, b, c and y; f32 dt, a_log, d and h_final
        nbytes = (2 * b * s * di + 4 * b * s * di + 2 * 2 * b * s * ds
                  + 4 * di * ds + 4 * di + 2 * b * s * di + 4 * b * di * ds)
        # per (step, channel, state): dt*a, exp, the state's multiply-add
        # (2), dt*x*B, h*C summed (2); per (step, channel): dt*x, D*x + sum
        b_ms, b_by = bound(b * s * di * (7 * ds + 3), nbytes,
                           PEAK_F32_FLOPS)
        return dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                    library_ms=None, library_device_ms=None, bound_ms=b_ms,
                    bound_by=b_by, bytes=nbytes,
                    shape=f"B={b} S={s} di={di} ds={ds}, bf16 xc/b/c/y, "
                    "f32 dt/a_log/d/h_final; no library call computes a "
                    "selective scan")

    # selective scan: falcon-mamba-7b's prefill of 1024 tokens; its short
    # prompts last
    out["mamba_scan"] = scan_timing(FALCON_SCAN["s"])
    out["flash_attention_llama"] = prefill(**LLAMA_PREFILL)
    out["mamba_scan_short"] = scan_timing(SCAN_SHORT_S)
    for name, r in out.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms (device "
               f"{r['library_device_ms']:.4f} ms)")
        log(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    r = out["decode_attention"]
    log(f"  decode_attention at kv_len=1 in every slot: device "
        f"{r['fixed_device_ms']:.4f} ms; one tiny kernel: device "
        f"{r['floor_device_ms']:.4f} ms")
    del flush
    return out


# -- phase 4: reduced model, card against CPU --------------------------------

# reduced models of every family phase 4 holds on the card against the
# CPU: (arch, what); head_dim 32 wherever a kernel runs
REDUCED_ARCHS = (
    ("qwen3-0.6b", "GQA"), ("falcon-mamba-7b", "Mamba-1"),
    ("deepseek-moe-16b", "MoE, dense first layer"),
    ("minicpm3-4b", "MLA"), ("jamba-v0.1-52b", "Mamba + attention + MoE"),
    ("llama-3.2-vision-11b", "cross-attention, gates 0.5 / -0.3, seeded "
     "vision input"), ("musicgen-medium", "seeded frame embeddings"))
CROSS_GATES = {"gate_attn": 0.5, "gate_ffn": -0.3}


def set_cross_gates(params):
    """Non-zero cross-attention gates (zero at initialisation, where a
    cross layer adds nothing), so that checks exercise those layers."""
    for layer in params["layers"]:
        for name, g in CROSS_GATES.items():
            if name in layer:
                layer[name].fill_(g)


def model_inputs(torch, cfg, dtype, batch, length, gen, device):
    """Seeded inputs of ``length`` positions: ({"tokens" or "embeds"},
    {"vision"} or {}), embeddings in ``dtype``."""
    if cfg.input_mode == "tokens":
        seq = {"tokens": torch.randint(0, cfg.vocab_size, (batch, length),
                                       generator=gen, device=device)}
    else:
        seq = {"embeds": torch.randn((batch, length, cfg.d_model),
                                     generator=gen, device=device).to(dtype)}
    vis = {}
    if cfg.vision_tokens:
        vis["vision"] = torch.randn((batch, cfg.vision_tokens,
                                     cfg.vision_dim), generator=gen,
                                    device=device).to(dtype)
    return seq, vis


def seq_slice(seq, start, stop):
    """Positions ``start:stop`` of the inputs; one token position is
    passed to ``decode_step`` as ``tokens [B]``."""
    (name, x), = seq.items()
    x = x[:, start:stop]
    if name == "tokens" and stop - start == 1:
        x = x[:, 0]
    return {name: x}


def check_reduced_model(torch, get_config, params_lib, model_lib):
    for arch, what in REDUCED_ARCHS:
        over = {} if arch == "falcon-mamba-7b" else {"head_dim": 32}
        cfg = get_config(arch).reduced(**over)
        gen = torch.Generator().manual_seed(0)
        p_cpu = params_lib.init_params(cfg, gen, device="cpu")
        set_cross_gates(p_cpu)
        p_gpu = params_lib.from_reference(_tree_numpy(p_cpu), device="cuda")
        seq, vis = model_inputs(torch, cfg, torch.float32, 2, 41,
                                torch.Generator().manual_seed(1), "cpu")

        def cuda(d):
            return {k: v.cuda() for k, v in d.items()}
        with torch.no_grad():
            first = dict(seq_slice(seq, 0, 37), **vis)
            lc, cc = model_lib.prefill(p_cpu, cfg, cache_len=39, **first)
            lg, cg = model_lib.prefill(p_gpu, cfg, cache_len=39,
                                       **cuda(first))
            pairs = [(lc, lg)]
            for t in range(37, 41):    # the last two run past the cache
                step = seq_slice(seq, t, t + 1)
                lc, cc = model_lib.decode_step(p_cpu, cfg, cc, **step)
                lg, cg = model_lib.decode_step(p_gpu, cfg, cg, **cuda(step))
                pairs.append((lc, lg))
        err = 0.0
        for i, (c, gpu) in enumerate(pairs):
            gpu = gpu.cpu()
            assert gpu.shape == (2, cfg.vocab_size), gpu.shape
            assert torch.isfinite(gpu).all(), f"step {i}: non-finite logits"
            torch.testing.assert_close(gpu, c, rtol=REDUCED_TOL,
                                       atol=REDUCED_TOL)
            err = max(err, float((gpu - c).abs().max()))
        hd = f"hd={cfg.head_dim}, " if over else ""
        log(f"  reduced {arch} ({what}; {hd}f32) prefill 37 + 4 decode: "
            f"card vs CPU max_abs_err={err:.3e} (tol {REDUCED_TOL})")


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_numpy(v) for v in tree]
    return tree.detach().numpy()


# -- phase 5: serve full-width qwen3-0.6b -------------------------------------

def serve(torch, np, m):
    cfg = m.get_config("qwen3-0.6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype) == (
        28, 1024, 16, 8, 128, 3072, 151936, "bfloat16"), cfg
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = m.params_lib.init_params(cfg, gen, device="cuda")
    n_params = m.params_lib.count_tensor_params(params)
    assert n_params == cfg.count_params(), (n_params, cfg.count_params())
    torch.cuda.synchronize()
    log(f"  qwen3-0.6b: {n_params} parameters (bf16) initialised in "
        f"{time.perf_counter() - t0:.2f} s")
    prof = m.profiles.V100_LLAMA2_7B
    args = argparse.Namespace(requests=0)
    finite = []
    step_s = {"prefill": [], "decode": []}

    def engines():
        return timed_engines(torch, m, cfg, params, prof, 1024, step_s,
                             finite)

    # warm-up on throwaway engines (cuBLAS handles, allocator)
    m.serve_mod.serve_engine(args, engines(), [
        m.Request(prompt_tokens=64, decode_tokens=4, rid=10_000 + i)
        for i in range(2)])
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(16):
        if i in (3, 8, 13):     # these run past the 1024-token cache
            p, d = int(rng.integers(990, 1011)), int(rng.integers(40, 65))
        else:
            p, d = int(rng.integers(100, 901)), int(rng.integers(16, 65))
        reqs.append(m.Request(prompt_tokens=p, decode_tokens=d, rid=i))
    assert sum(r.prompt_tokens + r.decode_tokens > 1024 for r in reqs) == 3
    insts = engines()
    finite.clear()
    for v in step_s.values():
        v.clear()
    torch.cuda.synchronize()
    reset_launches(m)
    t0 = time.perf_counter()
    stats = m.serve_mod.serve_engine(args, insts, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(m)
    admissions = sum(i.n_prefills for i in insts)
    iters = sum(i.n_decode_steps for i in insts)
    assert stats["n"] == len(reqs), stats
    assert all(r.decoded == r.decode_tokens for r in reqs)
    assert bool(torch.stack(finite).all()), "non-finite logits"
    assert launches["flash_attention"] == cfg.n_layers * admissions > 0, (
        launches, admissions)
    assert launches["decode_attention"] == cfg.n_layers * iters > 0, (
        launches, iters)
    assert launches["decode_attention_int8"] == launches["mamba_scan"] \
        == 0, launches
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
    device = profile_decode(torch, insts[0], dec_ms,
                            ("decode_attention", "dec_split"))
    return launches, dict(wall_s=wall, output_tokens=out_tok,
                          admissions=admissions, decode_iterations=iters,
                          prefill_median_ms=pre_ms,
                          prompt_mean=statistics.mean(
                              r.prompt_tokens for r in reqs),
                          decode_step_median_ms=dec_ms,
                          in_model_s=in_model, stats=stats,
                          decode_profile=device), (cfg, params)


def timed_engines(torch, m, cfg, params, prof, cache_len, step_s, finite,
                  n=2, n_slots=8):
    """``n`` engines whose model passes are timed on the host clock
    (synchronised) into ``step_s`` and whose logits are checked for
    shape and collected for a finiteness check in ``finite``."""
    insts = [m.LLMInstance(cfg, params, prof, m.get_scheduler("fcfs"),
                           n_slots=n_slots, cache_len=cache_len,
                           instance_id=i, device="cuda") for i in range(n)]
    for inst in insts:
        pre, dec = inst.prefill_fn, inst.decode_fn

        # host clock around each model pass; the engine waits for the
        # logits right after each pass anyway
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
            assert logits.shape == (n_slots, cfg.vocab_size)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        inst.prefill_fn, inst.decode_fn = prefill, decode
    return insts


def profile_pass(torch, run, wall_ms: float, what: str, steps: int = 5,
                 kernel=None, grad: bool = False):
    """Device time of a model pass, by kernel, from torch.profiler over
    ``steps`` calls of ``run`` (after one warm call), against a wall time
    ``wall_ms`` of the same pass taken without the profiler (whose own
    start-up makes a wall clock under it useless).  ``kernel`` = (name,
    a substring of its CUDA function's name) reports that kernel's
    share.  ``grad``: run with autograd on (a train step)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.set_grad_enabled(grad):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                run()
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
    busy = sum(r[1] for r in rows) / steps / 1e3            # ms per pass
    kernels = sum(r[2] for r in rows) / steps
    out = dict(device_busy_ms=busy, idle_share=1 - busy / wall_ms,
               kernels_per_pass=kernels)
    share = ""
    if kernel is not None:
        name, tag = kernel
        k_ms = sum(r[1] for r in rows if tag in r[0]) / steps / 1e3
        out[name + "_ms"] = k_ms
        share = f", {name} {k_ms:.3f} ms ({k_ms / busy:.1%} of device time)"
    log(f"  profiled {what}: device busy {busy:.3f} ms of {wall_ms:.2f} ms "
        f"wall (idle {1 - busy / wall_ms:.1%}){share}, {kernels:.0f} "
        "kernels")
    top = sorted(rows, key=lambda r: -r[1])[:6]
    for key, t, n in top:
        log(f"    {t / steps / 1e3:8.3f} ms/pass  {n // steps:5d}x  "
            f"{key[:70]}")
    out["top_kernels"] = [(key[:70], t / steps / 1e3, n // steps)
                          for key, t, n in top]
    return out


def profile_decode(torch, inst, step_ms: float, kernel=None):
    """The engine's gang decode step on a served engine's cache (after
    the counted run), against the served run's median step wall."""
    toks = torch.zeros(inst.n_slots, dtype=torch.long, device="cuda")
    return profile_pass(
        torch, lambda: inst.decode_fn(inst.params, cache=inst.cache,
                                      tokens=toks),
        step_ms, f"decode step (B={inst.n_slots})", kernel=kernel)


def profile_prefill(torch, inst, prompt: int, kernel=None):
    """One batch-1 prefill of ``prompt`` tokens into slot 0 of a served
    engine's cache (after the counted run), against its own wall time
    (synchronised, without the profiler)."""
    toks = torch.randint(0, inst.cfg.vocab_size, (1, prompt),
                         generator=torch.Generator().manual_seed(0)).cuda()

    def run():
        return inst.prefill_fn(inst.params, tokens=toks, cache=inst.cache,
                               slot=0)
    with torch.no_grad():
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = profile_pass(torch, run, wall_ms, f"prefill ({prompt} tokens)",
                       steps=1, kernel=kernel)
    out.update(prompt_tokens=prompt, wall_ms=wall_ms)
    return out


# -- phase 5b: the router's learning path -------------------------------------

# the reference CLI's router run: --instances 4 --requests 400 --rate 2.5
# and its default --train-episodes
ROUTER_ARGS = ["--instances", "4", "--requests", "400", "--rate", "2.5",
               "--train-episodes", "8"]
ROUTER_Q_STATES = 256


def _median_ms(xs):
    return statistics.median(xs) * 1e3 if xs else float("nan")


def train_predictor(torch, np, m, prof):
    """``quick_bucket_predictor`` on the card, its train steps timed
    (synchronised), then its accuracy, the 16-row micro-batch forward
    and its logits against a CPU copy."""
    pred_lib, wl = m.pred_lib, m.wl
    cfg = pred_lib.PredictorConfig()
    step_s, losses = [], []
    orig = pred_lib._train_step

    def timed_step(*a, **kw):
        t = time.perf_counter()
        loss = orig(*a, **kw)
        losses.append(float(loss))               # synchronises
        step_s.append(time.perf_counter() - t)
        return loss
    pred_lib._train_step = timed_step
    try:
        t0 = time.perf_counter()
        pred = pred_lib.quick_bucket_predictor(prof, n_train=2000,
                                               epochs=2)
        train_s = time.perf_counter() - t0
    finally:
        pred_lib._train_step = orig
    per_epoch = len(step_s) // 2
    epoch_loss = [losses[per_epoch - 1], losses[-1]]
    acc = pred.accuracy(wl.generate(1000, seed=1234))
    fresh = wl.generate(16 * 21, seed=77)
    fwd_s = []
    for i in range(21):
        svc = m.MicroBatchPredictor(pred)
        chunk = fresh[16 * i:16 * (i + 1)]
        reqs = wl.to_requests(chunk, rate=1.0, seed=i)
        t = time.perf_counter()
        svc.prefetch(list(zip(reqs, chunk)))     # ends in a device->host copy
        fwd_s.append(time.perf_counter() - t)
        assert (svc.forwards, svc.misses) == (1, 16), svc.forwards
    cpu = pred_lib.BucketPredictor(cfg, prof, device="cpu")
    cpu.params.load_reference(pred.params.reference_tree())
    samples = wl.generate(512, seed=4321)
    lg, lc = pred.logits(samples), cpu.logits(samples)
    err = float(np.abs(lg - lc).max())
    assert np.isfinite(lg).all() and err <= PRED_TOL, err
    # a bucket is decided wherever the top-two logit gap exceeds twice
    # the error; there the card and the CPU must agree
    top2 = np.sort(lc, -1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * err
    same = lg.argmax(-1) == lc.argmax(-1)
    assert same[decided].all(), np.flatnonzero(~same & decided)
    res = dict(train_s=train_s, steps=len(step_s), epoch_loss=epoch_loss,
               accuracy=acc, train_step_median_ms=_median_ms(step_s),
               forward16_median_ms=_median_ms(fwd_s[1:]),
               logits_max_abs_err=err, buckets_equal=int(same.sum()),
               undecided=int((~decided).sum()))
    log(f"  predictor (seq 64, d 64, 4 heads, 2 layers, 8 buckets): "
        f"{len(step_s)} train steps of 128 in {train_s:.3f} s, loss per "
        f"epoch {epoch_loss[0]:.4f} / {epoch_loss[1]:.4f}; accuracy "
        f"{acc:.3f} on 1000 fresh samples; train step median "
        f"{res['train_step_median_ms']:.3f} ms, 16-row micro-batch "
        f"forward median {res['forward16_median_ms']:.3f} ms "
        "(host clock, synchronised)")
    log(f"  predictor logits, card vs CPU on 512 prompts: max abs err "
        f"{err:.3e} (tol {PRED_TOL}); buckets equal in {int(same.sum())}"
        f" of 512 ({int((~decided).sum())} within 2x the error of a tie)")
    return pred, res


def train_router(torch, np, m, prof):
    """``_train_quick_agent`` on the card: acts and learn steps timed,
    per-episode lines, and Q of 256 recorded states on a CPU copy."""
    args = m.serve_mod.build_parser().parse_args(
        ["--mode", "sim"] + ROUTER_ARGS)
    rcfg = m.serve_mod._router_cfg(args)
    agent = m.rl.make_agent(rcfg, device="cuda")
    act_s, learn_s, states = [], [], []
    act_batch, learn = agent.act_batch, agent.learn

    def timed_act_batch(s, masks, **kw):
        t = time.perf_counter()
        a = act_batch(s, masks, **kw)            # ends in a .cpu() copy
        act_s.append(time.perf_counter() - t)
        states.append(np.asarray(s[0], np.float32))
        return a

    def timed_learn(sync=True):
        before = agent.steps
        t = time.perf_counter()
        out = learn(sync)                        # reads the loss back
        if agent.steps > before:
            learn_s.append(time.perf_counter() - t)
        return out
    agent.act_batch, agent.learn = timed_act_batch, timed_learn
    t0 = time.perf_counter()
    try:
        out = m.serve_mod._train_quick_agent(args, rcfg, prof, agent=agent)
    finally:
        del agent.act_batch, agent.learn
    wall = time.perf_counter() - t0
    assert out["agent"] is agent
    hist = out["history"]
    for h in hist:
        assert h["n"] == 400, h
        log(f"  episode {h['episode']}: ticks {h['ticks']}, e2e_mean "
            f"{h['e2e_mean']:.3f} s, reward {h['reward']:.1f}, epsilon "
            f"{h['epsilon']:.3f} (virtual clock, the router's model)")
    decisions = sum(h["ticks"] for h in hist)
    assert agent.steps == len(learn_s) > 0, (agent.steps, len(learn_s))
    idx = np.linspace(0, len(states) - 1, ROUTER_Q_STATES).astype(int)
    batch = np.stack([states[i] for i in idx])
    q_card = m.dqn.q_values(agent.params, batch)
    cpu = m.dqn.DQNAgent(agent.cfg, device="cpu")
    cpu.from_reference(agent.params.reference_tree())
    q_cpu = m.dqn.q_values(cpu.params, batch)
    err = float(np.abs(q_card - q_cpu).max())
    scale = float(np.abs(q_cpu).max())
    assert np.isfinite(q_card).all() and err <= Q_TOL * max(scale, 1.0), (
        err, scale)
    res = dict(episodes=len(hist), decisions=decisions, wall_s=wall,
               decisions_per_s=decisions / wall, learn_steps=agent.steps,
               greedy_acts=len(act_s), act_median_ms=_median_ms(act_s),
               learn_median_ms=_median_ms(learn_s),
               learn_total_s=sum(learn_s), act_total_s=sum(act_s),
               q_max_abs_err=err, q_scale=scale,
               history=[{k: h[k] for k in ("episode", "ticks", "e2e_mean",
                                           "reward", "epsilon")}
                        for h in hist])
    log(f"  router: {len(hist)} episodes, {decisions} decisions, "
        f"{agent.steps} learn steps (batch {agent.cfg.batch_size}) in "
        f"{wall:.3f} s wall: {decisions / wall:.1f} decisions/s; greedy "
        f"act median {res['act_median_ms']:.3f} ms ({len(act_s)} acts, "
        f"{sum(act_s):.3f} s), learn step median "
        f"{res['learn_median_ms']:.3f} ms ({sum(learn_s):.3f} s); host "
        "clock, synchronised")
    log(f"  router Q on {ROUTER_Q_STATES} recorded states, card vs CPU: "
        f"max abs err {err:.3e} (|Q| <= {scale:.3f}, tol {Q_TOL} x "
        "max(|Q|, 1))")
    return args, rcfg, agent, res, batch


def profile_router(torch, np, m, pred, agent, states, pred_res, router_res):
    """Device busy and idle share of the path's four host-bound steps,
    each against its median wall from the timed runs: a predictor train
    step (B=128), a 16-row predictor forward, a greedy act, a learn step
    (after the checkpoint, so the extra steps change nothing saved)."""
    cfg = pred.cfg
    samples = m.wl.generate(144, seed=99)
    tok = torch.from_numpy(np.stack([m.pred_lib.encode_sample(cfg, s)
                                     for s in samples[:128]])).long()
    tok = tok.to(pred.device)
    lab = torch.tensor([pred.label(s) for s in samples[:128]],
                       device=pred.device)
    mask = np.ones(agent.cfg.n_actions, bool)

    def train_step():
        with torch.enable_grad():
            m.pred_lib._train_step(pred.params, pred.opt, cfg, tok, lab)

    def learn():
        with torch.enable_grad():
            agent.learn()
    out = {}
    for name, run, wall in (
            ("predictor_train_step", train_step,
             pred_res["train_step_median_ms"]),
            ("predictor_forward16", lambda: pred.logits(samples[128:],
                                                        chunk=16),
             pred_res["forward16_median_ms"]),
            ("act", lambda: agent.act_batch(states[:1], mask[None]),
             router_res["act_median_ms"]),
            ("learn_step", learn, router_res["learn_median_ms"])):
        out[name] = profile_pass(torch, run, wall, name)
    return out


def router_phase(torch, np, m):
    """Phase 5b: train the predictor and the router on the card, write
    and restore the router's checkpoint, serve over the simulator.
    Returns the launch counts, the results and the checkpoint
    directory phases 6 and 7 restore from."""
    prof = m.profiles.V100_LLAMA2_7B
    build = os.path.join(ROOT, "build")
    ckpt_dir = os.path.join(build, "router_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    reset_launches(m)
    t_phase = time.perf_counter()
    pred, pred_res = train_predictor(torch, np, m, prof)
    args, rcfg, agent, router_res, states = train_router(torch, np, m,
                                                         prof)
    mgr = m.CheckpointManager(ckpt_dir)
    try:
        t0 = time.perf_counter()
        mgr.save(router_res["episodes"], agent.state_dict(), sync=True)
        save_ms = (time.perf_counter() - t0) * 1e3
    finally:
        mgr.close()
    t0 = time.perf_counter()
    policy = m.restore_rl_policy(rcfg, ckpt_dir, m=4)
    restore_ms = (time.perf_counter() - t0) * 1e3
    saved = m.flatten_tree(agent.state_dict())
    got = m.flatten_tree(policy.agent.state_dict())
    assert list(got) == list(saved)
    assert all(got[k].dtype == v.dtype and got[k].shape == v.shape
               and got[k].tobytes() == v.tobytes() for k, v in saved.items())
    assert policy.agent.opt["step"].dtype == torch.int32
    nbytes = sum(os.path.getsize(os.path.join(ckpt_dir, p))
                 for p in os.listdir(ckpt_dir) if p.startswith("step_"))
    log(f"  checkpoint: {len(saved)} leaves ({nbytes} bytes) saved in "
        f"{save_ms:.1f} ms, restored through restore_rl_policy in "
        f"{restore_ms:.1f} ms; every leaf bit-equal")
    profiles = profile_router(torch, np, m, pred, agent, states, pred_res,
                              router_res)
    t0 = time.perf_counter()
    sim_args = m.serve_mod.build_parser().parse_args(
        ["--mode", "sim"] + ROUTER_ARGS)
    sim = m.serve_mod.serve_sim(sim_args, agent=policy.agent)
    sim_wall = time.perf_counter() - t0
    assert sim["n"] == 400, sim
    log(f"  serve_sim: {sim['n']} served in {sim_wall:.3f} s wall; "
        f"e2e_mean {sim['e2e_mean']:.3f} s, ttft_mean "
        f"{sim['ttft_mean']:.3f} s (virtual clock, the router's model)")
    gateway = {}
    for name in ("rl", "mixing"):
        trace = os.path.join(build, f"router_gateway_{name}_trace.json")
        metrics = os.path.join(build, f"router_gateway_{name}_metrics.json")
        argv = (["--mode", "gateway", "--backend", "py", "--policy", name,
                 "--trace", trace, "--metrics-out", metrics] + ROUTER_ARGS
                + (["--checkpoint", ckpt_dir] if name == "rl" else []))
        t0 = time.perf_counter()
        stats = m.serve_mod.serve_gateway(
            m.serve_mod.build_parser().parse_args(argv))
        wall = time.perf_counter() - t0
        with open(trace) as f:
            doc = json.load(f)
        errs = m.obs.validate_chrome_trace(doc)
        assert not errs, errs[:5]
        assert stats["n"] + stats["shed"] == 400, stats
        snap = stats["snapshot"]
        pct = {k: (snap[k]["p50"], snap[k]["p95"]) for k in ("e2e", "ttft")}
        gateway[name] = dict(
            served=stats["n"], admitted=stats["admitted"],
            shed=stats["shed"], preemptions=stats["preemptions"],
            wall_s=wall, virtual_percentiles=pct,
            predictor=stats["predictor"],
            trace_events=len(doc["traceEvents"]))
        log(f"  [{name}] gateway over the py simulator: served "
            f"{stats['n']}, admitted {stats['admitted']}, shed "
            f"{stats['shed']}, preemptions {stats['preemptions']}; "
            f"predictor hits/misses/forwards {stats['predictor']['hits']}/"
            f"{stats['predictor']['misses']}/"
            f"{stats['predictor']['forwards']}; {wall:.3f} s wall "
            f"(predictor training included); {len(doc['traceEvents'])} "
            "trace events, valid")
        log(f"  [{name}] virtual clock (profile {prof.name}, the router's "
            "model of the hardware, not the card): " + ", ".join(
                f"{k} p50/p95 {a:.3f}/{b:.3f} s" for k, (a, b)
                in pct.items()))
    torch.cuda.synchronize()
    launches = read_launches(m)
    phase_s = time.perf_counter() - t_phase
    assert not any(launches.values()), launches
    log(f"  router phase {phase_s:.1f} s; launches {launches}")
    return launches, dict(predictor=pred_res, router=router_res,
                          checkpoint=dict(leaves=len(saved), bytes=nbytes,
                                          save_ms=save_ms,
                                          restore_ms=restore_ms),
                          serve_sim=dict(wall_s=sim_wall, n=sim["n"],
                                         e2e_mean=sim["e2e_mean"],
                                         ttft_mean=sim["ttft_mean"]),
                          profiles=profiles, gateway=gateway,
                          phase_s=phase_s), ckpt_dir


# -- phase 5c: the router's scale-up -----------------------------------------

# benchmarks/bench_batched_rl.py's schedule: V100 x 4, the Table-1 mixture,
# 200 requests at 20/s, 16 episodes, 8 environments for the batched runs
SCALE = dict(n=200, rate=20.0, m=4, episodes=16, n_envs=8)
# examples/train_router_rl.py --hetero: the scenario stream, 400 requests
# an episode, clusters up to 6 wide
HETERO = dict(n=400, m_max=6)
# benchmarks/bench_online_drift.py's scales: stream requests and rate,
# offline episodes and requests per episode of the warm start.  The paper
# scale took 177 s on an H100 (the online arm 124 s of it), past the 150 s
# this part may take, so the script runs the smoke scale
DRIFT_SCALES = {"paper": (1600, 3.5, 14, 400), "smoke": (500, 3.0, 5, 220)}
DRIFT_SCALE = "smoke"
DRIFT_SEED = 23
TIMED_CALLS = 30
HETERO_Q_STATES = 512
EVAL_SEEDS = (991, 992)      # bench_batched_rl's held-out episodes


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _scale_cfg(m, explore):
    return m.rl.RouterConfig(variant="guided", n_instances=SCALE["m"],
                             explore_episodes=explore, q_arch="decomposed",
                             seed=0)


def _run_line(name, hist, wall, steps):
    decisions = sum(h["ticks"] for h in hist)
    e2e = [h["e2e_mean"] for h in hist]
    log(f"  [{name}] {len(hist)} episodes, {decisions} decisions, {steps} "
        f"learn steps in {wall:.3f} s wall: {decisions / wall:.1f} "
        f"decisions/s; e2e_mean over episodes {statistics.mean(e2e):.3f} s"
        f", last 4 {statistics.mean(e2e[-4:]):.3f} s (virtual clock)")
    return dict(episodes=len(hist), decisions=decisions, wall_s=wall,
                decisions_per_s=decisions / wall, learn_steps=steps,
                e2e_mean=statistics.mean(e2e),
                e2e_mean_last4=statistics.mean(e2e[-4:]),
                ticks=[h["ticks"] for h in hist])


def scale_up_throughput(torch, np, m):
    """Part (a): the reference bench's schedule three ways on the card --
    sequential ``rl.train``, ``train_router`` batched over the ``py``
    stepper and over the ``vec`` pool -- then one ``act_batch`` of 8
    rows and one learn step of 256 rows, timed and profiled."""
    prof, wl = m.profiles.V100_LLAMA2_7B, m.wl

    def reqs(seed):
        return wl.to_requests(wl.generate(SCALE["n"], seed=seed),
                              rate=SCALE["rate"], seed=seed + 5000)

    def scenario(ep):
        return wl.Scenario.homogeneous(prof, SCALE["m"], reqs(100 + ep),
                                       name=f"paper-{ep}")
    cfg = _scale_cfg(m, explore=8)
    res = {}
    agent = m.rl.make_agent(cfg, device="cuda")
    out, wall = _timed(torch, lambda: m.rl.train(
        cfg, prof, lambda ep: reqs(100 + ep), SCALE["episodes"],
        agent=agent))
    res["sequential"] = _run_line("sequential rl.train", out["history"],
                                  wall, agent.steps)
    acts, learn_host = {}, {}
    for backend in ("py", "vec"):
        agent = m.rl.make_agent(cfg, device="cuda")
        act_batch, learn = agent.act_batch, agent.learn
        host = []

        def rec_act(states, masks, _f=act_batch, _b=backend, **kw):
            if len(states) == SCALE["n_envs"] and _b not in acts:
                acts[_b] = (np.array(states), np.array(masks), kw)
            return _f(states, masks, **kw)

        def rec_learn(sync=True, _f=learn, _h=host, _a=agent):
            before = _a.steps
            t = time.perf_counter()
            out = _f(sync)                        # queued, no read-back
            if _a.steps > before:
                _h.append(time.perf_counter() - t)
            return out
        agent.act_batch, agent.learn = rec_act, rec_learn
        bcfg = m.batched_rl.BatchedRLConfig(
            n_envs=SCALE["n_envs"], m_max=SCALE["m"], backend=backend)
        try:
            out, wall = _timed(torch, lambda: m.train_router(
                cfg, scenario, SCALE["episodes"], batch_cfg=bcfg,
                agent=agent))
        finally:
            del agent.act_batch, agent.learn
        assert all(h["n"] == SCALE["n"] for h in out["history"])
        name = f"batched_{backend}"
        res[name] = _run_line(f"train_router, {SCALE['n_envs']} envs, "
                              f"{backend}", out["history"], wall,
                              agent.steps)
        learn_host[backend] = host
        res[name].update(learn_host_total_s=sum(host),
                         learn_host_median_ms=_median_ms(host))
        log(f"  [{name}] learn calls on the host (queued, no read-back): "
            f"{len(host)} in {sum(host):.3f} s, median "
            f"{_median_ms(host):.3f} ms")
    seq = res["sequential"]["decisions_per_s"]
    for backend in ("py", "vec"):
        r = res[f"batched_{backend}"]
        r["vs_sequential"] = r["decisions_per_s"] / seq
        log(f"  batched {backend} / sequential decisions/s: "
            f"{r['vs_sequential']:.2f}x (one call, one card)")
    res["py_vec_same_ticks"] = (res["batched_py"]["ticks"]
                                == res["batched_vec"]["ticks"])
    # the bench's quality check: the vec-trained router greedy on its
    # held-out episodes, beside round robin and the impact heuristic
    # (mixing) on the same streams
    held = {"rl_batched": statistics.mean(
        m.batched_rl.evaluate_scenarios(cfg, agent, [wl.Scenario.homogeneous(
            prof, SCALE["m"], reqs(sd))])[0]["e2e_mean"]
        for sd in EVAL_SEEDS)}
    for name in ("round_robin", "impact_greedy"):
        held[name] = statistics.mean(m.sim.run_heuristic(
            m.sim.Cluster(prof, SCALE["m"]), reqs(sd),
            m.legacy.make_policy(name, prof))["e2e_mean"]
            for sd in EVAL_SEEDS)
    res["held_out_e2e_mean"] = held
    log("  held-out e2e_mean over seeds " + str(EVAL_SEEDS) + ": " + ", ".join(
        f"{k} {v:.3f} s" for k, v in held.items()) + " (virtual clock)")
    # the vec run's agent: one act over 8 rows, one learn step of 256
    states, masks, kw = acts["vec"]
    act_s, step_s = [], []
    for _ in range(TIMED_CALLS):
        t = time.perf_counter()
        agent.act_batch(states, masks, **kw)     # ends in a .cpu() copy
        act_s.append(time.perf_counter() - t)
    steps0 = agent.steps
    for _ in range(TIMED_CALLS):
        t = time.perf_counter()
        agent.learn()                            # reads the loss back
        step_s.append(time.perf_counter() - t)
    assert agent.cfg.batch_size == 256
    assert agent.steps == steps0 + TIMED_CALLS, agent.steps
    res["act8_median_ms"] = _median_ms(act_s)
    res["learn256_median_ms"] = _median_ms(step_s)
    log(f"  act_batch over 8 rows median {res['act8_median_ms']:.3f} ms, "
        f"learn step (batch 256, loss read back) median "
        f"{res['learn256_median_ms']:.3f} ms (host clock, synchronised)")

    def learn_step():
        with torch.enable_grad():
            agent.learn()
    res["profiles"] = {
        "act_batch8": profile_pass(
            torch, lambda: agent.act_batch(states, masks, **kw),
            res["act8_median_ms"], "act_batch (8 rows)"),
        "learn256": profile_pass(torch, learn_step,
                                 res["learn256_median_ms"],
                                 "learn step (batch 256)")}
    return res


def scale_up_hetero(torch, np, m):
    """Part (b): ``train_router`` over the heterogeneous scenario stream
    on the ``vec`` pool (clusters up to 6 wide), and the trained Q on the
    card against the CPU over states recorded in the run."""
    cfg = _scale_cfg(m, explore=max(SCALE["episodes"] - 4, 2))
    agent = m.rl.make_agent(cfg, m=HETERO["m_max"], device="cuda")
    act_batch = agent.act_batch
    recorded = []

    def rec_act(states, masks, prior=None, q_squash=0.0, **kw):
        a = act_batch(states, masks, prior=prior, q_squash=q_squash, **kw)
        for i in np.flatnonzero(masks.any(1)):
            recorded.append((np.array(states[i]), np.array(masks[i]),
                             None if prior is None else np.array(prior[i]),
                             q_squash))
        return a
    agent.act_batch = rec_act
    try:
        out, wall = _timed(torch, lambda: m.train_router(
            cfg, m.wl.scenario_stream(0, n_requests=HETERO["n"]),
            SCALE["episodes"], batch_cfg=m.batched_rl.BatchedRLConfig(
                m_max=HETERO["m_max"], backend="vec"), agent=agent))
    finally:
        del agent.act_batch
    hist = out["history"]
    assert all(h["n"] == HETERO["n"] for h in hist), hist
    res = _run_line("hetero stream, vec", hist, wall, agent.steps)
    res["widths"] = sorted({h["m"] for h in hist})
    # the trained network's own greedy actions on the recorded inputs, so
    # that the CPU copy is held to the card's decisions, not to training's
    idx = np.linspace(0, len(recorded) - 1,
                      min(HETERO_Q_STATES, len(recorded))).astype(int)
    rows = [recorded[i][:4] for i in idx]
    rows = [r + (agent.act(r[0], r[1], prior=r[2], q_squash=r[3]),)
            for r in rows]
    res["q_check"] = check_q_on_cpu(torch, np, m, agent, rows)
    return res


def _serve_drift(m, np, scn, policy):
    """bench_online_drift's arm: the drift stream through a gateway over
    the ``vec`` pool with its chaos, failover, oracle lengths and a
    breaker that does not mask the straggler."""
    reqs = [m.Request(prompt_tokens=r.prompt_tokens,
                      decode_tokens=r.decode_tokens, arrival=r.arrival,
                      task=r.task, tenant=r.tenant) for r in scn.requests]
    gcfg = m.GatewayConfig(chaos=scn.meta["chaos"], failover=True,
                           max_retries=3, max_time=7200.0,
                           breaker_factor=50.0, backend="vec")
    gw = m.Gateway(gcfg, scn.profiles, policy, length=m.OracleLength())
    t0 = time.perf_counter()
    stats = gw.run(reqs)
    wall = time.perf_counter() - t0
    done = [r for r in reqs if r.finished is not None]
    flip = scn.meta["flip_time"]

    def p95(vals):
        return float(np.quantile(np.asarray(vals, float), 0.95))
    assert stats["n"] + stats["shed"] + stats["cancelled"] == len(reqs)
    return dict(served=stats["n"], wall_s=wall,
                p95_e2e=p95([r.e2e for r in done]),
                postflip_p95_e2e=p95([r.e2e for r in done
                                      if r.arrival >= flip]))


def scale_up_online(torch, np, m):
    """Part (c): bench_online_drift at ``DRIFT_SCALE`` -- a warm start
    trained offline on the pre-flip mix, then the drift stream served
    frozen, online (learning on the card) and by mixing."""
    n_req, rate, episodes, ep_req = DRIFT_SCALES[DRIFT_SCALE]
    prof, wl = m.profiles.V100_LLAMA2_7B, m.wl
    rcfg = m.rl.RouterConfig(variant="guided", n_instances=4,
                             q_arch="decomposed", seed=0,
                             include_health_features=True)
    scn = wl.make_drift_scenario(seed=DRIFT_SEED, n_requests=n_req,
                                 rate=rate, profiles=(prof,) * 4,
                                 straggler_factor=4.0)
    ckpt = os.path.join(ROOT, "build", "online_warm")
    shutil.rmtree(ckpt, ignore_errors=True)

    def stream(ep):
        return wl.make_tenant_scenario(
            seed=1000 + ep, tenants=wl.DRIFT_PRE_TENANTS, n_requests=ep_req,
            rate=rate, pattern="poisson", profiles=(prof,) * 4).requests
    out, pre_wall = _timed(torch, lambda: m.rl.train(rcfg, prof, stream,
                                                     n_episodes=episodes))
    m.save_learner(ckpt, step=episodes, agent=out["agent"])
    log(f"  warm start: {episodes} offline episodes of {ep_req} requests "
        f"on the pre-flip mix in {pre_wall:.3f} s, "
        f"{out['agent'].steps} learn steps; full learner checkpointed")
    res = dict(scale=DRIFT_SCALE, n_requests=n_req, rate=rate,
               pretrain_s=pre_wall)
    frozen = m.rl.make_agent(rcfg, device="cuda")
    assert m.restore_learner(ckpt, frozen) == episodes
    res["frozen"] = _serve_drift(m, np, scn, m.RLPolicy(frozen, rcfg))
    trainer = m.OnlineTrainer(rcfg, m.OnlineConfig(
        warm_start=ckpt, eps=0.03, guard=True, guard_window=48,
        guard_regret=0.12, guard_cooldown=20.0, seed=0))
    assert trainer.warm_started_step == episodes
    steps0 = trainer.agent.steps
    res["online"] = _serve_drift(m, np, scn, trainer.policy)
    tel = trainer.telemetry()
    res["online"].update(
        learner_steps=trainer.agent.steps - steps0,
        publishes=int(tel["publishes"]),
        fallback_entries=int(tel["fallback_entries"]),
        transitions=int(tel["transitions"]), explored=int(tel["explored"]))
    res["mixing"] = _serve_drift(m, np, scn, m.make_gateway_policy(
        "mixing", rcfg))
    for arm in ("frozen", "online", "mixing"):
        r = res[arm]
        log(f"  [{arm}] served {r['served']} of {n_req} in "
            f"{r['wall_s']:.3f} s wall; P95 E2E {r['p95_e2e']:.3f} s, "
            f"after the flip {r['postflip_p95_e2e']:.3f} s (virtual clock)")
    o = res["online"]
    res["online_ms_per_request"] = ((o["wall_s"] - res["frozen"]["wall_s"])
                                    / o["served"] * 1e3)
    log(f"  [online] {o['learner_steps']} learner steps, {o['publishes']} "
        f"publishes, {o['fallback_entries']} fallback entries, "
        f"{o['transitions']} transitions, {o['explored']} explored; the "
        f"learner's cost over the frozen arm "
        f"{res['online_ms_per_request']:.3f} ms wall per served request")
    return res


def scale_up_phase(torch, np, m):
    """Phase 5c: parts (a)-(c), each path's launch counts reset before it
    and read after it (no kernel of the port runs on this path)."""
    out, launches = {}, {}
    for name, part in (("batched", scale_up_throughput),
                       ("hetero", scale_up_hetero),
                       ("online", scale_up_online)):
        torch.cuda.synchronize()
        reset_launches(m)
        t0 = time.perf_counter()
        out[name] = part(torch, np, m)
        torch.cuda.synchronize()
        launches[name] = read_launches(m)
        out[name]["part_s"] = time.perf_counter() - t0
        assert not any(launches[name].values()), launches
        log(f"  part {name}: {out[name]['part_s']:.1f} s; launches "
            f"{launches[name]}")
    return launches, out


# -- phases 6 and 7: the gateway over full-width engines ---------------------

GATEWAY_RATE = 1.0           # arrivals per second of the virtual clock
# the gateway streams of phases 6 (llama-2-7b, rl and mixing), 7 and 9
# (falcon-mamba-7b, deepseek-moe-16b, minicpm3-4b), cut from 24 and 16 to
# keep the script inside its 1200 s: their walls are host-bound, and on
# a slow host phase 6 alone took 204 s at 24 requests
GATEWAY_REQUESTS = 12
FAMILY_REQUESTS = 8


def gateway_stream(np, Request, n, max_out, seed, rid0):
    """One seeded stream: prompts 100-1500 tokens, outputs 16-``max_out``,
    Poisson arrivals; explicit rids so every policy's engines draw the
    same prompt tokens."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(100, 1501, n)
    outputs = rng.integers(16, max_out + 1, n)
    arrivals = np.cumsum(rng.exponential(1 / GATEWAY_RATE, n))
    return [Request(prompt_tokens=int(p), decode_tokens=int(d),
                    arrival=float(a), tenant="chat", rid=rid0 + i)
            for i, (p, d, a) in enumerate(zip(prompts, outputs, arrivals))]


def init_full_width(torch, m, cfg, name: str, what: str):
    """Seeded random bf16 weights on the card, counted against the
    config's analytic count."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = m.params_lib.init_params(cfg, gen, device="cuda")
    n_params = m.params_lib.count_tensor_params(params)
    assert n_params == cfg.count_params(), (n_params, cfg.count_params())
    torch.cuda.synchronize()
    log(f"  {name}: {n_params} parameters (bf16, {n_params * 2 / 1e9:.2f} "
        f"GB) initialised in {time.perf_counter() - t0:.2f} s; {what}")
    return params, n_params


def gateway_runs(torch, np, m, cfg, params, cache_len, policies, stream,
                 expect, ckpt_dir, kernels=(None, None)):
    """Each policy on fresh engines (2 x 8 slots, FCFS, the V100
    profile) over the same stream through the port's ``serve_gateway``,
    the launch counts set to 0 just before each run and read just after
    it, then checked by ``expect(launches, admissions, iterations)``.
    The ``rl`` policy's agent is the trained router restored from
    ``ckpt_dir`` (the reference CLI's ``--backend engine --policy rl
    --checkpoint`` path).  One decode step and, where ``kernels[1]``
    names a kernel, one prefill of the stream's median prompt are
    profiled per policy."""
    prof = m.profiles.V100_LLAMA2_7B
    args = m.serve_mod.build_parser().parse_args(
        ["--mode", "gateway", "--backend", "engine", "--instances", "2",
         "--requests", str(len(stream()))])
    rcfg = m.serve_mod._router_cfg(args)
    finite = []
    step_s = {"prefill": [], "decode": []}

    def engines():
        return timed_engines(torch, m, cfg, params, prof, cache_len, step_s,
                             finite)

    # warm-up on throwaway engines (cuBLAS handles, allocator)
    m.serve_mod.serve_gateway(
        args, engines(), m.make_gateway_policy("mixing", rcfg),
        [m.Request(prompt_tokens=64, decode_tokens=4, rid=30_000 + i,
                   arrival=0.0) for i in range(2)])
    torch.cuda.empty_cache()
    out, launches_by_policy = {}, {}
    for name in policies:
        insts = engines()
        recorded = []
        if name == "rl":
            agent = m.restore_rl_policy(rcfg, ckpt_dir, m=2).agent
            act = agent.act

            def recording_act(state, mask, epsilon=0.0, prior=None,
                              q_squash=0.0, _act=act):
                a = _act(state, mask, epsilon=epsilon, prior=prior,
                         q_squash=q_squash)
                recorded.append((state, mask, prior, q_squash, a))
                return a
            agent.act = recording_act
            policy = m.RLPolicy(agent, rcfg)
        else:
            policy = m.make_gateway_policy(name, rcfg)
        reqs = stream()
        finite.clear()
        for v in step_s.values():
            v.clear()
        torch.cuda.synchronize()
        reset_launches(m)
        t0 = time.perf_counter()
        stats = m.serve_mod.serve_gateway(args, insts, policy, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(m)
        admissions = sum(i.n_prefills for i in insts)
        iters = sum(i.n_decode_steps for i in insts)
        assert stats["n"] == len(reqs), stats
        assert all(r.decoded == r.decode_tokens for r in reqs)
        assert bool(torch.stack(finite).all()), "non-finite logits"
        expect(launches, admissions, iters)
        launches_by_policy[name] = launches
        out_tok = sum(r.decode_tokens for r in reqs)
        dec_ms = statistics.median(step_s["decode"]) * 1e3
        pre_ms = statistics.median(step_s["prefill"]) * 1e3
        snap = stats["snapshot"]
        pct = {k: (snap[k].get("p50"), snap[k].get("p95"))
               for k in ("ttft", "tbt", "e2e")}
        log(f"  [{name}] served {stats['n']} of {len(reqs)}, admitted "
            f"{stats['admitted']}, shed {stats['shed']}, preemptions "
            f"{stats['preemptions']}; {admissions} admissions, {iters} "
            f"decode iterations; launches {launches}")
        log(f"  [{name}] virtual clock (profile {prof.name}, the router's "
            "model of the hardware, not the card): " + ", ".join(
                f"{k} p50/p95 {a:.3f}/{b:.3f} s" for k, (a, b)
                in pct.items()))
        log(f"  [{name}] wall {wall:.3f} s on the card, {out_tok / wall:.1f}"
            f" output tok/s; gang decode step median {dec_ms:.2f} ms, "
            f"prefill median {pre_ms:.2f} ms (mean prompt "
            f"{statistics.mean(r.prompt_tokens for r in reqs):.0f} tokens)")
        res = dict(wall_s=wall, output_tokens=out_tok,
                   output_tok_s=out_tok / wall, admissions=admissions,
                   decode_iterations=iters, launches=launches,
                   decode_step_median_ms=dec_ms, prefill_median_ms=pre_ms,
                   virtual_percentiles=pct, stats=stats,
                   decode_profile=profile_decode(torch, insts[0], dec_ms,
                                                 kernels[0]))
        if kernels[1] is not None:
            prompt = int(statistics.median(r.prompt_tokens for r in reqs))
            res["prefill_profile"] = profile_prefill(torch, insts[0], prompt,
                                                     kernels[1])
        if name == "rl":
            res["q_check"] = check_q_on_cpu(torch, np, m, agent, recorded)
        out[name] = res
        del insts
        torch.cuda.empty_cache()
    return launches_by_policy, out


def gateway_phase(torch, np, m, ckpt_dir):
    """Phase 6: llama-2-7b with int8 KV caches (8 slots x 2048 tokens),
    12 requests (outputs 16-128) under rl and mixing.  Returns the
    launch counts, the results and (cfg, params), which phase 8
    reuses."""
    cfg = dataclasses.replace(m.get_config("llama-2-7b"),
                              kv_cache_dtype="int8")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype) == (
        32, 4096, 32, 32, 128, 11008, 32000, "bfloat16"), cfg
    params, _ = init_full_width(torch, m, cfg, "llama-2-7b",
                                "int8 KV cache, 2 engines x 8 slots x 2048 "
                                "tokens")

    def expect(launches, admissions, iters):
        assert launches["flash_attention"] == cfg.n_layers * admissions \
            > 0, (launches, admissions)
        assert launches["decode_attention_int8"] == cfg.n_layers * iters \
            > 0, (launches, iters)
        assert launches["decode_attention"] == launches["mamba_scan"] \
            == 0, launches
    launches, out = gateway_runs(
        torch, np, m, cfg, params, 2048, ("rl", "mixing"),
        lambda: gateway_stream(np, m.Request, GATEWAY_REQUESTS, 128, 6,
                               20_000), expect,
        ckpt_dir, (("decode_attention_int8", "dec_split"),
         ("flash_attention", "fa_fwd_tc")))
    return launches, out, (cfg, params)


FALCON_MAMBA_PARAMS = 7_272_665_088


def mamba_gateway_phase(torch, np, m, ckpt_dir):
    """Phase 7: falcon-mamba-7b (attention-free: conv/ssm states per
    slot, no KV cache), 8 requests (outputs 16-64) under rl."""
    cfg = m.get_config("falcon-mamba-7b")
    mc = cfg.mamba
    assert (cfg.n_layers, cfg.d_model, mc.d_inner, mc.d_state, mc.d_conv,
            mc.dt_rank, cfg.vocab_size, cfg.d_ff, cfg.tie_embeddings,
            cfg.layer_pattern, cfg.dtype) == (
        64, 4096, 8192, 16, 4, 256, 65024, 0, False, ("mamba",),
        "bfloat16"), cfg
    params, n_params = init_full_width(
        torch, m, cfg, "falcon-mamba-7b",
        "2 engines x 8 slots of conv/ssm state")
    assert n_params == FALCON_MAMBA_PARAMS, n_params

    def expect(launches, admissions, iters):
        assert launches["mamba_scan"] == cfg.n_layers * admissions > 0, (
            launches, admissions)
        assert iters > 0 and launches["flash_attention"] == launches[
            "decode_attention"] == launches["decode_attention_int8"] == 0, (
            launches, iters)
    return gateway_runs(
        torch, np, m, cfg, params, 2048, ("rl",),
        lambda: gateway_stream(np, m.Request, FAMILY_REQUESTS, 64, 7,
                               40_000), expect,
        ckpt_dir, (None, ("mamba_scan", "scan_fwd")))


def check_q_on_cpu(torch, np, m, agent, recorded):
    """The RL decisions' Q-values on the card against the same network
    on the CPU (TF32 off), within Q_TOL of their scale."""
    assert recorded, "the RL policy made no decisions"
    states = np.stack([r[0] for r in recorded]).astype(np.float32)
    q_card = m.dqn.q_values(agent.params, states)
    cpu = m.dqn.DQNAgent(agent.cfg, device="cpu")
    cpu.from_reference(agent.params.reference_tree())
    q_cpu = m.dqn.q_values(cpu.params, states)
    err = float(np.abs(q_card - q_cpu).max())
    scale = float(np.abs(q_cpu).max())
    assert err <= Q_TOL * max(scale, 1.0), (err, scale)
    same = sum(int(cpu.act(s, mask, prior=prior, q_squash=qs) == a)
               for s, mask, prior, qs, a in recorded)
    log(f"  [rl] {len(recorded)} decisions: Q on the card vs the CPU max "
        f"abs err {err:.3e} (|Q| <= {scale:.3f}, tol {Q_TOL} x max(|Q|, "
        f"1)); the CPU network picks the same action in {same} of "
        f"{len(recorded)}")
    return dict(decisions=len(recorded), max_abs_err=err, q_scale=scale,
                same_action=same)


# -- phase 8: the simulator<->engine loop -------------------------------------

# the card's calibration grids (core.calibrate.CalibrationConfig fields):
# llama-2-7b's prompts across phase 6's range (100-1500) and its decode
# points up to the engines' 8 slots x 2048; qwen3-0.6b's scaled to its
# 1024-token caches
CAL_LLAMA = dict(prompt_grid=(128, 256, 512, 768, 1024, 1536),
                 decode_grid=((1, 256), (2, 512), (4, 512), (4, 1024),
                              (8, 1024), (8, 2048)),
                 prefill_cache_len=2048, decode_steps_per_call=8,
                 repeats=5, warmup=2)
# min of 5 repeats a grid point (core.calibrate's default is 9): the
# sweeps' host-clock walls double on a slow host, and the script has to
# end inside its 1200 s; the R^2 gate and the fidelity band still hold
CAL_QWEN = dict(prompt_grid=(128, 256, 384, 512, 768, 896),
                decode_grid=((1, 128), (2, 256), (4, 256), (4, 512),
                             (8, 512), (8, 1024)),
                prefill_cache_len=1024, decode_steps_per_call=8,
                repeats=5, warmup=2)
CAL_DIR = os.path.join(ROOT, "build", "calibration")
# benchmarks/bench_fidelity.py's BAND: |engine vs py| P95 E2E, relative
FIDELITY_BAND = 0.35
# 8c: bench_fidelity's engine-vs-simulator leg at llama-2-7b's serving
# shape (2 engines x 8 slots x 2048, the V100 profile's 4000 tokens).  The
# stream is cut from 24 requests to 12: at 24 the two legs took 975 and
# 892 decode steps, 141 s of the phase's 207 s on an H100
FID_LLAMA = dict(backends=("py", "vec", "engine"), n_requests=12,
                 n_instances=2, n_slots=8, cache_len=2048,
                 capacity_tokens=4000, prompt_lengths=(128, 256, 512, 1024),
                 decode_range=(16, 128), rate=1.0, policy="mixing")
# 8d: the saturating stream on one qwen3-0.6b engine x 2 slots: two
# bursts of 4 ladder-top (512-token) prompts whose decodes (40-48) push
# two residents past 1100 tokens, so every backend preempts
FID_SATURATE = dict(backends=("py", "vec", "engine"), n_requests=8,
                    n_instances=1, n_slots=2, cache_len=1024,
                    capacity_tokens=1100, prompt_lengths=(256, 512),
                    decode_range=(16, 48), rate=2.0, saturate=True)


def layer_counts(cfg):
    """(kernel attention layers, mamba layers): GQA self-attention layers
    (the dense first layer's included) reach flash and decode attention,
    mamba layers the scan; MLA and cross-attention reach no kernel."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_scan_layers)]
    attn = 0
    if cfg.attention != "mla":
        attn = kinds.count("attn") + int(cfg.dense_first_layer)
    return attn, kinds.count("mamba")


def expect_layers(cfg, launches, prefills, steps):
    """Each kernel once a layer of its kind per prefill (flash, the scan)
    or per decode step (the cache's decode mode), nothing else; at least
    one of each pass ran."""
    assert prefills > 0 and steps > 0, (prefills, steps)
    attn, mamba = layer_counts(cfg)
    dec = ("decode_attention_int8" if cfg.kv_cache_dtype == "int8"
           else "decode_attention")
    want = {"flash_attention": attn * prefills, "decode_attention": 0,
            "decode_attention_int8": 0, "mamba_scan": mamba * prefills,
            "flash_attention_bwd": 0, "mamba_scan_bwd": 0}
    want[dec] = attn * steps
    assert launches == want, (launches, want)


def calibrate_on_card(torch, m, cfg, params, grid, name, measured):
    """Sweep and fit ``cfg``'s profile from its engine functions on the
    card (``core.calibrate.calibrate``), the launch counts read around
    the sweep; print the fit beside V100's constants and beside the
    walls an earlier phase measured in serving (``measured``: decode
    step ms, prefill ms and its prompt tokens); save the artifact under
    ``build/calibration/`` and read it back with ``load_profile``."""
    ccfg = m.cal.CalibrationConfig(**grid)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(m)
    t0 = time.perf_counter()
    res = m.cal.calibrate(cfg, params, ccfg, name=f"h100-{name}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(m)
    calls = ccfg.warmup + ccfg.repeats
    expect_layers(cfg, launches, len(ccfg.prompt_grid) * calls,
                      len(ccfg.decode_grid) * calls
                      * ccfg.decode_steps_per_call)
    peak = torch.cuda.max_memory_allocated() / 1e9
    for line in m.cal.format_result(res).splitlines():
        log("  " + line)
    p, v = res.profile, m.profiles.V100_LLAMA2_7B
    for key in ("grad1", "grad2", "t_decode_base", "t_prefill_base"):
        log(f"    {key:14s} {getattr(p, key):.4e} (V100 "
            f"{getattr(v, key):.4e})")
    log("  prefill samples (tokens, ms): " + ", ".join(
        f"({x:.0f}, {t * 1e3:.3f})" for x, t in res.prefill_samples))
    log("  decode samples (B*c, ms/step): " + ", ".join(
        f"({x:.0f}, {t * 1e3:.3f})" for x, t in res.decode_samples))
    r_top = max(x for x, _ in res.decode_samples)
    it_ms = p.iteration_time(0, int(r_top)) * 1e3
    pre_ms = p.prefill_time(measured["prompt_tokens"]) * 1e3
    log(f"  served walls ({measured['what']}) against the fit: decode step "
        f"{measured['decode_ms']:.2f} ms vs iteration_time(0, "
        f"{r_top:.0f}) {it_ms:.2f} ms; prefill of "
        f"{measured['prompt_tokens']} tokens {measured['prefill_ms']:.2f} "
        f"ms vs prefill_time {pre_ms:.2f} ms")
    # printed, not asserted: while the host's dispatch time hides the
    # device's per-token cost, both slopes are host noise and the
    # ordering grad1 > grad2 is decided by it (PERF.md §6, PR 21)
    log(f"  sanity (grad1 > grad2 > 0): {res.ok}; R^2 prefill "
        f"{res.prefill_fit.r2:.4f}, decode {res.decode_fit.r2:.4f}")
    assert all(t > 0 for _, t in res.prefill_samples + res.decode_samples)
    assert [x for x, _ in res.prefill_samples] == list(ccfg.prompt_grid)
    assert [x for x, _ in res.decode_samples] == [
        b * c for b, c in ccfg.decode_grid]
    os.makedirs(CAL_DIR, exist_ok=True)
    path = os.path.join(CAL_DIR, f"{name}.json")
    res.save(path)
    assert m.cal.load_profile(path) == res.profile
    log(f"  wrote {os.path.relpath(path, ROOT)}; sweep {wall:.1f} s, "
        f"peak {peak:.2f} GB allocated; launches {launches}")
    return launches, res, dict(
        wall_s=wall, peak_gb=peak, ok=res.ok,
        artifact=os.path.relpath(path, ROOT),
        result=res.to_json(), iteration_time_ms_at_top=it_ms,
        prefill_time_ms_at_served=pre_ms, measured=measured)


def fidelity_on_card(torch, m, cfg, params, fcfg, profile, what):
    """``serving.fidelity.run_fidelity`` with the engine leg on the
    card, the launch counts read around it and held to the engines' own
    prefill and decode-step counts; vec must equal py and the engine
    must serve the whole stream."""
    made = []

    class CountedInstance(m.LLMInstance):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m.fid.LLMInstance = CountedInstance
    try:
        reset_launches(m)
        t0 = time.perf_counter()
        rep = m.fid.run_fidelity(profile, fcfg, model_cfg=cfg,
                                 params=params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(m)
    finally:
        m.fid.LLMInstance = m.LLMInstance
    prefills = sum(e.n_prefills for e in made)
    steps = sum(e.n_decode_steps for e in made)
    expect_layers(cfg, launches, prefills, steps)
    backends = rep["backends"]
    assert backends["vec"] == backends["py"], "vec diverged from py"
    for name, b in backends.items():
        assert b["completed"] == fcfg.n_requests, (name, b["completed"])
    peak = torch.cuda.max_memory_allocated() / 1e9
    d = rep["deltas"]["engine_vs_py"]
    for line in m.fid.format_report(rep).splitlines():
        log("    " + line)
    log(f"  [{what}] engine leg: {prefills} prefills, {steps} decode "
        f"steps; {wall:.1f} s wall for all backends, peak {peak:.2f} GB "
        f"allocated; launches {launches}")
    del made             # the engines and their caches, before the release
    torch.cuda.empty_cache()
    return launches, rep, dict(
        wall_s=wall, peak_gb=peak, prefills=prefills, decode_steps=steps,
        e2e_p95_rel=d["e2e"]["p95"]["rel"],
        ttft_p95_rel=d["ttft"]["p95"]["rel"],
        preemptions=d["preemptions"], report=rep)


def loop_phase(torch, m, qwen, llama, served, gateway):
    """Phase 8: (a) calibrate llama-2-7b (int8 KV) and (b) qwen3-0.6b
    from their full-width engines on the card, (c) replay one stream
    through py, vec and llama-2-7b engines on the V100 profile and on
    (a)'s, (d) the saturating stream on a qwen3-0.6b engine.  ``qwen``
    and ``llama`` are (cfg, params) of phases 5 and 6."""
    t_phase = time.perf_counter()
    out, launches = {}, {}
    rl = gateway["rl"]
    llama_measured = dict(
        what="phase 6, rl", decode_ms=rl["decode_step_median_ms"],
        prefill_ms=rl["prefill_profile"]["wall_ms"],
        prompt_tokens=rl["prefill_profile"]["prompt_tokens"])
    log("  (8a) llama-2-7b, int8 KV cache")
    launches["calibrate_llama"], llama_res, out["calibrate_llama"] = \
        calibrate_on_card(torch, m, *llama, CAL_LLAMA, "llama-2-7b-int8",
                          llama_measured)
    torch.cuda.empty_cache()
    qwen_measured = dict(
        what="phase 5", decode_ms=served["decode_step_median_ms"],
        prefill_ms=served["prefill_median_ms"],
        prompt_tokens=served["prompt_mean"])
    log("  (8b) qwen3-0.6b, bf16 cache")
    launches["calibrate_qwen3"], _, out["calibrate_qwen3"] = \
        calibrate_on_card(torch, m, *qwen, CAL_QWEN, "qwen3-0.6b",
                          qwen_measured)
    torch.cuda.empty_cache()
    fcfg = m.fid.FidelityConfig(**FID_LLAMA)
    for tag, prof in (("v100", m.profiles.V100_LLAMA2_7B),
                      ("calibrated", llama_res.profile)):
        log(f"  (8c) fidelity of llama-2-7b on the {prof.name} profile")
        key = f"fidelity_llama_{tag}"
        launches[key], _, out[key] = fidelity_on_card(
            torch, m, *llama, fcfg, prof, key)
        rel = out[key]["e2e_p95_rel"]
        assert rel is not None and abs(rel) <= FIDELITY_BAND, (tag, rel)
    log("  (8d) the saturating stream on qwen3-0.6b, V100 profile")
    launches["fidelity_qwen3_saturate"], _, sat = fidelity_on_card(
        torch, m, *qwen, m.fid.FidelityConfig(**FID_SATURATE),
        m.profiles.V100_LLAMA2_7B, "fidelity_qwen3_saturate")
    assert sat["preemptions"]["both_preempt"], sat["preemptions"]
    out["fidelity_qwen3_saturate"] = sat
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  loop phase {out['phase_s']:.1f} s")
    return launches, out


# -- phase 9: the MoE and MLA families behind the gateway, every family at
# full width --------------------------------------------------------------

DEEPSEEK_PARAMS = 16_375_728_128
MINICPM3_PARAMS = 4_261_902_848
VISION_PARAMS = 9_780_400_144
MUSICGEN_PARAMS = 1_362_249_216
# jamba-v0.1-52b cut to one period (8 of 32 layers, every width intact):
# the 52 B model does not fit one card in bf16
JAMBA_PERIOD_PARAMS = 13_295_235_072
# 9c: a prefill of S tokens, then this many decode steps, each held to the
# last logits of a prefill of the same positions
DECODE_CHECK_S = 300
DECODE_CHECK_STEPS = 3
DECODE_CHECK_TOL = 0.05      # of max |logit|, for models without routing
MOE_CHECK_ROWS = (8, 512)
MOE_CHECK_TOL = 2e-2         # of max |y| between the three MoE paths


def gather_with_copies(torch, m, cfg, p, x):
    """The reference's ``moe_gather`` as written (``moe.py:234-256``):
    ``[T,k,d,f]`` copies of each row's chosen experts' weights, then one
    product a (row, expert) pair.  A yardstick for the port's gather,
    which runs every expert on the rows instead; used nowhere else."""
    _, idx, w = m.moe._router(p, x, cfg)
    r = p["routed"]
    xx = x[:, None, None]
    h = torch.nn.functional.silu(xx @ r["w_gate"][idx]) * (xx @ r["w_up"][idx])
    y = (h @ r["w_down"][idx])[:, :, 0]
    return torch.sum(y * w[..., None].to(y.dtype), dim=1).to(x.dtype)


def moe_check(torch, m, cfg, p_moe, name):
    """9c (i): ``gather``, ``ragged`` and ``dense`` on the same hidden
    rows at full width route the same rows the same way, so they agree
    within MOE_CHECK_TOL of the largest output.  Each one's peak memory
    beside the weights and its time (``time_ms``: CUDA events, median
    of TIMING_RUNS, L2 flushed) are printed, and at 8 rows (the engine's decode) the reference's gather
    with weight copies beside the port's."""
    assert cfg.gated_mlp and cfg.activation == "silu", cfg
    gen = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for rows in MOE_CHECK_ROWS:
        x = torch.randn((rows, cfg.d_model), generator=gen, device="cuda")
        x = x.to(m.params_lib.torch_dtype(cfg.dtype))
        res = {}
        with torch.no_grad():
            for impl, fn in m.moe.IMPLS.items():
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                y, aux = fn(p_moe, cfg, x)
                torch.cuda.synchronize()
                res[impl] = dict(
                    y=y, aux=float(aux), peak_gb=(
                        torch.cuda.max_memory_allocated() - base) / 1e9,
                    ms=time_ms(torch, lambda: fn(p_moe, cfg, x), flush))
            if rows <= 8:
                copies = gather_with_copies(torch, m, cfg, p_moe, x)
                copies_ms = time_ms(torch, lambda: gather_with_copies(
                    torch, m, cfg, p_moe, x), flush)
        ref = res["dense"]["y"].float()
        scale = float(ref.abs().max())
        assert scale > 0 and bool(torch.isfinite(ref).all()), name
        errs = {}
        for impl, r in res.items():
            errs[impl] = float((r["y"].float() - ref).abs().max())
            assert errs[impl] <= MOE_CHECK_TOL * scale, (name, rows, impl,
                                                         errs[impl], scale)
            assert abs(r["aux"] - res["dense"]["aux"]) < 1e-4, (impl, r)
        log(f"  (9c-i) {name} MoE, {rows} rows: max |y| {scale:.3f}; "
            + ", ".join(f"{impl} err {errs[impl]:.3e}, {r['ms']:.3f} ms, "
                        f"peak +{r['peak_gb']:.2f} GB"
                        for impl, r in res.items())
            + f" (tol {MOE_CHECK_TOL} x max |y|)")
        out[rows] = {impl: dict(err=errs[impl], ms=r["ms"],
                                peak_gb=r["peak_gb"], aux=r["aux"])
                     for impl, r in res.items()}
        out[rows]["scale"] = scale
        if rows <= 8:
            err = float((copies.float() - res["gather"]["y"].float()
                         ).abs().max())
            assert err <= MOE_CHECK_TOL * scale, (name, err)
            log(f"  (9c-i) {name}, {rows} rows: the reference's gather "
                f"with [T,k,d,f] weight copies {copies_ms:.3f} ms against "
                f"the port's {res['gather']['ms']:.3f} ms (err "
                f"{err:.3e})")
            out[rows]["gather_with_copies_ms"] = copies_ms
    return out


def decode_check(torch, m, cfg, params, name, routed):
    """9c (ii): a prefill of DECODE_CHECK_S positions, then
    DECODE_CHECK_STEPS decode steps; step t's logits against the last
    logits of a fresh prefill of the same S+t+1 positions (seeded inputs;
    vision inputs where the model has cross layers).  Without routed
    experts the error is asserted within DECODE_CHECK_TOL of max |logit|;
    with them it is printed with the top-1 agreement (in bf16, a prefill
    and a decode step may route a near-tied token to different
    experts).  The launch counts are read around the whole check."""
    s, n = DECODE_CHECK_S, DECODE_CHECK_STEPS
    gen = torch.Generator(device="cuda").manual_seed(5)
    seq, vis = model_inputs(torch, cfg, m.params_lib.torch_dtype(cfg.dtype),
                            1, s + n, gen, "cuda")
    cache_len = s + 8
    errs, rel, agree = [], [], 0
    torch.cuda.synchronize()
    reset_launches(m)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = m.model_lib.prefill(
            params, cfg, cache_len=cache_len, **seq_slice(seq, 0, s), **vis)
        finite = [torch.isfinite(logits).all()]
        for t in range(n):
            logits, cache = m.model_lib.decode_step(
                params, cfg, cache, **seq_slice(seq, s + t, s + t + 1))
            want, _ = m.model_lib.prefill(
                params, cfg, cache_len=cache_len,
                **seq_slice(seq, 0, s + t + 1), **vis)
            finite += [torch.isfinite(logits).all(),
                       torch.isfinite(want).all()]
            err = float((logits.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            errs.append(err)
            rel.append(err / scale)
            agree += int(torch.argmax(logits) == torch.argmax(want))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(m)
    assert bool(torch.stack(finite).all()), f"{name}: non-finite logits"
    assert logits.shape == (1, cfg.vocab_size), logits.shape
    expect_layers(cfg, launches, n + 1, n)
    log(f"  (9c-ii) {name}: decode vs prefill at S={s}+1..{s + n}: "
        f"max err {max(errs):.4f} = {max(rel):.4f} x max |logit|, top-1 "
        f"agrees {agree}/{n} ({wall:.2f} s); launches {launches}")
    if not routed:
        assert max(rel) <= DECODE_CHECK_TOL, (name, rel)
    return launches, dict(errs=errs, rel=rel, top1_agree=agree, steps=n,
                          wall_s=wall, launches=launches)


def mla_bytes_per_token(cfg):
    """The MLA cache per token (bf16 latent + rope key a layer) beside the
    decompressed K/V that standard attention would cache."""
    mc = cfg.mla
    latent = cfg.n_layers * (mc.kv_lora_rank + mc.qk_rope_head_dim) * 2
    full = cfg.n_layers * cfg.n_heads * (
        mc.qk_nope_head_dim + mc.qk_rope_head_dim + mc.v_head_dim) * 2
    return latent, full


def release(torch, what: str = "") -> float:
    """Print the peak allocated memory since the last release (``what``
    names the work), then return the allocator's cached blocks once the
    caller has dropped a model's weights, so that the next model fits.
    Returns the peak in GB."""
    torch.cuda.synchronize()
    gb = torch.cuda.max_memory_allocated() / 1e9
    if what:
        log(f"  peak allocated {gb:.2f} GB ({what})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return gb


def families_phase(torch, np, m, ckpt_dir):
    """Phase 9: (a) deepseek-moe-16b and (b) minicpm3-4b at full width
    behind the gateway under ``rl`` (phase 5b's restored router; 2
    engines x 8 slots x 2048 bf16 KV, FCFS, the V100 profile; 16
    requests, prompts 100-1500, outputs 16-64, 1/s), each with one decode
    step and one prefill of the median prompt profiled; (c) every family
    at full width, model-level: the three MoE paths against each other
    (deepseek's and jamba's widths) and decode against prefill for
    minicpm3-4b, llama-3.2-vision-11b, musicgen-medium, deepseek-moe-16b
    and jamba-v0.1-52b cut to one period.  Each model is freed before
    the next.  Returns the launch counts per path and the results."""
    t_phase = time.perf_counter()
    launches, out = {}, {}
    release(torch)

    # (9a) deepseek-moe-16b
    cfg = m.get_config("deepseek-moe-16b")
    mc = cfg.moe
    assert (cfg.n_layers, cfg.dense_first_layer, cfg.dense_first_d_ff,
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            mc.n_experts, mc.top_k, mc.d_expert, mc.n_shared,
            cfg.vocab_size, cfg.dtype) == (
        28, True, 10944, 2048, 16, 16, 128, 64, 6, 1408, 2, 102400,
        "bfloat16"), cfg
    params, n_params = init_full_width(
        torch, m, cfg, "deepseek-moe-16b",
        "2 engines x 8 slots x 2048 bf16 KV")
    assert n_params == DEEPSEEK_PARAMS, n_params
    by_policy, out["deepseek"] = gateway_runs(
        torch, np, m, cfg, params, 2048, ("rl",),
        lambda: gateway_stream(np, m.Request, FAMILY_REQUESTS, 64, 9,
                               50_000),
        lambda *a: expect_layers(cfg, *a), ckpt_dir,
        (("decode_attention", "dec_split"), ("flash_attention",
                                             "fa_fwd_tc")))
    launches["gateway_deepseek_rl"] = by_policy["rl"]
    out["peak_gb_deepseek_serving"] = release(
        torch, "deepseek-moe-16b serving: weights, two engines' caches")
    reset_launches(m)
    out["moe_deepseek"] = moe_check(torch, m, cfg,
                                    m.model_lib._index(
                                        params["layers"][0], 0)["moe"],
                                    "deepseek-moe-16b")
    launches["moe_impls"] = read_launches(m)
    launches["check_deepseek"], out["check_deepseek"] = decode_check(
        torch, m, cfg, params, "deepseek-moe-16b", routed=True)
    del params
    out["peak_gb_deepseek"] = release(torch, "deepseek-moe-16b: the MoE "
                                      "and decode checks")

    # (9b) minicpm3-4b
    cfg = m.get_config("minicpm3-4b")
    ml = cfg.mla
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, ml.q_lora_rank,
            ml.kv_lora_rank, ml.qk_nope_head_dim, ml.qk_rope_head_dim,
            ml.v_head_dim, cfg.d_ff, cfg.vocab_size, cfg.attention,
            cfg.dtype) == (62, 2560, 40, 768, 256, 64, 32, 64, 6400, 73448,
                           "mla", "bfloat16"), cfg
    latent, full = mla_bytes_per_token(cfg)
    params, n_params = init_full_width(
        torch, m, cfg, "minicpm3-4b",
        f"2 engines x 8 slots x 2048 MLA latents: {latent} cache bytes a "
        f"token ({full} decompressed, {full / latent:.1f}x)")
    assert n_params == MINICPM3_PARAMS, n_params
    out["minicpm3_cache_bytes_per_token"] = dict(latent=latent, full=full)
    by_policy, out["minicpm3"] = gateway_runs(
        torch, np, m, cfg, params, 2048, ("rl",),
        lambda: gateway_stream(np, m.Request, FAMILY_REQUESTS, 64, 10,
                               60_000),
        lambda *a: expect_layers(cfg, *a), ckpt_dir,
        (None, ("gemm", "gemm")))
    launches["gateway_minicpm3_rl"] = by_policy["rl"]
    out["peak_gb_minicpm3_serving"] = release(
        torch, "minicpm3-4b serving: weights, two engines' caches")
    launches["check_minicpm3"], out["check_minicpm3"] = decode_check(
        torch, m, cfg, params, "minicpm3-4b", routed=False)
    del params
    out["peak_gb_minicpm3"] = release(torch, "minicpm3-4b: decode check")

    # (9c) the other families, model-level
    cfg = m.get_config("llama-3.2-vision-11b")
    assert (cfg.n_layers, cfg.n_periods * cfg.layer_pattern.count("cross"),
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vision_tokens,
            cfg.vision_dim) == (40, 8, 4096, 32, 8, 1024, 1280), cfg
    params, n_params = init_full_width(
        torch, m, cfg, "llama-3.2-vision-11b",
        "8 gated cross layers, gates set to 0.5 / -0.3")
    assert n_params == VISION_PARAMS, n_params
    set_cross_gates(params)
    launches["check_vision"], out["check_vision"] = decode_check(
        torch, m, cfg, params, "llama-3.2-vision-11b", routed=False)
    del params
    out["peak_gb_vision"] = release(torch, "llama-3.2-vision-11b")

    cfg = m.get_config("musicgen-medium")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.input_mode) == (48, 1536, 24, 24, 64,
                                              "embeddings"), cfg
    params, n_params = init_full_width(torch, m, cfg, "musicgen-medium",
                                       "seeded frame embeddings")
    assert n_params == MUSICGEN_PARAMS, n_params
    launches["check_musicgen"], out["check_musicgen"] = decode_check(
        torch, m, cfg, params, "musicgen-medium", routed=False)
    del params
    out["peak_gb_musicgen"] = release(torch, "musicgen-medium")

    cfg = dataclasses.replace(m.get_config("jamba-v0.1-52b"), n_layers=8)
    assert (cfg.n_periods, cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k,
            cfg.moe.d_expert, cfg.mamba.d_inner) == (
        1, 4096, 16, 2, 14336, 8192), cfg
    params, n_params = init_full_width(
        torch, m, cfg, "jamba-v0.1-52b",
        "one period of its 4: 7 mamba + 1 attention layer, 4 MoE")
    assert n_params == JAMBA_PERIOD_PARAMS, n_params
    reset_launches(m)
    out["moe_jamba"] = moe_check(torch, m, cfg, m.model_lib._index(
        params["layers"][1], 0)["moe"], "jamba-v0.1-52b")
    moe_launches = read_launches(m)
    launches["moe_impls"] = {k: v + moe_launches[k]
                             for k, v in launches["moe_impls"].items()}
    assert not any(launches["moe_impls"].values()), launches["moe_impls"]
    launches["check_jamba"], out["check_jamba"] = decode_check(
        torch, m, cfg, params, "jamba-v0.1-52b (one period)", routed=True)
    del params
    out["peak_gb_jamba"] = release(torch, "jamba-v0.1-52b, one period")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  families phase {out['phase_s']:.1f} s")
    return launches, out


# -- phase 10: LM training on the card ---------------------------------------

# 10b: the reference launcher's schedule at qwen3-0.6b's full width
TRAIN_ARGS = dict(steps=30, batch=8, seq=1024, lr=1e-3, ckpt_every=10)
TRAIN_RESUME_AT = 20
TRAIN_CKPT = os.path.join(ROOT, "build", "train_ckpt")
# 10c: falcon-mamba-7b under Adafactor, one repeated batch
FALCON_TRAIN = dict(batch=1, seq=1024, steps=4)


def _tree_leaves(tree):
    """{key: leaf} of a tree (``_leaves_with_keys`` order)."""
    from repro_torch.training.checkpoint import _leaves_with_keys
    return dict(_leaves_with_keys(tree))


def train_reduced(torch, m):
    """10a: one f32 AdamW train step of phase 4's seven reduced families
    on the card (kernels and their backwards) against the CPU (autograd
    of the plain versions), from the same parameters and batch: loss
    within 1e-5, every grad leaf within 1e-4 of its largest |g|, params
    after the step within 1e-5.  The step runs at the full lr (3e-4,
    ``warmup_steps=1``), so it moves each entry by about 3e-4 and the
    1e-5 bound sees a skipped or wrongly signed update -- except where
    the CPU's second moment says a gradient never left rounding level
    (sqrt(nu) < 1e-6), or where the gradient is under twice the 1e-4 of
    max |g| that the two sides' gradients may part by: Adam moves such
    an entry by any value in [-lr, lr] on either side (ROADMAP §3), so
    there the two may part by 2 lr.  Returns the launch counts."""
    from repro_torch.launch.train import to_device
    from repro_torch.training import data as data_lib
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    reset_launches(m)
    for arch, what in REDUCED_ARCHS:
        over = {} if arch == "falcon-mamba-7b" else {"head_dim": 32}
        cfg = m.get_config(arch).reduced(**over)
        p_cpu, o_cpu = init_train_state(
            cfg, torch.Generator().manual_seed(0), device="cpu")
        with torch.no_grad():
            set_cross_gates(p_cpu)
        p_gpu = m.params_lib.from_reference(_tree_numpy(p_cpu),
                                            device="cuda")
        for p in m.params_lib.leaves(p_gpu):
            p.requires_grad_()
        o_gpu = opt_lib.init(p_gpu)
        host = data_lib.synthetic_batch(cfg, 2, 48, seed=0, step=0)
        out = {}
        for dev, params, opt in (("cpu", p_cpu, o_cpu),
                                 ("cuda", p_gpu, o_gpu)):
            grads = {}

            def keep(tree, grads=grads):
                grads.update(_tree_leaves(tree))
                return tree
            step = make_train_step(
                cfg, opt_lib.OptimizerConfig(warmup_steps=1),
                compress_grads=keep)
            params, opt, met = step(params, opt, to_device(host, dev))
            out[dev] = (float(met["loss"]), grads, params, opt,
                        float(met["lr"]))
        (l_c, g_c, p_c, o_c, lr), (l_g, g_g, p_g, _, lr_g) = (
            out["cpu"], out["cuda"])
        assert lr == lr_g and lr > 1e-4, (arch, lr, lr_g)
        assert abs(l_g - l_c) <= 1e-5 * abs(l_c), (arch, l_g, l_c)
        g_err = 0.0
        for key, gc in g_c.items():
            scale = float(gc.abs().max())
            err = float((g_g[key].cpu() - gc).abs().max())
            assert err <= 1e-4 * scale + 1e-12, (arch, key, err, scale)
            g_err = max(g_err, err / max(scale, 1e-30))
        p_err, n_unsure = 0.0, 0
        nu = _tree_leaves(o_c["nu"])
        gpu = _tree_leaves(p_g)
        for key, a in _tree_leaves(p_c).items():
            diff = (gpu[key].detach().cpu() - a.detach()).abs()
            gc = g_c[key].abs()
            sure = (nu[key].sqrt() >= 1e-6) & (gc >= 2e-4 * gc.max())
            n_unsure += int((~sure).sum())
            if sure.any():
                p_err = max(p_err, float(diff[sure].max()))
            # (+ the f32 rounding of an entry near 1)
            assert float(diff.max()) <= 2 * lr + 1e-6, (arch, key,
                                                       diff.max())
        assert p_err <= 1e-5, (arch, p_err)
        log(f"  train step, reduced {arch} ({what}; f32, lr {lr:.1e}): "
            f"loss {l_g:.6f} (CPU {l_c:.6f}), grads within {g_err:.1e} "
            f"of max|g|, params after AdamW within {p_err:.1e} "
            f"({n_unsure} entries at rounding-level or near-zero "
            f"gradients within 2 lr)")
    launches = read_launches(m)
    assert launches["flash_attention_bwd"] and launches["mamba_scan_bwd"], \
        launches
    log(f"  launches (10a): {launches}")
    return launches


def train_qwen3(torch, np, m):
    """10b: full-width qwen3-0.6b through ``repro_torch.launch.train``'s
    loop (AdamW lr 1e-3, warmup 20, cosine over 30 steps; batch 8 x 1024;
    checkpoints every 10 under build/train_ckpt/), then a second run
    resumed from the step-20 checkpoint alone: steps 21-30 and the final
    state bit-equal to the first run's, both under
    ``torch.use_deterministic_algorithms``.  The loss falls (the last 5
    steps' mean below the first 5's)."""
    import warnings
    from repro_torch.launch.train import to_device, train
    from repro_torch.training import data as data_lib
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import make_train_step
    cfg = m.get_config("qwen3-0.6b")
    assert cfg.remat and cfg.n_layers == 28, cfg
    a = TRAIN_ARGS
    tokens = a["batch"] * a["seq"]
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    full, part = (os.path.join(TRAIN_CKPT, d) for d in ("full", "resumed"))

    def recorder(rec):
        def on_step(i, met):
            torch.cuda.synchronize()
            rec.append((i, time.perf_counter(), met["loss"].item(),
                        m.fa.launches, m.fa.launches_bwd))
        return on_step

    release(torch)
    reset_launches(m)
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for ckpt, resume in ((full, False), (part, True)):
                if resume:
                    os.makedirs(part)
                    name = f"step_{TRAIN_RESUME_AT:09d}.ckpt"
                    shutil.copy(os.path.join(full, name), part)
                    with open(os.path.join(part, "latest"), "w") as f:
                        f.write(name)
                rec = []
                t0 = time.perf_counter()
                params, opt, start = train(
                    cfg, a["steps"], a["batch"], a["seq"], lr=a["lr"],
                    ckpt=ckpt, ckpt_every=a["ckpt_every"], device="cuda",
                    on_step=recorder(rec), log=lambda x: log("  " + x))
                runs.append(dict(rec=rec, params=params, opt=opt,
                                 start=start, t0=t0,
                                 wall_s=time.perf_counter() - t0))
    finally:
        torch.use_deterministic_algorithms(False)
    peak_gb = release(torch, "qwen3-0.6b training, two runs")
    launches = read_launches(m)
    first, second = runs
    assert first["start"] == 0 and second["start"] == TRAIN_RESUME_AT
    losses = [r[2] for r in first["rec"]]
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    refused = sorted({str(w.message).split("\n")[0][:160] for w in caught
                      if "determinis" in str(w.message)})
    resumed = [r[2] for r in second["rec"]]
    tail = losses[TRAIN_RESUME_AT:]
    state_a = _tree_leaves({"params": first["params"], "opt": first["opt"]})
    state_b = _tree_leaves({"params": second["params"],
                            "opt": second["opt"]})
    if not refused:
        assert resumed == tail, (resumed, tail)
        for key, x in state_a.items():
            assert torch.equal(x, state_b[key]), key
        how = "bit-equal"
    else:
        log("  ops without a deterministic CUDA path: "
            + "; ".join(refused))
        np.testing.assert_allclose(resumed, tail, rtol=1e-6)
        for key, x in state_a.items():
            torch.testing.assert_close(state_b[key], x, rtol=1e-6, atol=0)
        how = "within 1e-6"
    # step walls of the first run (host clock, synchronised each step)
    times = [first["t0"]] + [r[1] for r in first["rec"]]
    walls = [(t1 - t0) * 1e3 for t0, t1 in zip(times, times[1:])]
    step_ms = statistics.median(walls[1:])
    n = len(first["rec"])
    fa_fwd = first["rec"][-1][3] / n
    fa_bwd = first["rec"][-1][4] / n
    log(f"  qwen3-0.6b (28 layers, bf16, remat) trained {n} steps, B=8 x "
        f"S=1024: loss {losses[0]:.4f} -> {losses[-1]:.4f} (first 5 mean "
        f"{np.mean(losses[:5]):.4f}, last 5 {np.mean(losses[-5:]):.4f}); "
        f"resumed at {TRAIN_RESUME_AT}: steps 21-30 {how}")
    log(f"  step wall median {step_ms:.1f} ms (first step "
        f"{walls[0]:.1f} ms), {tokens / step_ms * 1e3:.0f} tokens/s, run "
        f"{first['wall_s']:.1f} s with checkpoints; peak allocated "
        f"{peak_gb:.2f} GB; flash launches a step: forward {fa_fwd:.1f} "
        f"(predicted 56), backward {fa_bwd:.1f} (predicted 28)")
    run_s = first["wall_s"]
    # one step profiled (on the first run's state, after the checks)
    step = make_train_step(cfg, opt_lib.OptimizerConfig(
        lr=a["lr"], warmup_steps=20, total_steps=a["steps"]))
    batch = to_device(data_lib.synthetic_batch(cfg, a["batch"], a["seq"],
                                               0, a["steps"]), "cuda")
    state = [first["params"], first["opt"]]

    def run():
        state[0], state[1], _ = step(state[0], state[1], batch)
    prof = profile_pass(torch, run, step_ms, "train step (qwen3-0.6b, "
                        "B=8 x 1024)", steps=1, grad=True,
                        kernel=("flash_bwd", "fa_bwd"))
    del runs, first, second, state, state_a, state_b
    release(torch)
    out = dict(losses=losses, resumed_losses=resumed, resume=how,
               refused_ops=refused, step_wall_ms=step_ms,
               first_step_ms=walls[0], tokens_per_s=tokens / step_ms * 1e3,
               peak_gb=peak_gb, flash_fwd_per_step=fa_fwd,
               flash_bwd_per_step=fa_bwd, run_s=run_s, profile=prof)
    return launches, out


def train_falcon(torch, np, m):
    """10c: full-width falcon-mamba-7b (64 Mamba-1 layers, bf16, remat)
    under ``build_train_step(cfg, "adafactor")``, batch 1 x 1024, 4
    steps on one repeated synthetic batch: the loss finite and falling,
    the scan kernel 128 forward and 64 backward launches a step."""
    from repro_torch.launch.steps import adafactor_init, build_train_step
    from repro_torch.launch.train import to_device
    from repro_torch.training import data as data_lib
    cfg = m.get_config("falcon-mamba-7b")
    ft = FALCON_TRAIN
    release(torch)
    params, n_params = init_full_width(torch, m, cfg, "falcon-mamba-7b",
                                       "Adafactor training")
    for p in m.params_lib.leaves(params):
        p.requires_grad_()
    opt = adafactor_init(params)
    step = build_train_step(cfg, "adafactor")
    batch = to_device(data_lib.synthetic_batch(cfg, ft["batch"], ft["seq"],
                                               0, 0), "cuda")
    reset_launches(m)
    losses, walls = [], []
    for _ in range(ft["steps"]):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        losses.append(met["loss"].item())
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches(m)
    peak_gb = release(torch, "falcon-mamba-7b Adafactor training")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    per_fwd = launches["mamba_scan"] / ft["steps"]
    per_bwd = launches["mamba_scan_bwd"] / ft["steps"]
    assert (per_fwd, per_bwd) == (128, 64), launches
    assert peak_gb < 80, peak_gb
    log(f"  falcon-mamba-7b ({n_params} parameters) Adafactor, B=1 x "
        f"S=1024, {ft['steps']} steps: loss "
        + " -> ".join(f"{x:.4f}" for x in losses)
        + f"; step walls " + ", ".join(f"{w:.0f}" for w in walls)
        + f" ms; peak allocated {peak_gb:.2f} GB; scan launches a step: "
        f"forward {per_fwd:.0f}, backward {per_bwd:.0f}")
    del params, opt
    release(torch)
    return launches, dict(losses=losses, step_walls_ms=walls,
                          peak_gb=peak_gb, scan_fwd_per_step=per_fwd,
                          scan_bwd_per_step=per_bwd)


def train_phase(torch, np, m):
    """Phase 10: (a) reduced families, (b) qwen3-0.6b, (c)
    falcon-mamba-7b; each part's launch counts read around it."""
    t_phase = time.perf_counter()
    launches = {"train_reduced": train_reduced(torch, m)}
    launches["train_qwen3"], qwen = train_qwen3(torch, np, m)
    launches["train_falcon"], falcon = train_falcon(torch, np, m)
    out = dict(qwen3=qwen, falcon=falcon,
               phase_s=time.perf_counter() - t_phase)
    log(f"  training phase {out['phase_s']:.1f} s")
    return launches, out


def timed_build(build):
    """The kernel library's path, built if need be, and the seconds the
    build took."""
    t0 = time.perf_counter()
    path = build.library_path()
    return path, time.perf_counter() - t0


def write_json(path, obj):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None,
                    help="also write the full results to this JSON file")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (kernels checked and timed)")
    args = ap.parse_args(argv)
    # phase 10b runs under torch.use_deterministic_algorithms, under
    # which cuBLAS needs a fixed workspace; it is read when cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    from repro_torch.core import batched_rl, dqn, profiles, rl_router as rl
    from repro_torch.core import calibrate as cal
    from repro_torch.core import policies as legacy
    from repro_torch.core import simulator as sim
    from repro_torch.core import predictor as pred_lib
    from repro_torch.core import workload as wl
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import params as params_lib
    from repro_torch.models.attention import quantize_kv
    from repro_torch.serving import fidelity as fid
    from repro_torch.serving import obs
    from repro_torch.serving.engine import LLMInstance
    from repro_torch.serving.gateway import (Gateway, GatewayConfig,
                                             MicroBatchPredictor,
                                             OracleLength)
    from repro_torch.serving.policies import (RLPolicy, make_gateway_policy,
                                              restore_rl_policy)
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import get_scheduler
    from repro_torch.training.checkpoint import (CheckpointManager,
                                                 _flatten as flatten_tree,
                                                 restore_learner,
                                                 save_learner)
    from repro_torch.training.online import OnlineConfig, OnlineTrainer
    from repro_torch.training.train_loop import train_router
    assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                   or m == "repro" for m in sys.modules), "JAX imported"

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    gpu = gpu_line()
    log(f"[1/10] environment: {gpu}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    mods = argparse.Namespace(
        get_config=get_config, params_lib=params_lib, profiles=profiles,
        serve_mod=serve_mod, LLMInstance=LLMInstance,
        get_scheduler=get_scheduler, make_gateway_policy=make_gateway_policy,
        RLPolicy=RLPolicy, Request=Request, rl=rl, dqn=dqn, fa=fa, da=da,
        ms=ms, pred_lib=pred_lib, wl=wl, obs=obs,
        MicroBatchPredictor=MicroBatchPredictor,
        restore_rl_policy=restore_rl_policy,
        CheckpointManager=CheckpointManager, flatten_tree=flatten_tree,
        batched_rl=batched_rl, train_router=train_router,
        OnlineConfig=OnlineConfig, OnlineTrainer=OnlineTrainer,
        save_learner=save_learner, restore_learner=restore_learner,
        Gateway=Gateway, GatewayConfig=GatewayConfig,
        OracleLength=OracleLength, sim=sim, legacy=legacy, cal=cal,
        fid=fid, moe=moe_mod, model_lib=model_lib)
    # nvcc builds the kernels in the background while phase 5b, which
    # launches none of them, runs
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(timed_build, build)
        if not args.kernels_only:
            log("[5b/10] the router's learning path: predictor and DQN "
                "router trained on the card, checkpointed, serving the "
                "simulator (while the kernels build)")
            router_launches, router, ckpt_dir = router_phase(torch, np,
                                                             mods)
        lib_path, build_s = building.result()
    t0 = time.perf_counter()
    build.library()
    log(f"  kernels built in {build_s:.2f} s, loaded in "
        f"{time.perf_counter() - t0:.2f} s: "
        f"{os.path.relpath(lib_path, ROOT)}")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    log("[2/10] kernels against their plain versions on the card")
    errs = check_kernels(torch, fa, da, ms, quantize_kv)
    errs.update(check_backwards(torch, fa, ms))

    log("[3/10] timing (CUDA events, median of "
        f"{TIMING_RUNS}, L2 flushed)")
    kv_rng = np.random.default_rng(2)
    kv_lens = [int(x) for x in kv_rng.integers(100, 1025, 7)] + [1100]
    kv_lens_int8 = [int(x) for x in kv_rng.integers(100, 2049, 7)] + [2100]
    times = time_kernels(torch, fa, da, ms, quantize_kv, prompt_len=512,
                         kv_lens=kv_lens, kv_lens_int8=kv_lens_int8)
    times.update(time_backwards(torch, fa, ms))
    if args.kernels_only:
        log(f"total {time.perf_counter() - t_start:.1f} s (phases 1-3 of "
            f"the port in {SRC})")
        if args.json:
            write_json(args.json, {"gpu": gpu, "src": SRC,
                                   "max_abs_err": errs, "times": times})
        return 0

    log("[4/10] reduced models: card (kernels) against CPU (plain)")
    check_reduced_model(torch, get_config, params_lib, model_lib)

    log("[5/10] serve full-width qwen3-0.6b through serve_engine")
    launches, served, qwen = serve(torch, np, mods)
    torch.cuda.empty_cache()

    log("[5c/10] the router's scale-up on the card: batched training over "
        "py and vec, the heterogeneous stream, online learning under "
        "drift")
    scale_launches, scale_up = scale_up_phase(torch, np, mods)

    log("[6/10] the gateway over full-width llama-2-7b (int8 KV cache) "
        "through serve_gateway, policies rl (restored) and mixing")
    gw_launches, gateway, llama = gateway_phase(torch, np, mods, ckpt_dir)
    torch.cuda.empty_cache()

    log("[7/10] the gateway over full-width falcon-mamba-7b through "
        "serve_gateway, policy rl (restored)")
    mamba_launches, mamba_gateway = mamba_gateway_phase(torch, np, mods,
                                                        ckpt_dir)
    torch.cuda.empty_cache()

    log("[8/10] the simulator-engine loop: llama-2-7b and qwen3-0.6b "
        "calibrated on the card, sim-vs-engine fidelity on both profiles, "
        "the saturating stream")
    loop_launches, loop = loop_phase(torch, mods, qwen, llama, served,
                                     gateway)
    del qwen, llama
    release(torch)

    log("[9/10] the MoE and MLA families behind the gateway at full width "
        "(deepseek-moe-16b, minicpm3-4b; rl restored), every family "
        "model-level at full width")
    fam_launches, families = families_phase(torch, np, mods, ckpt_dir)

    log("[10/10] LM training on the card: reduced families against the "
        "CPU, full-width qwen3-0.6b through launch.train (30 steps, "
        "resumed at 20), full-width falcon-mamba-7b under Adafactor")
    train_launches, training = train_phase(torch, np, mods)
    # each path's own counts (reset before it, read after it): phase 5's
    # serve_engine, phase 5b's router path, phase 5c's three parts, phase
    # 6's gateway under each policy, phase 7's, phase 8's two sweeps and
    # three fidelity runs, phase 9's gateway runs, MoE check and five
    # decode checks, phase 10's three training parts
    by_path = {"serve_engine": launches,
               "router": router_launches,
               "batched": scale_launches["batched"],
               "hetero": scale_launches["hetero"],
               "online": scale_launches["online"],
               "gateway_rl": gw_launches["rl"],
               "gateway_mixing": gw_launches["mixing"],
               "gateway_mamba_rl": mamba_launches["rl"],
               **loop_launches, **fam_launches, **train_launches}
    log(f"  launches per path: {by_path}")

    kernels = []
    for name, source, rep in KERNELS:
        t = times[name]
        per_path = {p: c[name] for p, c in by_path.items()}
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": rep, "launches": sum(per_path.values()),
               "launches_by_path": per_path, "max_abs_err": errs[name],
               "ms": t["ms"], "device_ms": t["device_ms"],
               "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "library_ms": t["library_ms"],
               "library_device_ms": t["library_device_ms"]}
        rec.update({key: t[key] for key in (
            "fixed_device_ms", "floor_device_ms", "share_of_bound",
            "library_ratio") if key in t})
        # second shapes: flash at llama-2-7b's prefill, the scan at a
        # short prompt
        for base, second, prefix in (
                ("flash_attention", "flash_attention_llama", "llama_"),
                ("mamba_scan", "mamba_scan_short", "short_")):
            if name == base:
                rec.update({prefix + key: val for key, val
                            in times[second].items() if key != "shape"})
        kernels.append(rec)
    log("kernels: " + ", ".join(
        f"{k['name']} err={k['max_abs_err']:.3e} {k['ms']:.4f} ms "
        f"(plain {k['plain_ms']:.4f}, library {k['library_ms']}, bound "
        f"{k['bound_ms']:.4f} {k['bound_by']}) launches={k['launches']}"
        for k in kernels))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if args.json:
        write_json(args.json, {"gpu": gpu, "torch": torch.__version__,
                               "cuda": torch.version.cuda, "src": SRC,
                               "kernels": kernels,
                               "timing_shapes": {n: t["shape"]
                                                 for n, t in times.items()},
                               "serve": served, "router": router,
                               "scale_up": scale_up,
                               "gateway": gateway,
                               "gateway_mamba": mamba_gateway,
                               "loop": loop, "families": families,
                               "training": training})
    log(gpu)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
