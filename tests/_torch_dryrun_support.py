"""Shared by ``tests/test_torch_dryrun*.py``: the reduced cells both
packages build, and the runner of the JAX reference's side
(``tests/_torch_dryrun_oracle.py``, one subprocess a test file).

Nothing here imports JAX: each package's ``get_config`` and
``ShapeConfig`` are passed in."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

#: the probe's widths for the FLOP cells (B=4 x S=128 tokens)
PROBE = dict(d_model=256, d_ff=1024, n_heads=8, head_dim=32,
             vocab_size=2048, dtype="bfloat16", remat=True)
PROBE_SHAPES = {"train": ("t128", 128, 4, "train"),
                "prefill": ("p128", 128, 4, "prefill")}
#: the argument-byte cells: tiny widths, one period
TINY_SHAPES = {"train": ("t32", 32, 8, "train"),
               "prefill": ("p32", 32, 8, "prefill"),
               "decode": ("d32", 32, 8, "decode"),
               "seqpar": ("d32sp", 32, 1, "decode")}
MESHES = {"4x2": (("data", "model"), (4, 2)),
          "1x1": (("data", "model"), (1, 1)),
          "2x2x2": (("pod", "data", "model"), (2, 2, 2))}


def probe_config(get_config, arch):
    """``arch`` at the probe's widths: one period (the dense first layer
    and one period where the arch has one), routed experts 8 x top-2
    of width 256 through ``moe_ep`` (one shared where the arch has them),
    the scan at d_inner 512, d_state 16 in one chunk of the sequence (the
    reference's chunking changes its elementwise work, not its products),
    64 vision tokens of 128."""
    c = get_config(arch)
    kw = dict(PROBE, n_layers=c.period + (1 if c.dense_first_layer else 0))
    if c.moe is not None:
        kw["moe"] = dataclasses.replace(
            c.moe, n_experts=8, top_k=2, d_expert=256,
            n_shared=min(c.moe.n_shared, 1), impl="ep")
    if c.mamba is not None:
        kw["mamba"] = dataclasses.replace(c.mamba, d_inner=512, d_state=16,
                                          dt_rank=16, chunk=128)
    if c.dense_first_layer:
        kw["dense_first_d_ff"] = 1024
    if c.vision_tokens:
        kw.update(vision_tokens=64, vision_dim=128)
    return c.reduced(**kw)


def tiny_config(get_config, arch):
    """``arch`` reduced to one period (bf16, remat), experts through
    ``moe_ep`` (8 of them, so that 4 data shards each hold 2)."""
    c = get_config(arch)
    kw = dict(dtype="bfloat16", remat=True,
              n_layers=c.period + (1 if c.dense_first_layer else 0))
    if c.moe is not None:
        kw["moe"] = dataclasses.replace(
            c.moe, n_experts=8, top_k=2, d_expert=32,
            n_shared=min(c.moe.n_shared, 1), impl="ep")
    if c.mamba is not None:
        kw["mamba"] = dataclasses.replace(c.mamba, d_inner=128, d_state=8,
                                          dt_rank=8, chunk=32)
    return c.reduced(**kw)


def build(get_config, ShapeConfig, cell):
    """(cfg, shape) of a cell ``{"arch", "kind", "set"}``: set "probe" or
    "tiny"."""
    if cell["set"] == "probe":
        return (probe_config(get_config, cell["arch"]),
                ShapeConfig(*PROBE_SHAPES[cell["kind"]]))
    return (tiny_config(get_config, cell["arch"]),
            ShapeConfig(*TINY_SHAPES[cell["kind"]]))


def key(cell) -> str:
    return f"{cell['set']}:{cell['arch']}:{cell['kind']}:{cell['mesh']}"


def run_oracle(tmp_path_factory, name: str, cells, what: str):
    """The reference's figures of ``cells`` (``what``: "args" or
    "flops"), from one subprocess with 8 forced host devices."""
    work = tmp_path_factory.mktemp(name)
    with open(work / "cells.json", "w") as f:
        json.dump(cells, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]),
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(REPO / "tests" / "_torch_dryrun_oracle.py"),
         what, str(work / "cells.json"), str(work / "out.json")],
        env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(work / "out.json") as f:
        return json.load(f)


def as_reference_products(get_config, cell, r) -> float:
    """The port's FLOPs a device (``r``: the dry-run's record of ``cell``)
    turned into what the reference's compiled program counts as products
    for the same step, by five stated terms:

    (a) attention: the reference's ``gqa_core`` (S <= 1024) computes the
        masked square: its forward's two products over S^2 (q, k) pairs
        where the kernels count the causal pairs, and autodiff's four
        products of the two einsums where the hand-written backward does
        five over the causal pairs;
    (b) the port's chunked cross entropy runs under
        ``torch.utils.checkpoint``, so training computes the LM head's
        product once more than XLA's program (fwd, recompute, dgrad,
        wgrad against fwd, dgrad, wgrad): one head product less;
    (c) XLA counts ``ragged_dot`` (the reference's grouped expert
        product) as a dense product over all g of the rank's local
        experts: each of the experts' products (forward, recompute,
        dgrad, wgrad in training) g times, where the port's meta path
        runs every received row once;
    (d) the scan: the kernel's count is elementwise work, and the
        reference's chunked scan makes no products;
    (e) for an untied LM head, FSDP-sharded over the data axes, XLA's
        partitioning computes one of its three training products over the
        data axes only (replicated over "model"), where the rules give
        each 1 / (data x model) of the work.
    """
    from repro_torch.common.config import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models.moe import ep_capacity
    cfg, shape = build(get_config, ShapeConfig, cell)
    axes = MESHES[cell["mesh"]]
    sizes = dict(zip(*axes))
    data, model = sizes["data"], sizes["model"]
    train = shape.kind == "train"
    k = {name: v[1] for name, v in r["kernels"].items()}
    f = r["flops_per_device"]
    s = shape.seq_len
    pairs = s * (s + 1) // 2
    f += k.get("flash_attention", 0.0) * (s * s / pairs - 1)          # (a)
    f += k.get("flash_attention_bwd", 0.0) * (0.8 * s * s / pairs - 1)
    f -= k.get("mamba_scan", 0.0) + k.get("mamba_scan_bwd", 0.0)      # (d)
    lcfg = dryrun.local_config(cfg, shape, axes)
    b_loc = shape.global_batch // data
    head = 2 * b_loc * s * cfg.d_model * lcfg.vocab_size
    if train:
        f -= head                                                      # (b)
        if not (cfg.tie_embeddings and cfg.input_mode == "tokens"):
            f += head * (model - 1)                                    # (e)
    if cfg.moe is not None and lcfg.moe.impl == "ep":                  # (c)
        m = cfg.moe
        tokens = b_loc * (1 if shape.kind == "decode" else s)
        rows = data * ep_capacity(tokens, m.top_k, data, m.capacity_factor)
        g = max(1, m.n_experts // data)
        per = 2 * rows * cfg.d_model * lcfg.moe.d_expert * (
            3 if cfg.gated_mlp else 2) * (4 if train else 1)
        n_moe = cfg.n_periods * sum(cfg.moe_pattern[:cfg.period])
        f += (g - 1) * per * n_moe
    return f
