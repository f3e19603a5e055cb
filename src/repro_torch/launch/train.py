"""Training launcher: auto-resuming train loop over any assigned arch
(the port of ``repro.launch.train``, with the same flags and printed
lines, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 30 --batch 8 --seq 1024 --ckpt build/train_ckpt

runs on the card (``--device cuda``, the default, raises without one);
``--reduced --device cpu`` runs a smoke-scale model on the CPU.  With
``--ckpt`` it resumes from the newest intact checkpoint there (params
and AdamW state, bf16 leaves included) and saves every ``--ckpt-every``
steps; batches are a function of (seed, step), so a resumed run replays
the same stream.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import data as data_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_loop import init_train_state, make_train_step


def to_device(host_batch, device):
    """A host batch (numpy) as tensors on ``device``: integer arrays as
    int64, float arrays as f32."""
    out = {}
    for k, v in host_batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.long() if t.dtype in (torch.int32, torch.int64)
                  else t.float()).to(device)
    return out


@torch.no_grad()
def _load(tree, restored):
    """Copy a restored checkpoint tree into the live tensors of ``tree``;
    returns the tree (``step`` tensors replaced)."""
    if isinstance(tree, dict):
        return {k: _load(v, restored[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_load(v, r) for v, r in zip(tree, restored))
    src = torch.as_tensor(np.array(restored) if isinstance(
        restored, np.ndarray) else restored)
    tree.copy_(src)
    return tree


def train(cfg, steps: int, batch: int, seq: int, lr: float = 1e-3,
          ckpt: Optional[str] = None, ckpt_every: int = 50, device="cuda",
          on_step: Optional[Callable] = None, log=print):
    """The launcher's loop: AdamW (warmup 20, cosine over ``steps``),
    seeded params (generator seed 0), batches ``synthetic_batch(seed=0,
    step)``.  ``on_step(i, metrics)`` sees each step's metrics (tensors,
    not synchronised).  Returns (params, opt_state, first step run)."""
    dev = resolve_device(device)
    log(f"arch={cfg.name} params={cfg.count_params()/1e6:.2f}M")
    gen = torch.Generator(device=dev).manual_seed(0)
    params, opt_state = init_train_state(cfg, gen, device=dev)
    start = 0
    mgr = ckpt_lib.CheckpointManager(ckpt) if ckpt else None
    try:
        if mgr is not None:
            restored = mgr.restore({"params": params, "opt": opt_state})
            if restored is not None:
                state, extra = restored
                params = _load(params, state["params"])
                opt_state = _load(opt_state, state["opt"])
                start = extra["step"]
                log(f"resumed at step {start}")
        step_fn = make_train_step(cfg, opt_lib.OptimizerConfig(
            lr=lr, warmup_steps=20, total_steps=steps))
        loader = data_lib.PrefetchLoader(cfg, batch, seq, seed=0,
                                         start_step=start)
        try:
            t0 = time.time()
            for i, (_, host_batch) in zip(range(start, steps), loader):
                params, opt_state, m = step_fn(
                    params, opt_state, to_device(host_batch, dev))
                if on_step is not None:
                    on_step(i, m)
                if (i + 1) % 20 == 0 or i + 1 == steps:
                    log(f"step {i+1:5d} loss={float(m['loss']):.4f} "
                        f"({(i+1-start)/(time.time()-t0):.2f} it/s)")
                if mgr is not None and (i + 1) % ckpt_every == 0:
                    mgr.save(i + 1, {"params": params, "opt": opt_state})
        finally:
            loader.close()
    finally:
        if mgr is not None:
            mgr.close()
    return params, opt_state, start


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-2-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    train(cfg, args.steps, args.batch, args.seq, lr=args.lr,
          ckpt=args.ckpt, ckpt_every=args.ckpt_every, device=args.device,
          log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
