"""Serving launcher of the PyTorch port: real LLM engines behind the
paper's impact-heuristic router (twin of ``repro.launch.serve``'s
``--mode engine`` path).

  # reduced engines on the card (the default device)
  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
      --requests 12

  # the same on the CPU (attention through the kernels' plain versions)
  PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
      --requests 12 --device cpu

The gateway, simulator and calibration modes come with later slices of
the port; asking for them exits with a message saying so.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import impact
from repro_torch.core.profiles import V100_LLAMA2_7B, load_profile
from repro_torch.models import params as params_lib
from repro_torch.serving.engine import LLMInstance
from repro_torch.serving.request import Request, summarize
from repro_torch.serving.scheduler import get_scheduler


def _base_profile(args):
    """The serving profile: a calibrated JSON artifact when given,
    else the paper's V100 calibration."""
    if getattr(args, "profile_json", None):
        return load_profile(args.profile_json)
    return V100_LLAMA2_7B


def _tiny_engines(args, capacity: int = 400) -> List[LLMInstance]:
    """Reduced-config engines sharing one seeded set of weights (the
    reference's defaults: 4 slots, 128-token caches)."""
    dev = resolve_device(getattr(args, "device", "cuda"))
    cfg = get_config(args.arch).reduced()
    base = _base_profile(args)
    prof = dataclasses.replace(
        base, capacity_tokens=min(base.capacity_tokens, capacity))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = params_lib.init_params(cfg, gen, device=dev)
    return [LLMInstance(cfg, params, prof,
                        get_scheduler(args.scheduler), n_slots=4,
                        cache_len=128, instance_id=i,
                        prefix_cache_tokens=args.prefix_cache,
                        prefix_block=args.prefix_block, device=dev)
            for i in range(args.instances)]


def engine_requests(n: int) -> List[Request]:
    """The reference's ``--mode engine`` stream: seeded prompt lengths
    10-79 and decode lengths 5-59."""
    rng = np.random.default_rng(0)
    return [Request(prompt_tokens=int(rng.integers(10, 80)),
                    decode_tokens=int(rng.integers(5, 60)))
            for _ in range(n)]


def serve_engine(args, insts: Optional[List[LLMInstance]] = None,
                 reqs: Optional[List[Request]] = None) -> dict:
    """Route each request by the impact heuristic (Eq. 1-2) across the
    engines, step them to completion, print and return ``summarize``.
    Callers may hand in their own engines and requests; by default the
    reduced ``--arch`` engines serve the reference's request stream."""
    if insts is None:
        insts = _tiny_engines(args)
    if reqs is None:
        reqs = engine_requests(args.requests)
    prof = insts[0].profile
    for r in reqs:   # impact-heuristic routing (Eq. 1-2)
        scores = impact.mixing_per_instance(
            prof, r.prompt_tokens, r.decode_tokens,
            [i.resident_tokens() for i in insts])
        insts[int(np.argmax(scores))].submit(r)
        for inst in insts:
            inst.step()
    while sum(len(i.completed) for i in insts) < len(reqs):
        if not any(inst.queue or any(inst.slots) for inst in insts):
            break
        for inst in insts:
            inst.step()
    stats = summarize(reqs)
    print(stats)
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("sim", "engine", "gateway"),
                    default="engine")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines ('cuda' needs a "
                    "card; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("--profile-json", default=None,
                    help="serve with the profile loaded from this JSON "
                    "instead of the default V100 calibration")
    ap.add_argument("--prefix-cache", type=int, default=0,
                    help="per-instance prefix/KV cache budget in "
                    "tokens (0 = cache model off)")
    ap.add_argument("--prefix-block", type=int, default=32,
                    help="prefix-cache hash-block size in tokens")
    ap.add_argument("--arch", default="llama-2-7b")
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--scheduler", default="fcfs")
    args = ap.parse_args(argv)
    if args.mode != "engine":
        sys.exit(f"--mode {args.mode} is not ported yet: the PyTorch port "
                 "serves --mode engine; the gateway and simulator modes "
                 "come with later slices")
    serve_engine(args)


if __name__ == "__main__":
    main()
