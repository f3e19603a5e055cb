"""Engine-calibrated hardware profiles (the paper's Fig. 4 loop; twin of
``repro.core.calibrate``).

The routing stack prices everything -- iteration times, impact scores,
backlog penalties, bucket edges -- with ``HardwareProfile`` constants.
This module fits them from the port's own engine: it sweeps the
functions ``serving.engine.LLMInstance`` runs (``models.model.prefill``
and ``decode_step``) over a prompt grid and a batch x resident-context
grid, takes the best of several interleaved timings of each point, and
recovers the profile by the paper's least-squares line fits:

  prefill:  t(p)    = t_prefill_base + grad1 * p        (batch-1 prompt
            of p tokens -- Fig. 4a)
  decode:   t(B, c) = t_decode_base + grad2 * (B * c)   (gang decode over
            B slots at context c; resident tokens R = B * c -- Fig. 4b)

The clock is the host's, around each call, with ``torch.cuda.synchronize``
before the start and after the call on a CUDA device: the time the engine
pays per iteration, host dispatch included, as the reference's
``block_until_ready`` wall is.  Fit diagnostics (R^2, max-residual band)
come back with the profile; ``CalibrationResult.save`` / ``load_profile``
round-trip it through JSON in the reference's format, so an artifact of
either package loads in the other.

Entry points:
  * ``calibrate_profile(cfg, params) -> HardwareProfile`` -- sweep + fit
    on the device the params live on;
  * ``calibrate(cfg, params) -> CalibrationResult`` -- the same, with
    fits and raw samples attached;
  * ``fit_calibration(prefill_samples, decode_samples)`` -- the pure fit;
  * ``launch.serve --calibrate --profile-json out.json`` -- the CLI.
"""
from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.profiles import (HardwareProfile, V100_LLAMA2_7B,
                                       profile_from_json, profile_to_json)
# the artifact reader lives beside the JSON codec; re-exported so that
# ``calibrate.load_profile`` is the reference's name for it
from repro_torch.core.profiles import load_profile  # noqa: F401


@dataclass(frozen=True)
class CalibrationConfig:
    """Measurement grid + timing discipline for one calibration run (the
    reference's defaults, sized for a reduced config on a CPU).  On a
    CPU, run the sweep with torch pinned to one intra-op thread, as
    ``launch.serve --calibrate`` does: a multi-threaded CPU matmul
    changes its parallel split with size, which reads as piecewise cost
    steps."""
    # batch-1 prompt lengths for the prefill sweep (Fig. 4a x-axis)
    prompt_grid: Tuple[int, ...] = (32, 64, 96, 128, 192, 256)
    # (batch, per-slot context) points for the decode sweep; the fit's
    # x-axis is resident tokens R = batch * context (Fig. 4b)
    decode_grid: Tuple[Tuple[int, int], ...] = (
        (1, 64), (2, 128), (2, 256), (4, 256), (4, 512), (8, 512))
    # gang-decode steps chained in ONE timed call (time / steps is the
    # per-iteration sample); each step consumes the previous one's
    # argmax token, the same dependency chain the engine runs
    decode_steps_per_call: int = 8
    repeats: int = 9              # timed reps per grid point (min taken)
    warmup: int = 2               # discarded warm calls per point
    prefill_cache_len: int = 256  # decode-cache length prefill builds
    seed: int = 0


@dataclass(frozen=True)
class LinearFit:
    """One least-squares line y = slope * x + intercept, with quality."""
    slope: float
    intercept: float
    r2: float                 # coefficient of determination
    residual_band: float      # max |y - fit(x)| over the samples (s)
    n: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def linear_fit(samples: Sequence[Tuple[float, float]]) -> LinearFit:
    """Least-squares line over (x, seconds) samples (Fig. 4 procedure)."""
    if len(samples) < 2:
        raise ValueError("linear_fit needs >= 2 samples")
    x = np.array([s[0] for s in samples], float)
    y = np.array([s[1] for s in samples], float)
    a = np.vstack([x, np.ones_like(x)]).T
    (m, c), *_ = np.linalg.lstsq(a, y, rcond=None)
    pred = m * x + c
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else (
        1.0 if ss_res == 0.0 else 0.0)
    return LinearFit(slope=float(m), intercept=float(c), r2=float(r2),
                     residual_band=float(np.abs(y - pred).max()),
                     n=len(samples))


@dataclass
class CalibrationResult:
    """A fitted profile plus everything needed to audit the fit."""
    profile: HardwareProfile
    prefill_fit: LinearFit
    decode_fit: LinearFit
    prefill_samples: List[Tuple[float, float]]
    decode_samples: List[Tuple[float, float]]

    @property
    def ok(self) -> bool:
        """The shape every sane calibration must have: the per-prefill-
        token cost strictly above the per-resident-token decode
        interference (a full forward vs a KV read), both positive."""
        return (self.profile.grad1 > self.profile.grad2 > 0.0
                and self.profile.t_decode_base > 0.0)

    def to_json(self) -> dict:
        return {
            "profile": profile_to_json(self.profile),
            "prefill_fit": self.prefill_fit.to_json(),
            "decode_fit": self.decode_fit.to_json(),
            "prefill_samples": [list(s) for s in self.prefill_samples],
            "decode_samples": [list(s) for s in self.decode_samples],
        }

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    @classmethod
    def from_json(cls, d: dict) -> "CalibrationResult":
        return cls(
            profile=profile_from_json(d["profile"]),
            prefill_fit=LinearFit(**d["prefill_fit"]),
            decode_fit=LinearFit(**d["decode_fit"]),
            prefill_samples=[tuple(s) for s in d["prefill_samples"]],
            decode_samples=[tuple(s) for s in d["decode_samples"]])


def fit_calibration(prefill_samples: Sequence[Tuple[float, float]],
                    decode_samples: Sequence[Tuple[float, float]],
                    base: HardwareProfile = V100_LLAMA2_7B,
                    name: str = "calibrated") -> CalibrationResult:
    """Pure fit: (tokens, seconds) measurements -> calibrated profile.

    Thresholds (capacity, heavy/light cut-offs, epsilon) are inherited
    from ``base`` -- they are capacity/policy constants, not timings."""
    pf = linear_fit(prefill_samples)
    df = linear_fit(decode_samples)
    profile = replace(
        base, name=name,
        grad1=max(pf.slope, 1e-9),
        grad2=max(df.slope, 1e-12),
        t_decode_base=max(df.intercept, 1e-6),
        t_prefill_base=max(pf.intercept, 0.0))
    return CalibrationResult(profile=profile, prefill_fit=pf,
                             decode_fit=df,
                             prefill_samples=list(prefill_samples),
                             decode_samples=list(decode_samples))


# -- the engine sweep --------------------------------------------------------

def _timed_grid(points, repeats: int, warmup: int,
                device: torch.device) -> List[float]:
    """Host-clock a grid of calls, min-of-``repeats`` each.

    ``points`` is a list of ``(fn, args)``.  All points are warmed first,
    then the timed repetitions are INTERLEAVED round-robin across the
    grid: a transient load spike on a busy host poisons at most one
    sample per point instead of every sample of one point, so the
    per-point min stays a faithful estimate of the undisturbed time.  On
    a CUDA device the card is synchronised before each start and after
    each call."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.no_grad():
        for fn, args in points:
            for _ in range(warmup):
                fn(*args)
                sync()
        best = [float("inf")] * len(points)
        for _ in range(repeats):
            for i, (fn, args) in enumerate(points):
                sync()
                t0 = time.perf_counter()
                fn(*args)
                sync()
                best[i] = min(best[i], time.perf_counter() - t0)
    return best


def sweep_prefill(cfg, params, ccfg: CalibrationConfig
                  ) -> List[Tuple[float, float]]:
    """(prompt tokens, seconds) over the batch-1 prompt grid, each call
    building a fresh cache of ``max(prefill_cache_len, max(grid))``."""
    from repro_torch.models import model as model_lib
    dev = params["embed"].device
    cache_len = max(ccfg.prefill_cache_len, max(ccfg.prompt_grid))

    def prefill(pr, t):
        return model_lib.prefill(pr, cfg, tokens=t, cache_len=cache_len)

    rng = np.random.default_rng(ccfg.seed)
    points = []
    for p in ccfg.prompt_grid:
        toks = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, size=(1, p)), device=dev)
        points.append((prefill, (params, toks)))
    times = _timed_grid(points, ccfg.repeats, ccfg.warmup, dev)
    return [(float(p), t) for p, t in zip(ccfg.prompt_grid, times)]


def sweep_decode(cfg, params, ccfg: CalibrationConfig
                 ) -> List[Tuple[float, float]]:
    """(resident tokens, seconds-per-step) over the (batch, context)
    decode grid: ``decode_steps_per_call`` chained gang-decode steps per
    timed call on a cache of batch x context tokens with ``pos`` at the
    last written position.  The port's cache is updated in place, so
    each call first puts ``pos`` back (one small fill), where the
    reference's functional cache starts every call from it."""
    from repro_torch.models import model as model_lib
    dev = params["embed"].device
    k = max(ccfg.decode_steps_per_call, 1)

    def multi_decode(pr, cache, toks, ctx):
        cache["pos"].fill_(ctx - 1)
        for _ in range(k):
            logits, cache = model_lib.decode_step(pr, cfg, cache,
                                                  tokens=toks)
            toks = torch.argmax(logits, dim=-1)
        return logits, cache

    rng = np.random.default_rng(ccfg.seed + 1)
    points = []
    for batch, ctx in ccfg.decode_grid:
        cache = model_lib.init_cache(cfg, batch, ctx, device=dev)
        toks = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, size=(batch,)), device=dev)
        points.append((multi_decode, (params, cache, toks, ctx)))
    times = _timed_grid(points, ccfg.repeats, ccfg.warmup, dev)
    return [(float(b * c), t / k)
            for (b, c), t in zip(ccfg.decode_grid, times)]


def calibrate(cfg, params, ccfg: Optional[CalibrationConfig] = None,
              base: HardwareProfile = V100_LLAMA2_7B,
              name: Optional[str] = None) -> CalibrationResult:
    """Sweep the engine's functions for ``cfg``/``params`` on the params'
    device and fit a profile."""
    ccfg = ccfg or CalibrationConfig()
    return fit_calibration(
        sweep_prefill(cfg, params, ccfg),
        sweep_decode(cfg, params, ccfg),
        base=base, name=name or f"{cfg.name}-calibrated")


def calibrate_profile(cfg, params,
                      ccfg: Optional[CalibrationConfig] = None,
                      base: HardwareProfile = V100_LLAMA2_7B,
                      name: Optional[str] = None) -> HardwareProfile:
    """The headline entry point: measured engine -> HardwareProfile."""
    return calibrate(cfg, params, ccfg, base=base, name=name).profile


def format_result(res: CalibrationResult) -> str:
    """Human-readable fit report (the --calibrate CLI prints this)."""
    p = res.profile
    lines = [
        f"calibrated profile '{p.name}':",
        f"  grad1          = {p.grad1:.3e} s/prompt-token "
        f"(R^2={res.prefill_fit.r2:.4f}, "
        f"band={res.prefill_fit.residual_band * 1e6:.1f}us, "
        f"n={res.prefill_fit.n})",
        f"  grad2          = {p.grad2:.3e} s/resident-token "
        f"(R^2={res.decode_fit.r2:.4f}, "
        f"band={res.decode_fit.residual_band * 1e6:.1f}us, "
        f"n={res.decode_fit.n})",
        f"  t_decode_base  = {p.t_decode_base:.3e} s",
        f"  t_prefill_base = {p.t_prefill_base:.3e} s",
        f"  sanity (grad1 > grad2 > 0): {'OK' if res.ok else 'FAILED'}",
    ]
    return "\n".join(lines)
