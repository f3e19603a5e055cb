"""Hardware/model cost profiles (the paper's grad1/grad2 calibration).

The paper (§4.2, Fig. 4) characterizes iteration time of an instance as:
  * prefill: grows linearly and fast with prompt tokens  (grad1 s/token)
  * decode:  grows slowly with resident context tokens   (grad2 s/token)
and classifies requests heavy/light by phase-time thresholds (0.5s prompt,
5s decode).  Both gradients are per (model, hardware) calibration constants;
the paper ships Llama-2-7B/V100 numbers, and says to re-profile elsewhere.

We keep the V100 profile as the reproduction default and derive a TPU v5e
profile analytically from the roofline constants.  The engine-side
calibration (``fit``) comes with the port of ``core.calibrate``; this copy
reads a calibrated artifact with :func:`load_profile`.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    grad1: float            # s per prefill token in an iteration (Fig. 4a)
    grad2: float            # s per co-resident context token (Fig. 4b)
    t_decode_base: float    # base decode iteration time (s)
    heavy_prompt_s: float = 0.5    # heavy/light prompt threshold (s)
    heavy_decode_s: float = 5.0    # heavy/light decode threshold (s)
    epsilon: float = 1.0           # Eq.(1) latency-impact tolerance
    capacity_tokens: int = 66_000  # KV pool (token budget) per instance
    max_batch: int = 128           # slot count per instance
    # fixed prefill dispatch overhead per iteration that prefills (s);
    # the intercept of the calibrated prefill fit (core.calibrate).  The
    # paper's Fig. 4 line is forced through the origin, so the shipped
    # V100/A100 profiles keep 0.0 -- behaviour (and the vecsim bit-parity
    # surface) is unchanged unless a calibrated profile sets it.
    t_prefill_base: float = 0.0

    # -- the paper's §4.2 processing-time estimates -----------------------
    def prefill_time(self, p: int) -> float:
        return self.grad1 * p + self.t_prefill_base

    def decode_time(self, d: int) -> float:
        return self.t_decode_base * d

    def request_time(self, p: int, d: int) -> float:
        """p x (time per prompt token) + d x (average decode batch time)."""
        return self.prefill_time(p) + self.decode_time(d)

    def iteration_time(self, prefill_tokens: int, resident_other: int
                       ) -> float:
        """One engine iteration: base + prefill work + decode interference."""
        return (self.t_decode_base + self.grad1 * prefill_tokens
                + self.grad2 * resident_other
                + self.t_prefill_base * (prefill_tokens > 0))

    # -- heavy/light classification (LL/LH/HL/HH) --------------------------
    def prompt_is_heavy(self, p: int) -> bool:
        return self.prefill_time(p) >= self.heavy_prompt_s

    def decode_is_heavy(self, d: int) -> bool:
        return self.decode_time(d) >= self.heavy_decode_s

    def classify(self, p: int, d: int) -> str:
        return (("H" if self.prompt_is_heavy(p) else "L")
                + ("H" if self.decode_is_heavy(d) else "L"))

    # -- decode-bucket edges (§5.1: time-aligned, unequal) ------------------
    def bucket_edges(self, n_buckets: int = 8) -> Tuple[float, ...]:
        """Token-count edges at 0.5 * 4^k second boundaries: 0-0.5s,
        0.5-2s, 2-4s, ... mapped to decode-token counts.  Cached by
        value (the featurizer calls this once per routing decision;
        keying on t_decode_base rather than self avoids pinning every
        recalibrated profile instance in a process-lifetime cache)."""
        return _bucket_edges(self.t_decode_base, n_buckets)

    def bucketize(self, d: int, n_buckets: int = 8) -> int:
        edges = self.bucket_edges(n_buckets)
        return int(np.searchsorted(edges, d, side="right"))


@functools.lru_cache(maxsize=256)
def _bucket_edges(t_decode_base: float, n_buckets: int
                  ) -> Tuple[float, ...]:
    tok_per_s = 1.0 / t_decode_base
    secs = [0.5 * (4 ** k) for k in range(n_buckets - 1)]
    return tuple(s * tok_per_s for s in secs)


# Llama-2-7B on V100 (paper's Fig. 4 calibration).  KV capacity: 16 GB HBM
# - 14 GB fp16 weights = ~2 GB pool / 0.5 MB per token (32L x 4096 x 2 x
# fp16) ~= 4000 tokens -- this small pool is what makes preemption and
# router queueing matter in the paper's experiments.
V100_LLAMA2_7B = HardwareProfile(
    name="v100-llama2-7b", grad1=3.2e-4, grad2=3.3e-5,
    t_decode_base=0.0167, capacity_tokens=4_000, max_batch=128)

# Llama-3.1-8B on A100-40GB (paper §6.2: ~4x faster; re-benchmarked
# gradients; GQA kv=8 -> 128 KB/token -> ~180k tokens; we keep 60k to match
# the paper's observable preemption behaviour at 80 rps on the trace).
A100_LLAMA31_8B = HardwareProfile(
    name="a100-llama31-8b", grad1=8.0e-5, grad2=8.0e-6,
    t_decode_base=0.0042, capacity_tokens=60_000, max_batch=256)


def tpu_v5e_profile(n_params: float, tp: int = 16,
                    name: str = "v5e") -> HardwareProfile:
    """Analytic v5e profile from roofline constants.

    prefill s/token = 2*N / (tp * 197e12 * mfu), decode s/token =
    2*N_bytes / (tp * 819e9) (weights-bound decode).  mfu ~ 0.5 prefill.
    """
    peak = 197e12 * 0.5
    hbm = 819e9
    grad1 = 2 * n_params / (tp * peak)
    t_dec = 2 * n_params / (tp * hbm)          # bf16 weight reads
    grad2 = t_dec * 0.002                      # KV-read marginal cost
    cap = int(tp * 16e9 * 0.4 / 1e5)           # rough KV token budget
    return HardwareProfile(name=name, grad1=grad1, grad2=grad2,
                           t_decode_base=max(t_dec, 1e-4),
                           capacity_tokens=max(cap, 10_000))


def profile_to_json(profile: HardwareProfile) -> dict:
    """A committable artifact for a (calibrated) profile -- plain field
    dict, round-tripped by :func:`profile_from_json`."""
    return dataclasses.asdict(profile)


def profile_from_json(d: dict) -> HardwareProfile:
    """Inverse of :func:`profile_to_json`.  Unknown keys are ignored
    (forward compatibility: newer writers may add diagnostics)."""
    known = {f.name for f in dataclasses.fields(HardwareProfile)}
    return HardwareProfile(**{k: v for k, v in d.items() if k in known})


def load_profile(path: str) -> HardwareProfile:
    """Read a profile from JSON -- either a bare ``profile_to_json``
    dict or a full calibration artifact with a ``profile`` key."""
    with open(path) as f:
        d = json.load(f)
    return profile_from_json(d.get("profile", d))
