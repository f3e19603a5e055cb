"""MDP state featurization (paper §5.3 State Space + §A.9 bounds).

Per instance (8 dims):
  P_t histogram: resident prompt tokens in 3 buckets (0-256, 256-2048, >2048)
  D_t histogram: resident decoded tokens in the same 3 buckets
  C_t: free capacity fraction
  T_c: estimated earliest completion (clipped, normalized)
Router (4 dims):
  queue length (bounded by 4 x max_batch = 512, as §A.9),
  next request prompt tokens (normalized),
  next request predicted decode bucket,
  head-of-queue waiting time (clipped).

Heterogeneous clusters: every per-instance feature is computed against
that instance's own ``HardwareProfile`` (capacity fraction, earliest
completion, impact score), so mixed-hardware episodes featurize
correctly; the ``profile`` argument is the router-level reference used
only for the head request's decode bucket.

``include_hardware`` appends the instance's calibration constants
(grad1 / grad2 / KV capacity, normalized and clipped to [0, 1]) to each
instance block: with them an agent trained on a MIX of calibrated and
synthetic profiles can condition placement on what the hardware *is*
instead of inferring speed from load dynamics (off by default --
existing checkpoints keep their state shape).

``include_health`` appends the gateway HealthTracker's degradation
score and the instance's slowdown ``1 - 1/speed_factor`` (both in
[0, 1]) so an agent can learn to route around stragglers before the
circuit breaker trips (off by default, same shape-compat reasoning).

This is the port's own copy of the scalar (numpy) featurizer; the
batched featurizers over the vectorized and device-resident simulators
come with those simulators' slices of the port.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.core import impact
from repro_torch.core.profiles import HardwareProfile
from repro_torch.core.simulator import Cluster

BUCKET_EDGES = (256, 2048)          # paper A.9 DQN buckets
N_BUCKETS = len(BUCKET_EDGES) + 1
INSTANCE_DIMS = 2 * N_BUCKETS + 2
ROUTER_DIMS = 4

# per-instance hardware block (optional): grad1 / grad2 / kv-capacity,
# scaled so the paper's V100 and A100 calibrations land mid-range and
# clipped to [0, 1]
HW_DIMS = 3
HW_G1_SCALE = 1e3       # grad1 ~3.2e-4 (V100) -> 0.32
HW_G2_SCALE = 1e4       # grad2 ~3.3e-5 (V100) -> 0.33
HW_CAP_SCALE = 1e-5     # capacity 60k (A100)  -> 0.60

# per-instance prefix-cache block (optional): the head request's
# prospective hit fraction on this instance -- already in [0, 1]
CACHE_DIMS = 1

# per-instance health block (optional): the gateway HealthTracker's
# degradation score (0 = at fleet median, 1 = breaker threshold) and the
# instance's observable slowdown 1 - 1/speed_factor (0 = nominal) --
# both already in [0, 1]
HEALTH_DIMS = 2

_E0, _E1 = BUCKET_EDGES


def instance_dims(include_impact: bool = True,
                  include_hardware: bool = False,
                  include_cache: bool = False,
                  include_health: bool = False) -> int:
    return (INSTANCE_DIMS + (1 if include_impact else 0)
            + (HW_DIMS if include_hardware else 0)
            + (CACHE_DIMS if include_cache else 0)
            + (HEALTH_DIMS if include_health else 0))


def state_dim(m: int, include_impact: bool = True,
              include_hardware: bool = False,
              include_cache: bool = False,
              include_health: bool = False) -> int:
    return instance_dims(include_impact, include_hardware,
                         include_cache, include_health) * m + ROUTER_DIMS


def featurize(cluster: Cluster, profile: HardwareProfile,
              predict_bucket: Optional[Callable] = None,
              n_buckets: int = 8, include_impact: bool = True,
              predict_decode: Optional[Callable] = None,
              alpha: float = 0.5,
              include_hardware: bool = False,
              include_cache: bool = False,
              include_health: bool = False) -> np.ndarray:
    # Featurization runs once per router decision; it is written as a
    # single pass of scalar Python per instance because numpy call
    # overhead dominates at these sizes (a handful of residents).
    head = cluster.central[0] if cluster.central else None
    dims = instance_dims(include_impact, include_hardware,
                         include_cache, include_health)
    health_scores = (getattr(cluster, "health_scores", None)
                     if include_health else None)
    feats = [0.0] * (dims * cluster.m + ROUTER_DIMS)
    if include_impact and head is not None:
        d_hat = (predict_decode(head) if predict_decode
                 else head.decode_tokens)
    for k, inst in enumerate(cluster.instances):
        if inst.failed:
            continue         # failed instance: all-zero block
        prof = inst.profile
        base = k * dims
        scale = inst.n_slots
        p0 = p1 = p2 = d0 = d1 = d2 = 0
        ctx = 0
        min_left = None
        for r in inst.residents:
            p = r.prompt_tokens
            if p < _E0:
                p0 += 1
            elif p < _E1:
                p1 += 1
            else:
                p2 += 1
            d = r.decoded
            if d < _E0:
                d0 += 1
            elif d < _E1:
                d1 += 1
            else:
                d2 += 1
            ctx += r.prefilled + d
            left = r.decode_tokens - d
            if min_left is None or left < min_left:
                min_left = left
        # queued requests carry zero progress: queue context == prompts
        q_prompt = q_ctx = inst.queued_prompt_sum()
        feats[base] = p0 / scale
        feats[base + 1] = p1 / scale
        feats[base + 2] = p2 / scale
        feats[base + 3] = d0 / scale
        feats[base + 4] = d1 / scale
        feats[base + 5] = d2 / scale
        free = (prof.capacity_tokens - ctx - q_prompt) / prof.capacity_tokens
        feats[base + 6] = -1.0 if free < -1.0 else (1.0 if free > 1.0
                                                    else free)
        t_c = (max(min_left, 0) * prof.t_decode_base / 10.0
               if min_left is not None else 0.0)
        feats[base + 7] = 1.0 if t_c > 1.0 else t_c
        if include_impact and head is not None:
            # the workload impact estimator is a router module (§5.2); its
            # per-instance score for the head request is part of the
            # router's observable state.
            score = impact.r_mixing(prof, head.prompt_tokens, d_hat,
                                    ctx + q_ctx, alpha)
            feats[base + 8] = -5.0 if score < -5.0 else (
                1.0 if score > 1.0 else score)
        if include_hardware:
            hb = base + INSTANCE_DIMS + (1 if include_impact else 0)
            g1 = prof.grad1 * HW_G1_SCALE
            feats[hb] = 1.0 if g1 > 1.0 else g1
            g2 = prof.grad2 * HW_G2_SCALE
            feats[hb + 1] = 1.0 if g2 > 1.0 else g2
            cp = prof.capacity_tokens * HW_CAP_SCALE
            feats[hb + 2] = 1.0 if cp > 1.0 else cp
        if include_cache and head is not None \
                and getattr(head, "prefix_hashes", None):
            # prospective hit fraction of the head request on this
            # instance (read-only query; 0 when the cache model is off)
            pc = getattr(inst, "prefix_cache", None)
            if pc is not None:
                cb = base + INSTANCE_DIMS + (1 if include_impact else 0) \
                    + (HW_DIMS if include_hardware else 0)
                feats[cb] = pc.hit_fraction(head.prompt_tokens,
                                            head.prefix_hashes)
        if include_health:
            hlb = base + INSTANCE_DIMS + (1 if include_impact else 0) \
                + (HW_DIMS if include_hardware else 0) \
                + (CACHE_DIMS if include_cache else 0)
            if health_scores is not None and k < len(health_scores):
                feats[hlb] = float(health_scores[k])
            # slowdown 1 - 1/speed: same expression as the vec path
            feats[hlb + 1] = 1.0 - 1.0 / getattr(inst, "speed_factor",
                                                 1.0)
    feats[dims * cluster.m] = min(len(cluster.central), 512) / 512.0
    if head is not None:
        if head.predicted_bucket is not None:
            bucket = head.predicted_bucket
        elif predict_bucket is not None:
            bucket = predict_bucket(head)
        else:
            bucket = profile.bucketize(head.decode_tokens, n_buckets)
        feats[dims * cluster.m + 1] = min(head.prompt_tokens, 2048) / 2048.0
        feats[dims * cluster.m + 2] = bucket / max(n_buckets - 1, 1)
        wait = (cluster.t - head.arrival) / 10.0
        feats[dims * cluster.m + 3] = 1.0 if wait > 1.0 else (
            0.0 if wait < 0.0 else wait)
    return np.asarray(feats, np.float32)


def pad_state(s: np.ndarray, m: int, m_max: int,
              include_impact: bool = True,
              include_hardware: bool = False,
              include_cache: bool = False,
              include_health: bool = False) -> np.ndarray:
    """Pad an m-instance state vector to m_max instance slots (zeros --
    the same encoding as a failed instance) so episodes with different
    cluster shapes share one replay buffer / Q network."""
    if m == m_max:
        return s
    dims = instance_dims(include_impact, include_hardware,
                         include_cache, include_health)
    out = np.zeros(dims * m_max + ROUTER_DIMS, np.float32)
    out[:dims * m] = s[:dims * m]
    out[dims * m_max:] = s[dims * m:]
    return out


def action_mask(cluster: Cluster) -> np.ndarray:
    """[m+1] bool: failed instances masked out; defer always allowed.

    When a gateway stamps a circuit-breaker ``health_mask`` on the
    cluster (serving.chaos.HealthTracker), breakered instances are
    masked out too -- the tracker's guarded fallback ensures the mask
    never excludes the entire alive fleet."""
    m = cluster.m
    mask = np.zeros(m + 1, bool)
    for i, inst in enumerate(cluster.instances):
        mask[i] = not inst.failed
    _apply_health_mask(cluster, mask, m)
    mask[m] = True
    if not cluster.central:          # nothing to route: only defer is valid
        mask[:m] = False
    return mask


def _apply_health_mask(cluster, mask: np.ndarray, m: int):
    hm = getattr(cluster, "health_mask", None)
    if hm is not None:
        k = min(m, len(hm))
        mask[:k] &= np.asarray(hm[:k], bool)


def pad_mask(mask: np.ndarray, m: int, m_max: int) -> np.ndarray:
    """Pad an [m+1] action mask to [m_max+1]: padded instance slots are
    invalid; defer moves to the last position."""
    if m == m_max:
        return mask
    out = np.zeros(m_max + 1, bool)
    out[:m] = mask[:m]
    out[m_max] = mask[m]
    return out
