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

This is the port's own copy of the featurizers: the scalar path, the
batched one over the vectorized simulator (``featurize_vec_many``), and
its twin on the device-resident pool's device (``featurize_jax_many``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

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
    if getattr(cluster, "is_vec", False):
        # vecsim backend: read the packed per-slot arrays directly
        # (bit-identical features, no Python object scans)
        return _featurize_vec(cluster, profile, predict_bucket,
                              n_buckets, include_impact,
                              predict_decode, alpha, include_hardware,
                              include_cache, include_health)
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


def _featurize_vec(cluster, profile: HardwareProfile,
                   predict_bucket, n_buckets: int, include_impact: bool,
                   predict_decode, alpha: float,
                   include_hardware: bool = False,
                   include_cache: bool = False,
                   include_health: bool = False) -> np.ndarray:
    """Featurize straight from a VecCluster's packed structure-of-arrays
    state -- the single-cluster view of :func:`featurize_vec_many`."""
    return featurize_vec_many(
        [cluster], [profile], [predict_decode], n_buckets=n_buckets,
        include_impact=include_impact, alpha=alpha,
        predict_buckets=[predict_bucket],
        include_hardware=include_hardware,
        include_cache=include_cache, include_health=include_health)[0]


def featurize_vec_many(clusters, profiles, predict_decodes,
                       n_buckets: int = 8, include_impact: bool = True,
                       alpha: float = 0.5, predict_buckets=None,
                       include_hardware: bool = False,
                       include_cache: bool = False,
                       include_health: bool = False):
    """Featurize MANY VecClusters sharing one pool in a single
    vectorized pass over the concatenated lane set (the batched
    trainer's per-round state build: one set of matrix ops instead of
    one per episode).  Every expression mirrors the scalar path's
    association order on exact-integer values, so the produced float32
    vectors are bit-identical to ``featurize`` on the Python stepper
    (asserted by tests/test_vecsim.py)."""
    pool = clusters[0].pool
    lanes_cat = np.concatenate([c.lane_ids for c in clusters])
    n = lanes_cat.size
    hw = pool._hw
    heads = [c.central[0] if c.central else None for c in clusters]
    dims = instance_dims(include_impact, include_hardware,
                         include_cache, include_health)
    occ = pool.s_state[:, :hw][lanes_cat] != 0
    p = pool.s_prompt[:, :hw][lanes_cat]
    d = pool.s_decoded[:, :hw][lanes_cat]
    ctx = ((pool.s_prefilled[:, :hw][lanes_cat] + d) * occ).sum(1)
    left = (pool.s_dtotal[:, :hw][lanes_cat] - d) + ~occ * (1 << 62)
    min_left = left.min(1) if hw else np.zeros(n, np.int64)
    has_res = occ.any(1) if hw else np.zeros(n, bool)
    lo_p, hi_p = (p < _E0) & occ, (p >= _E1) & occ
    lo_d, hi_d = (d < _E0) & occ, (d >= _E1) & occ
    scale = pool.nslots[lanes_cat]
    block = np.zeros((n, dims))
    block[:, 0] = lo_p.sum(1) / scale
    block[:, 1] = (occ & ~lo_p & ~hi_p).sum(1) / scale
    block[:, 2] = hi_p.sum(1) / scale
    block[:, 3] = lo_d.sum(1) / scale
    block[:, 4] = (occ & ~lo_d & ~hi_d).sum(1) / scale
    block[:, 5] = hi_d.sum(1) / scale
    q_prompt = pool.qps[lanes_cat]
    cap = pool.cap[lanes_cat]
    free = (cap - ctx - q_prompt) / cap
    block[:, 6] = np.minimum(1.0, np.maximum(-1.0, free))
    t_c = np.maximum(min_left, 0) * pool.tdec[lanes_cat] / 10.0
    block[:, 7] = np.where(t_c > 1.0, 1.0, t_c) * has_res
    alive = ~pool.failed[lanes_cat]
    if include_impact:
        p_head, d_head, has_head = _impact_heads(clusters, heads,
                                                 predict_decodes, n)
        score = impact.mixing_vec(
            pool.grad1[lanes_cat], pool.grad2[lanes_cat],
            pool.eps_lat[lanes_cat], p_head, d_head, ctx + q_prompt,
            alpha)
        block[:, 8] = (np.minimum(1.0, np.maximum(-5.0, score))
                       * has_head)
    if include_hardware:
        hb = INSTANCE_DIMS + (1 if include_impact else 0)
        block[:, hb] = np.minimum(pool.grad1[lanes_cat] * HW_G1_SCALE,
                                  1.0)
        block[:, hb + 1] = np.minimum(pool.grad2[lanes_cat]
                                      * HW_G2_SCALE, 1.0)
        block[:, hb + 2] = np.minimum(pool.cap[lanes_cat]
                                      * HW_CAP_SCALE, 1.0)
    if include_cache:
        _fill_cache_col(block, clusters, heads, pool, include_impact,
                        include_hardware)
    if include_health:
        _fill_health_cols(block, clusters, pool, lanes_cat,
                          include_impact, include_hardware,
                          include_cache)
    block *= alive[:, None]
    return _assemble(block, clusters, heads, profiles,
                     predict_buckets, dims, n_buckets)


def _impact_heads(clusters, heads, predict_decodes, n):
    """Per-lane head-of-queue prompt/decode arrays (host: reads Request
    objects) shared by the numpy and device featurize paths."""
    p_head = np.zeros(n)
    d_head = np.zeros(n)
    has_head = np.zeros(n, bool)
    pos = 0
    for c, head, pd in zip(clusters, heads, predict_decodes):
        if head is not None:
            d_hat = pd(head) if pd else head.decode_tokens
            p_head[pos:pos + c.m] = head.prompt_tokens
            d_head[pos:pos + c.m] = d_hat
            has_head[pos:pos + c.m] = True
        pos += c.m
    return p_head, d_head, has_head


def _fill_cache_col(block, clusters, heads, pool, include_impact,
                    include_hardware):
    # PrefixCache queries are plain dict lookups on the SAME object
    # the stepping code mutates, so this scalar loop produces the
    # exact floats the scalar path does
    cb = (INSTANCE_DIMS + (1 if include_impact else 0)
          + (HW_DIMS if include_hardware else 0))
    pos_c = 0
    for c, head in zip(clusters, heads):
        hashes = (getattr(head, "prefix_hashes", None)
                  if head is not None else None)
        if hashes:
            for j, lane in enumerate(c.lane_ids):
                pc = pool.lane_cache[int(lane)]
                if pc is not None:
                    block[pos_c + j, cb] = pc.hit_fraction(
                        head.prompt_tokens, hashes)
        pos_c += c.m


def _fill_health_cols(block, clusters, pool, lanes_cat, include_impact,
                      include_hardware, include_cache):
    hlb = (INSTANCE_DIMS + (1 if include_impact else 0)
           + (HW_DIMS if include_hardware else 0)
           + (CACHE_DIMS if include_cache else 0))
    pos_h = 0
    for c in clusters:
        hs = getattr(c, "health_scores", None)
        if hs is not None:
            k = min(c.m, len(hs))
            block[pos_h:pos_h + k, hlb] = np.asarray(hs)[:k]
        pos_h += c.m
    # slowdown 1 - 1/speed: elementwise match of the scalar path
    block[:, hlb + 1] = 1.0 - 1.0 / pool.speed[lanes_cat]


def _assemble(block, clusters, heads, profiles, predict_buckets, dims,
              n_buckets):
    """Per-cluster state vectors from the [n, dims] lane block plus the
    4 router dims (host floats; identical on every backend)."""
    out = []
    pos = 0
    if predict_buckets is None:
        predict_buckets = [None] * len(clusters)
    for c, head, prof, pb in zip(clusters, heads, profiles,
                                 predict_buckets):
        m = c.m
        feats = np.zeros(dims * m + ROUTER_DIMS)
        feats[:dims * m] = block[pos:pos + m].ravel()
        pos += m
        feats[dims * m] = min(len(c.central), 512) / 512.0
        if head is not None:
            if head.predicted_bucket is not None:
                bucket = head.predicted_bucket
            elif pb is not None:
                bucket = pb(head)
            else:
                bucket = prof.bucketize(head.decode_tokens, n_buckets)
            feats[dims * m + 1] = min(head.prompt_tokens, 2048) / 2048.0
            feats[dims * m + 2] = bucket / max(n_buckets - 1, 1)
            wait = (c.t - head.arrival) / 10.0
            feats[dims * m + 3] = 1.0 if wait > 1.0 else (
                0.0 if wait < 0.0 else wait)
        out.append(feats.astype(np.float32))
    return out


def _device_block(st, p, d, pf, dtot, qps, cap, nslots, tdec, grad1,
                  grad2, eps_lat, p_head, d_head, has_head, alpha: float,
                  include_impact: bool, include_hardware: bool):
    """The per-lane instance block of ``featurize_vec_many`` in float64
    torch ops: the same expressions in the same association order, each
    product and sum its own op (so nothing contracts into an FMA)."""
    occ = st != 0
    ctx = ((pf + d) * occ).sum(1)
    left = (dtot - d) + (~occ).long() * (1 << 62)
    min_left = left.min(1).values
    has_res = occ.any(1)
    lo_p, hi_p = (p < _E0) & occ, (p >= _E1) & occ
    lo_d, hi_d = (d < _E0) & occ, (d >= _E1) & occ
    scale = nslots.double()
    cols = [m.sum(1).double() / scale
            for m in (lo_p, occ & ~lo_p & ~hi_p, hi_p,
                      lo_d, occ & ~lo_d & ~hi_d, hi_d)]
    free = (cap - ctx - qps) / cap
    cols.append(torch.clamp(free, min=-1.0, max=1.0))
    t_c = torch.clamp(min_left, min=0).double() * tdec / 10.0
    cols.append(torch.where(t_c > 1.0, 1.0, t_c) * has_res)
    if include_impact:
        # impact.mixing_vec, written out
        s = ctx + qps
        t_p = grad1 * (p_head * p_head + s)
        r_p = torch.where(t_p <= eps_lat, 1.0, 1.0 - t_p / eps_lat)
        r_d = -grad2 * (s + p_head + d_head)
        score = alpha * r_p + (1 - alpha) * r_d
        cols.append(torch.clamp(score, min=-5.0, max=1.0) * has_head)
    if include_hardware:
        cols.append(torch.clamp(grad1 * HW_G1_SCALE, max=1.0))
        cols.append(torch.clamp(grad2 * HW_G2_SCALE, max=1.0))
        cols.append(torch.clamp(cap * HW_CAP_SCALE, max=1.0))
    return torch.stack(cols, 1)


def featurize_jax_many(clusters, profiles, predict_decodes,
                       n_buckets: int = 8, include_impact: bool = True,
                       alpha: float = 0.5, predict_buckets=None,
                       include_hardware: bool = False,
                       include_cache: bool = False,
                       include_health: bool = False):
    """Device twin of ``featurize_vec_many`` over a device-resident pool
    (``core.jaxsim.JaxSimPool``): the per-lane instance block
    (histograms, capacity fraction, earliest completion, impact, hardware
    constants) is computed in float64 torch ops on the pool's device with
    the numpy path's association order, so the float32 vectors are
    bit-equal to ``featurize_vec_many``.  The cache and health columns
    read host Python objects (PrefixCache dicts, gateway health trackers)
    and are filled on the host exactly as the numpy path fills them."""
    pool = clusters[0].pool
    dev = pool.device
    lanes_cat = np.concatenate([c.lane_ids for c in clusters])
    n = lanes_cat.size
    hw = pool._hw
    heads = [c.central[0] if c.central else None for c in clusters]
    dims = instance_dims(include_impact, include_hardware,
                         include_cache, include_health)
    block = np.zeros((n, dims))
    if include_impact:
        p_head, d_head, has_head = _impact_heads(clusters, heads,
                                                 predict_decodes, n)
    else:
        p_head = d_head = np.zeros(n)
        has_head = np.zeros(n, bool)
    # hw == 0 (fresh pool, nothing ever resident): one all-empty dummy
    # slot column keeps shapes non-degenerate and gives the numpy path's
    # values (occ is all-False: histograms 0, T_c masked by has_res)
    w = max(hw, 1)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    core = _device_block(
        on_dev(pool.s_state[:, :w][lanes_cat]),
        *(on_dev(a[:, :w][lanes_cat]) for a in (
            pool.s_prompt, pool.s_decoded, pool.s_prefilled,
            pool.s_dtotal)),
        *(on_dev(a[lanes_cat]) for a in (
            pool.qps, pool.cap, pool.nslots, pool.tdec, pool.grad1,
            pool.grad2, pool.eps_lat)),
        on_dev(p_head), on_dev(d_head), on_dev(has_head), alpha,
        include_impact, include_hardware)
    ncore = (INSTANCE_DIMS + (1 if include_impact else 0)
             + (HW_DIMS if include_hardware else 0))
    block[:, :ncore] = core.cpu().numpy()
    if include_cache:
        _fill_cache_col(block, clusters, heads, pool, include_impact,
                        include_hardware)
    if include_health:
        _fill_health_cols(block, clusters, pool, lanes_cat,
                          include_impact, include_hardware,
                          include_cache)
    block *= ~pool.failed[lanes_cat][:, None]
    return _assemble(block, clusters, heads, profiles,
                     predict_buckets, dims, n_buckets)


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
    if getattr(cluster, "is_vec", False):
        if cluster.central:
            mask[:m] = ~cluster.pool.failed[cluster.lane_ids]
            _apply_health_mask(cluster, mask, m)
        mask[m] = True
        return mask
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
