"""Workload impact estimator (paper §5.2, Eq. 1-2).

Models the latency impact of adding an incoming request (p_i prompt tokens,
d_i estimated decode tokens) to instance m that already serves n requests
with (p_j, d_j) context tokens:

  Eq.(1)  T_p   = grad1 * (p_i^2 + sum_j (p_j + d_j))
          r_p   = 1                if T_p <= eps
                  1 - T_p / eps    otherwise
  Eq.(2)  r_d   = -grad2 * (sum_j (p_j + d_j) + p_i + d_i)

  r_mixing = alpha * r_p + (1 - alpha) * r_d

Note on Eq.(2): the paper's rendering reads ``-grad2 * sum_j(p_j+d_j) + p_i
+ d_i`` which is dimensionally inconsistent with the stated [-1, 1] range;
the intended grouping (confirmed by the range argument in §5.2) applies
grad2 to the whole token sum, which is what we implement.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.profiles import HardwareProfile


def prefill_impact(profile: HardwareProfile, p_i: int,
                   resident_tokens: float) -> float:
    """T_p of Eq.(1): estimated prompt-phase latency impact (seconds)."""
    return profile.grad1 * (float(p_i) ** 2 + resident_tokens)


def prefill_penalty(profile: HardwareProfile, p_i: int,
                    resident_tokens: float) -> float:
    """r_p of Eq.(1)."""
    t_p = prefill_impact(profile, p_i, resident_tokens)
    eps = profile.epsilon
    return 1.0 if t_p <= eps else 1.0 - t_p / eps


def decode_penalty(profile: HardwareProfile, p_i: int, d_i: int,
                   resident_tokens: float) -> float:
    """r_d of Eq.(2)."""
    return -profile.grad2 * (resident_tokens + p_i + d_i)


def r_mixing(profile: HardwareProfile, p_i: int, d_i: int,
             resident_tokens: float, alpha: float = 0.5) -> float:
    """Combined mixing penalty (higher is better)."""
    return (alpha * prefill_penalty(profile, p_i, resident_tokens)
            + (1 - alpha) * decode_penalty(profile, p_i, d_i,
                                           resident_tokens))


def mixing_per_instance(profile: HardwareProfile, p_i: int, d_i: int,
                        resident_token_sums: Sequence[float],
                        alpha: float = 0.5) -> np.ndarray:
    """r_mixing for routing the request to each instance."""
    return np.array([r_mixing(profile, p_i, d_i, s, alpha)
                     for s in resident_token_sums])


def mixing_vec(grad1, grad2, eps, p_i, d_i, s,
               alpha: float = 0.5) -> np.ndarray:
    """Vectorized ``r_mixing`` over per-lane calibration arrays
    (grad1/grad2/epsilon) -- the single implementation behind the
    vecsim fast paths in ``rl_router.mixing_scores`` and
    ``state.featurize_vec_many``.  Mirrors the scalar functions'
    association order on exact-integer token sums, so the produced
    floats are bit-identical to a per-instance ``r_mixing`` loop."""
    t_p = grad1 * (p_i ** 2 + s)
    r_p = np.where(t_p <= eps, 1.0, 1.0 - t_p / eps)
    r_d = -grad2 * (s + p_i + d_i)
    return alpha * r_p + (1 - alpha) * r_d


def mixing_heterogeneous(profiles: Sequence[HardwareProfile], p_i: int,
                         d_i: int, resident_token_sums: Sequence[float],
                         alpha: float = 0.5) -> np.ndarray:
    """r_mixing per instance with per-instance hardware profiles (mixed
    GPU generations behind one router): each instance's impact is judged
    against its own grad1/grad2 calibration."""
    return np.array([r_mixing(prof, p_i, d_i, s, alpha)
                     for prof, s in zip(profiles, resident_token_sums)])


def guidance_h(profile: HardwareProfile, p_i: int, d_i: int,
               resident_token_sums: Sequence[float], chosen: int,
               alpha: float = 0.5) -> float:
    """Eq.(4): h = r_mixing(chosen) - max_l r_mixing(l)  (<= 0; zero iff the
    chosen instance has the least mixing impact)."""
    scores = mixing_per_instance(profile, p_i, d_i, resident_token_sums,
                                 alpha)
    return float(scores[chosen] - scores.max())
