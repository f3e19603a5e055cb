"""Synthetic workload matching the paper's 5-task mixture (Table 1) plus a
production-trace-style generator (§A.12).

Table 1 statistics reproduced (mean prompt / mean decode tokens, share):
  books   translation       29.09 /  61.76   (7351 samples)
  eli5    qna               29.83 / 334.40   (6988)
  imdb    sentiment        211.54 / 142.53   (6564)
  squad   in-context qna   125.16 / 220.02   (7122)
  wnut    entity recogn.    26.41 /  64.10   (3304)

Prompt/decode lengths are lognormal with task-specific parameters tuned to
these means; prompts are capped at 1000 tokens (§A.4).  Each sample also
carries a synthetic token sequence whose *content* statistically encodes the
task (tasks use distinct vocabulary bands) so that a content-only classifier
can recover the task with ~94% accuracy -- mirroring §A.7 -- while the
decode length depends on the task AND latent per-request factors, so that
the task hint materially improves bucket prediction (§5.1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.profiles import (A100_LLAMA31_8B, V100_LLAMA2_7B,
                                 HardwareProfile)
from repro_torch.serving.request import Request

MAX_PROMPT = 1000

TASKS = ("translation", "qna", "sentiment", "in_context_qna", "entity")

# task -> (prompt lognorm (mu, sigma), decode lognorm (mu, sigma), weight)
_SPEC = {
    "translation":    ((3.20, 0.55), (3.85, 0.70), 7351),
    "qna":            ((3.25, 0.50), (5.45, 0.85), 6988),
    "sentiment":      ((5.20, 0.45), (4.70, 0.75), 6564),
    "in_context_qna": ((4.70, 0.50), (5.15, 0.70), 7122),
    "entity":         ((3.10, 0.55), (3.90, 0.65), 3304),
}

# synthetic vocabulary: tasks draw 70% of tokens from a private band
VOCAB = 8192
_BAND = 1024
_COMMON = 3 * _BAND        # tokens [0, 3072) are shared filler


def _lognormal_int(rng, mu, sigma, lo, hi, size):
    x = rng.lognormal(mu, sigma, size=size)
    return np.clip(x, lo, hi).astype(np.int64)


@dataclass
class Sample:
    task: str
    task_id: int
    prompt_tokens: int
    decode_tokens: int
    token_ids: np.ndarray          # synthetic prompt content (len <= 64)


def generate(n: int, seed: int = 0,
             tasks: Optional[Sequence[str]] = None) -> List[Sample]:
    rng = np.random.default_rng(seed)
    tasks = tuple(tasks or TASKS)
    weights = np.array([_SPEC[t][2] for t in tasks], float)
    weights /= weights.sum()
    choice = rng.choice(len(tasks), size=n, p=weights)
    out: List[Sample] = []
    for i in range(n):
        t = tasks[choice[i]]
        (pmu, psig), (dmu, dsig), _ = _SPEC[t]
        p = int(_lognormal_int(rng, pmu, psig, 4, MAX_PROMPT, None))
        # decode depends on the task and (weakly) on prompt length, plus a
        # latent factor shared with the content -- predictable with task
        # hint, much harder without.
        latent = rng.normal(0, 0.25)
        # cap so p + d stays below the V100 KV pool (requests larger than
        # the pool can never be served -- vLLM would reject them)
        d = int(np.clip(np.exp(dmu + dsig * (0.55 * rng.normal() + latent)
                               + 0.05 * np.log(max(p, 1))),
                        1, 2800))
        tid = TASKS.index(t)
        band_lo = _COMMON + tid * _BAND
        n_tok = min(48, max(6, p // 8))
        private = rng.integers(band_lo, band_lo + _BAND, size=n_tok)
        common = rng.integers(0, _COMMON, size=n_tok)
        # weak content->task signal (the paper's DistilBERT recovers the
        # task from content at 93.79%, not perfectly -- §A.7)
        mask = rng.random(n_tok) < 0.30
        toks = np.where(mask, private, common).astype(np.int32)
        # content carries the latent factor through token parity (a weak,
        # learnable signal): bias low/high halves of the band
        shift = int(latent > 0)
        toks = np.where(mask, band_lo + ((toks - band_lo)
                                         % (_BAND // 2)) + shift
                        * (_BAND // 2), toks).astype(np.int32)
        out.append(Sample(t, tid, p, d, toks))
    return out


def to_requests(samples: Sequence[Sample], rate: float, seed: int = 0,
                ) -> List[Request]:
    """Poisson arrivals at ``rate`` req/s."""
    rng = np.random.default_rng(seed + 17)
    gaps = rng.exponential(1.0 / rate, size=len(samples))
    t = np.cumsum(gaps)
    reqs = []
    for s, at in zip(samples, t):
        reqs.append(Request(prompt_tokens=s.prompt_tokens,
                            decode_tokens=s.decode_tokens,
                            arrival=float(at), task=s.task))
    return reqs


def table1_stats(samples: Sequence[Sample], profile) -> dict:
    """Per-task mean prompt/decode and heavy-decode share (Table 1)."""
    rows = {}
    for t in TASKS:
        sub = [s for s in samples if s.task == t]
        if not sub:
            continue
        rows[t] = {
            "n": len(sub),
            "prompt_mean": float(np.mean([s.prompt_tokens for s in sub])),
            "decode_mean": float(np.mean([s.decode_tokens for s in sub])),
            "heavy_decode": float(np.mean(
                [profile.decode_is_heavy(s.decode_tokens) for s in sub])),
        }
    return rows


# -- production-trace-style workload (§A.12) --------------------------------

TRACE_APPS = ("summarize", "chat", "search", "autocomplete")
# long prompts, short decodes (trace: mean prompt 5526, mean decode 113)
_TRACE_SPEC = {
    "summarize":    ((8.65, 0.40), (4.20, 0.50), 0.35),
    "chat":         ((7.20, 0.60), (5.00, 0.60), 0.20),
    "search":       ((8.40, 0.45), (3.00, 0.55), 0.30),
    "autocomplete": ((7.80, 0.50), (2.20, 0.50), 0.15),
}


def arrival_times(n: int, rate: float, pattern: str = "poisson",
                  seed: int = 0, burst_factor: float = 6.0,
                  burst_persistence: float = 0.96,
                  period: float = 240.0, depth: float = 0.8) -> np.ndarray:
    """Arrival timestamps for ``n`` requests at mean rate ``rate`` req/s.

    poisson -- homogeneous Poisson (the paper's setup).
    bursty  -- two-state Markov-modulated Poisson: an ON state at
               ``burst_factor`` x base intensity and a quiet OFF state,
               state re-drawn per arrival with ``burst_persistence``
               (traffic spikes like Fig. 5's incident windows).
    diurnal -- inhomogeneous Poisson with sinusoidal intensity
               rate(t) = rate * (1 + depth * sin(2 pi t / period)),
               sampled by thinning (day/night load swing, compressed to
               an episode-sized ``period``).
    """
    rng = np.random.default_rng(seed + 23)
    if pattern == "poisson":
        return np.cumsum(rng.exponential(1.0 / rate, size=n))
    if pattern == "bursty":
        # ~half the arrivals occur in ON bursts at burst_factor x the
        # nominal intensity; the OFF intensity is solved so the realized
        # long-run rate (the HARMONIC mean over per-arrival states) is
        # ~rate:  0.5*(1/r_on + 1/r_off) = 1/rate.
        r_on = burst_factor * rate
        r_off = burst_factor * rate / (2.0 * burst_factor - 1.0)
        out = np.empty(n)
        t, on = 0.0, bool(rng.random() < 0.5)
        for i in range(n):
            t += rng.exponential(1.0 / (r_on if on else r_off))
            out[i] = t
            if rng.random() > burst_persistence:
                on = not on
        return out
    if pattern == "diurnal":
        r_max = rate * (1.0 + depth)
        out = np.empty(n)
        t, i = 0.0, 0
        while i < n:
            t += rng.exponential(1.0 / r_max)
            r_t = rate * (1.0 + depth * np.sin(2 * np.pi * t / period))
            if rng.random() * r_max < r_t:
                out[i] = t
                i += 1
        return out
    raise ValueError(f"unknown arrival pattern: {pattern}")


# -- heterogeneous multi-episode scenarios (batched RL training) -------------

ARRIVAL_PATTERNS = ("poisson", "bursty", "diurnal")
PROFILE_POOL = (V100_LLAMA2_7B, A100_LLAMA31_8B)


@dataclass
class Scenario:
    """One training episode: a request stream plus the cluster shape it
    runs on (per-instance hardware profiles -- mixed generations
    allowed).  ``samples`` (when kept) aligns 1:1 with ``requests`` and
    carries the synthetic prompt content the length predictor consumes
    (oracle-free routing)."""
    requests: List[Request]
    profiles: Tuple[HardwareProfile, ...]
    name: str = "scenario"
    pattern: str = "poisson"
    rate: float = 0.0
    seed: int = 0
    meta: dict = field(default_factory=dict)
    samples: Optional[List[Sample]] = None

    @property
    def m(self) -> int:
        return len(self.profiles)

    @classmethod
    def homogeneous(cls, profile: HardwareProfile, m: int,
                    requests: Sequence[Request], **kw) -> "Scenario":
        return cls(requests=list(requests), profiles=(profile,) * m, **kw)


def make_scenario(seed: int,
                  profile_pool: Sequence[HardwareProfile] = PROFILE_POOL,
                  n_requests: int = 200,
                  m_range: Tuple[int, int] = (2, 6),
                  rate_per_speed: Tuple[float, float] = (3.5, 6.5),
                  patterns: Sequence[str] = ARRIVAL_PATTERNS,
                  hetero_prob: float = 0.5,
                  profiles: Optional[Sequence[HardwareProfile]] = None
                  ) -> Scenario:
    """Sample one heterogeneous-cluster episode.

    Cluster width, hardware mix, arrival pattern, task mix, and load are
    all drawn from ``seed`` (deterministic).  The arrival rate scales
    with the sampled cluster's aggregate decode speed so that every
    episode is loaded-but-serviceable, and decode lengths are clipped so
    every request fits the smallest sampled KV pool (unserviceable
    requests would never complete).

    ``profiles`` pins the exact cluster (width and per-instance
    hardware) instead of sampling it -- e.g. a mix of engine-calibrated
    and synthetic profiles (``core.calibrate``) so the trained agent
    sees real hardware among the synthetic draws; arrivals and the task
    mix still vary with ``seed``."""
    rng = np.random.default_rng(seed)
    if profiles is not None:
        profiles = tuple(profiles)
        m = len(profiles)
    else:
        m = int(rng.integers(m_range[0], m_range[1] + 1))
        pool = list(profile_pool)
        if len(pool) > 1 and rng.random() < hetero_prob:
            profiles = tuple(pool[i]
                             for i in rng.integers(0, len(pool), m))
        else:
            profiles = (pool[int(rng.integers(0, len(pool)))],) * m
    pattern = str(patterns[int(rng.integers(0, len(patterns)))])
    # aggregate service speed relative to the V100 reference
    speed = sum(V100_LLAMA2_7B.t_decode_base / p.t_decode_base
                for p in profiles)
    rate = float(rng.uniform(*rate_per_speed)) * speed
    # workload mix: full 5-task mixture or a random >=2-task slice
    if rng.random() < 0.5:
        tasks = None
    else:
        k = int(rng.integers(2, len(TASKS) + 1))
        tasks = tuple(TASKS[i] for i in rng.permutation(len(TASKS))[:k])
    samples = generate(n_requests, seed=seed + 1, tasks=tasks)
    times = arrival_times(n_requests, rate, pattern, seed=seed + 2)
    cap = min(p.capacity_tokens for p in profiles)
    budget = int(cap * 0.95)
    reqs = []
    for s, at in zip(samples, times):
        d = min(s.decode_tokens, max(budget - s.prompt_tokens, 1))
        reqs.append(Request(prompt_tokens=s.prompt_tokens, decode_tokens=d,
                            arrival=float(at), task=s.task))
    return Scenario(requests=reqs, profiles=profiles,
                    name=f"scn{seed}-{pattern}-m{m}", pattern=pattern,
                    rate=rate, seed=seed,
                    meta={"tasks": tasks or TASKS, "speed": speed},
                    samples=samples)


# tenant -> (traffic share, task mix or None for the full mixture);
# the default gateway mix: a latency-sensitive chat tenant, a heavy
# summarization-style tenant, and a long-tail tenant on the full mixture
DEFAULT_TENANTS = {
    "chat": (0.45, ("qna", "translation")),
    "batch": (0.30, ("sentiment", "in_context_qna")),
    "misc": (0.25, None),
}


@dataclass(frozen=True)
class SessionConfig:
    """Conversation-session shape for ``make_tenant_scenario``.

    All lengths are in prefix-cache blocks of ``block`` tokens so a
    turn's prompt is exactly the hash chain it claims to cover: turn k
    re-sends the whole context so far (system prompt + prior turns +
    new user input) and its reply extends the chain the NEXT turn's
    prompt starts from.  Sessions of one tenant share the tenant's
    system-prompt blocks, so even first turns can hit a warm cache."""
    block: int = 32                        # tokens per hash block
    turns: Tuple[int, int] = (2, 5)        # turns per session (incl.)
    think_time: float = 2.0                # mean gap after a reply (s)
    sys_blocks: int = 2                    # shared system prompt
    user_blocks: Tuple[int, int] = (1, 3)  # new user input per turn
    reply_blocks: Tuple[int, int] = (1, 3)  # assistant reply per turn
    max_blocks: int = 24                   # session context cap


def _session_requests(rng, sc: SessionConfig, names, assign, starts,
                      pools, budget_blocks: int,
                      ref: HardwareProfile, seed: int):
    """Grow every session turn by turn -> (requests, samples), arrival
    order not yet established (follow-ups interleave across sessions)."""
    B = sc.block
    reqs: List[Request] = []
    samples: List[Sample] = []
    for sid, (k, t0) in enumerate(zip(assign, starts)):
        tname = names[int(k)]
        n_turns = int(rng.integers(sc.turns[0], sc.turns[1] + 1))
        # tenant-shared system prefix, then session-private blocks
        chain: list = [("sys", tname, j) for j in range(sc.sys_blocks)]
        p_blocks = sc.sys_blocks + int(
            rng.integers(sc.user_blocks[0], sc.user_blocks[1] + 1))
        t = float(t0)
        for _turn in range(n_turns):
            d_blocks = int(rng.integers(sc.reply_blocks[0],
                                        sc.reply_blocks[1] + 1))
            if p_blocks + d_blocks > budget_blocks:
                break               # context would outgrow the KV pool
            while len(chain) < p_blocks + d_blocks:
                chain.append((seed, sid, len(chain)))
            s = pools[tname].pop()
            s.prompt_tokens = p_blocks * B
            s.decode_tokens = d_blocks * B
            reqs.append(Request(
                prompt_tokens=p_blocks * B, decode_tokens=d_blocks * B,
                arrival=t, task=s.task, tenant=tname,
                prefix_hashes=tuple(chain[:p_blocks]),
                full_hashes=tuple(chain[:p_blocks + d_blocks])))
            samples.append(s)
            # the follow-up arrives after the reply streams back plus a
            # think-time gap (open loop: an estimate, not the realized
            # completion time, so arrivals stay policy-independent)
            t += ref.request_time(p_blocks * B, d_blocks * B) \
                + float(rng.exponential(sc.think_time))
            p_blocks = p_blocks + d_blocks + int(
                rng.integers(sc.user_blocks[0], sc.user_blocks[1] + 1))
    return reqs, samples


def make_tenant_scenario(seed: int,
                         tenants: Optional[dict] = None,
                         n_requests: int = 400,
                         rate: float = 16.0,
                         pattern: str = "bursty",
                         profiles: Sequence[HardwareProfile] = (
                             V100_LLAMA2_7B,) * 4,
                         sessions: Optional[SessionConfig] = None,
                         **arrival_kw) -> Scenario:
    """Multi-tenant open-loop arrival stream for the serving gateway.

    Each tenant gets a traffic share and its own task mix (Table-1 task
    subsets -- tenants with different prompt/decode shapes are what make
    per-tenant SLO breakdowns interesting); arrivals follow one shared
    poisson/bursty/diurnal process.  Requests carry ``tenant`` labels
    and the scenario keeps ``samples`` so the learned length predictor
    (not the oracle) can sit in the routing loop.

    With ``sessions`` set, the stream is made of multi-turn
    conversations instead of independent queries: each follow-up's
    prompt extends the prior turn's full context (prompt + reply), every
    request carries the per-block ``prefix_hashes`` / ``full_hashes``
    chains the prefix-cache model consumes, and sessions of one tenant
    share that tenant's system-prompt blocks.  The arrival process
    drives session STARTS (at rate / mean-turns so the realized request
    rate stays ~``rate``); follow-ups land after an estimated reply
    stream plus an exponential think-time gap."""
    tenants = dict(tenants or DEFAULT_TENANTS)
    if sessions is not None:
        profiles = tuple(profiles)
        rng = np.random.default_rng(seed)
        names = sorted(tenants)
        w = np.array([tenants[t][0] for t in names], float)
        w /= w.sum()
        mean_turns = (sessions.turns[0] + sessions.turns[1]) / 2.0
        n_sessions = max(int(np.ceil(n_requests / mean_turns)), 1)
        starts = arrival_times(n_sessions, rate / mean_turns, pattern,
                               seed=seed + 3, **arrival_kw)
        assign = rng.choice(len(names), size=n_sessions, p=w)
        # one content sample per potential turn, per tenant task mix
        pools = {}
        for k, t in enumerate(names):
            count = (int(np.sum(assign == k)) * sessions.turns[1]
                     + 1)
            pools[t] = list(reversed(generate(
                count, seed=seed + 101 * (k + 1), tasks=tenants[t][1])))
        budget_blocks = min(
            int(min(p.capacity_tokens for p in profiles) * 0.95)
            // sessions.block, sessions.max_blocks)
        reqs, samples = _session_requests(
            rng, sessions, names, assign, starts, pools, budget_blocks,
            profiles[0], seed)
        order = np.argsort([r.arrival for r in reqs], kind="stable")
        reqs = [reqs[int(i)] for i in order[:n_requests]]
        samples = [samples[int(i)] for i in order[:n_requests]]
        return Scenario(requests=reqs, profiles=profiles,
                        name=f"sessions{seed}-{pattern}",
                        pattern=pattern, rate=rate, seed=seed,
                        meta={"tenants": {t: tenants[t][0]
                                          for t in names},
                              "sessions": n_sessions,
                              "block": sessions.block},
                        samples=samples)
    profiles = tuple(profiles)
    rng = np.random.default_rng(seed)
    names = sorted(tenants)
    w = np.array([tenants[t][0] for t in names], float)
    w /= w.sum()
    assign = rng.choice(len(names), size=n_requests, p=w)
    # per-tenant sample pools drawn with that tenant's task mix
    pools = {}
    for k, t in enumerate(names):
        count = int(np.sum(assign == k))
        pools[t] = list(reversed(generate(
            count, seed=seed + 101 * (k + 1), tasks=tenants[t][1])))
    times = arrival_times(n_requests, rate, pattern, seed=seed + 3,
                          **arrival_kw)
    budget = int(min(p.capacity_tokens for p in profiles) * 0.95)
    reqs: List[Request] = []
    samples: List[Sample] = []
    for k, at in zip(assign, times):
        t = names[k]
        s = pools[t].pop()
        d = min(s.decode_tokens, max(budget - s.prompt_tokens, 1))
        reqs.append(Request(prompt_tokens=s.prompt_tokens,
                            decode_tokens=d, arrival=float(at),
                            task=s.task, tenant=t))
        samples.append(s)
    return Scenario(requests=reqs, profiles=profiles,
                    name=f"tenants{seed}-{pattern}", pattern=pattern,
                    rate=rate, seed=seed,
                    meta={"tenants": {t: tenants[t][0] for t in names}},
                    samples=samples)


def scenario_stream(base_seed: int = 0, **kw) -> Callable[[int], Scenario]:
    """Deterministic episode-index -> Scenario mapping for the batched
    trainer (each episode a fresh draw; same base_seed -> same stream)."""
    def fn(ep: int) -> Scenario:
        return make_scenario(base_seed + 7919 * ep + 13, **kw)
    return fn


# -- nonstationary drift scenarios (online / continual learning) -------------

# pre-flip: chat-dominated short-prompt traffic
DRIFT_PRE_TENANTS = {
    "chat": (0.70, ("qna", "translation")),
    "batch": (0.20, ("sentiment", "in_context_qna")),
    "misc": (0.10, None),
}
# post-flip: the chat tenant collapses, a NEW ingest tenant (tenant
# churn) floods heavy long-prompt analytics work
DRIFT_POST_TENANTS = {
    "batch": (0.55, ("sentiment", "in_context_qna")),
    "ingest": (0.35, ("in_context_qna", "sentiment")),
    "misc": (0.10, ("qna",)),
}


def make_drift_scenario(seed: int,
                        n_requests: int = 600,
                        rate: float = 16.0,
                        flip_frac: float = 0.5,
                        pattern: str = "poisson",
                        profiles: Sequence[HardwareProfile] = (
                            V100_LLAMA2_7B,) * 4,
                        pre_tenants: Optional[dict] = None,
                        post_tenants: Optional[dict] = None,
                        chaos: object = "auto",
                        straggler_instance: int = 0,
                        straggler_factor: float = 4.0,
                        crash_instance: Optional[int] = 1,
                        restart_after: float = 12.0,
                        **arrival_kw) -> Scenario:
    """Nonstationarity stress scenario: ONE arrival stream whose
    generating distribution flips mid-flight.

    At request ``int(n_requests * flip_frac)`` the tenant mix switches
    from ``pre_tenants`` (chat-dominated, short prompts) to
    ``post_tenants`` (a new heavy ``ingest`` tenant -- workload-mix flip
    AND tenant churn in one event).  With ``chaos="auto"`` the flip also
    carries infrastructure drift, built on the existing fault-injection
    hooks: a persistent straggler (``straggler_factor`` x slower decode)
    on one instance from the flip onward, and a crash/restart on
    another shortly after.  Pass ``chaos=None`` for a pure workload
    flip, or an explicit ``FaultSchedule``.

    Everything is drawn from ``seed`` (deterministic: same seed, same
    stream, same faults).  ``meta`` carries ``flip_time`` /
    ``flip_index`` so benchmarks can score pre- and post-flip windows
    separately, and the schedule under ``meta["chaos"]`` is what
    ``GatewayConfig(chaos=...)`` consumes.  A frozen offline policy
    trained on the pre-flip mix provably degrades here; an online
    learner adapts (benchmarks/bench_online_drift.py gates exactly
    that)."""
    profiles = tuple(profiles)
    rng = np.random.default_rng(seed)
    times = arrival_times(n_requests, rate, pattern, seed=seed + 3,
                          **arrival_kw)
    n_pre = int(np.clip(int(n_requests * flip_frac), 0, n_requests))
    flip_time = float(times[n_pre]) if n_pre < n_requests \
        else float(times[-1])
    budget = int(min(p.capacity_tokens for p in profiles) * 0.95)
    segments = ((dict(pre_tenants or DRIFT_PRE_TENANTS), 0, n_pre),
                (dict(post_tenants or DRIFT_POST_TENANTS), n_pre,
                 n_requests))
    reqs: List[Request] = []
    samples: List[Sample] = []
    for si, (tenants, lo, hi) in enumerate(segments):
        if hi <= lo:
            continue
        names = sorted(tenants)
        w = np.array([tenants[t][0] for t in names], float)
        w /= w.sum()
        assign = rng.choice(len(names), size=hi - lo, p=w)
        pools = {}
        for k, t in enumerate(names):
            count = int(np.sum(assign == k))
            pools[t] = list(reversed(generate(
                count, seed=seed + 1009 * si + 101 * (k + 1),
                tasks=tenants[t][1])))
        for k, at in zip(assign, times[lo:hi]):
            t = names[k]
            s = pools[t].pop()
            d = min(s.decode_tokens, max(budget - s.prompt_tokens, 1))
            reqs.append(Request(prompt_tokens=s.prompt_tokens,
                                decode_tokens=d, arrival=float(at),
                                task=s.task, tenant=t))
            samples.append(s)
    schedule = chaos
    if chaos == "auto":
        # deferred import: core must stay importable without serving
        from repro_torch.serving.chaos import Crash, FaultSchedule, Straggler
        horizon = float(times[-1]) + 120.0
        stragglers = (Straggler(flip_time, horizon,
                                straggler_instance % len(profiles),
                                straggler_factor),)
        crashes = ()
        if crash_instance is not None:
            crashes = (Crash(flip_time + 0.1 * (horizon - flip_time),
                             crash_instance % len(profiles),
                             restart_after),)
        schedule = FaultSchedule(crashes=crashes, stragglers=stragglers)
    return Scenario(requests=reqs, profiles=profiles,
                    name=f"drift{seed}-{pattern}", pattern=pattern,
                    rate=rate, seed=seed,
                    meta={"flip_time": flip_time, "flip_index": n_pre,
                          "chaos": schedule,
                          "pre_tenants": sorted(segments[0][0]),
                          "post_tenants": sorted(segments[1][0])},
                    samples=samples)


def generate_trace(n: int, seed: int = 0) -> List[Sample]:
    rng = np.random.default_rng(seed)
    apps = list(_TRACE_SPEC)
    w = np.array([_TRACE_SPEC[a][2] for a in apps])
    w /= w.sum()
    choice = rng.choice(len(apps), size=n, p=w)
    out = []
    for i in range(n):
        a = apps[choice[i]]
        (pmu, psig), (dmu, dsig), _ = _TRACE_SPEC[a]
        p = int(_lognormal_int(rng, pmu, psig, 16, 16384, None))
        d = int(_lognormal_int(rng, dmu, dsig, 1, 2048, None))
        out.append(Sample(a, apps.index(a), p, d,
                          np.zeros((1,), np.int32)))   # no content available
    return out
