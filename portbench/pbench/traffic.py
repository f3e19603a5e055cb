"""The one traffic generator: a mix file of parameters -> a request stream.

A mix (``traffic/<name>.json``) is a weighted list of components, each with
a prompt-length and a decode-length distribution, plus an arrival pattern.
Sizes are drawn ONCE from the mix's own ``pool_seed`` into a block of
``block`` requests; a run's ``--seed`` only reorders: the stream is a
sequence of blocks, each an independent permutation of that one block, so
every run serves the same multiset of sizes in every ``block`` consecutive
requests.  Arrival gaps are drawn once too: a cycle of ``gap_pool`` gaps
(``pool_seed``, at rate 1), which a run's seed rotates (a rotation keeps
the bursts of the bursty pattern intact) and the stream repeats, so every
run sees the same multiset of gaps in every ``gap_pool`` consecutive
arrivals.  Prompt contents are drawn from the run's seed.

With ``"sampling": "stratified"`` a block is drawn at evenly spaced
quantiles instead: each component gets its share of the block (largest
remainders), its prompts and decodes the quantiles (i + 0.5) / k of their
distributions, paired by a permutation from ``pool_seed``; Poisson gaps
likewise.  A small block then still has the mix's shape, so a window that
serves a few blocks serves nearly the same work whatever the seed.

Distributions (``dist``):
  lognormal  -- int(clip(exp(N(mu, sigma)) * p ** prompt_exponent, lo, hi))
                (``prompt_exponent`` only on decode: the weak coupling of a
                task's answer length to its prompt length)
  loguniform -- int(exp(U(log lo, log hi)))
  uniform    -- integers in [lo, hi]

Arrival patterns (``arrivals.pattern``), copies of the program's
``core.workload.arrival_times`` at rate 1:
  poisson -- exponential gaps
  bursty  -- two-state Markov-modulated Poisson (``burst_factor``,
             ``persistence``)
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List

import numpy as np


@dataclass
class Item:
    """One request of the stream: virtual arrival, sizes, prompt ids."""
    arrival: float
    prompt_tokens: int
    decode_tokens: int
    component: str
    tokens: np.ndarray


def load_mix(path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _draw(rng: np.random.Generator, spec: Dict, p=None) -> int:
    dist = spec["dist"]
    lo, hi = spec["lo"], spec["hi"]
    if dist == "lognormal":
        x = rng.lognormal(spec["mu"], spec["sigma"])
        if p is not None and spec.get("prompt_exponent"):
            x *= math.exp(spec["prompt_exponent"] * math.log(max(p, 1)))
        return int(np.clip(x, lo, hi))
    if dist == "loguniform":
        return int(np.clip(math.exp(rng.uniform(math.log(lo),
                                                math.log(hi))), lo, hi))
    if dist == "uniform":
        return int(rng.integers(lo, hi + 1))
    raise ValueError(f"unknown distribution {dist!r}")


def _quantile(spec: Dict, u: float, p=None) -> int:
    dist = spec["dist"]
    lo, hi = spec["lo"], spec["hi"]
    if dist == "lognormal":
        x = math.exp(spec["mu"] + spec["sigma"] * NormalDist().inv_cdf(u))
        if p is not None and spec.get("prompt_exponent"):
            x *= math.exp(spec["prompt_exponent"] * math.log(max(p, 1)))
        return int(np.clip(x, lo, hi))
    if dist == "loguniform":
        return int(np.clip(math.exp(math.log(lo) + u * (math.log(hi)
                                                        - math.log(lo))),
                           lo, hi))
    if dist == "uniform":
        return int(lo + min(int(u * (hi - lo + 1)), hi - lo))
    raise ValueError(f"unknown distribution {dist!r}")


def _stratified(mix: Dict, n: int, rng) -> list:
    comps = mix["components"]
    w = np.array([c["weight"] for c in comps], float)
    share = n * w / w.sum()
    k = np.floor(share).astype(int)
    for i in np.argsort(-(share - k), kind="stable")[:n - k.sum()]:
        k[i] += 1
    out = []
    for c, kc in zip(comps, k):
        us = [(i + 0.5) / kc for i in range(kc)]
        prompts = [_quantile(c["prompt"], u) for u in us]
        pair = rng.permutation(kc)
        out += [(c["name"], p, _quantile(c["decode"], us[j], p))
                for p, j in zip(prompts, pair)]
    return [out[i] for i in rng.permutation(len(out))]


def size_block(mix: Dict, n: int = 0, seed=None):
    """``n`` (default: the mix's ``block``) (component, prompt, decode)
    triples drawn from ``seed`` (default: the mix's ``pool_seed``)."""
    n = n or mix["block"]
    rng = np.random.default_rng(mix["pool_seed"] if seed is None else seed)
    if mix.get("sampling") == "stratified":
        return _stratified(mix, n, rng)
    comps = mix["components"]
    w = np.array([c["weight"] for c in comps], float)
    choice = rng.choice(len(comps), size=n, p=w / w.sum())
    out = []
    for i in choice:
        c = comps[i]
        p = _draw(rng, c["prompt"])
        d = _draw(rng, c["decode"], p)
        out.append((c["name"], p, d))
    return out


def unit_gaps(arrivals: Dict, n: int, seed: int,
              stratified: bool = False) -> np.ndarray:
    """``n`` inter-arrival gaps at a mean rate of 1 request a second."""
    rng = np.random.default_rng(seed)
    pattern = arrivals["pattern"]
    if pattern == "poisson":
        if stratified:
            u = (np.arange(n) + 0.5) / n
            return rng.permutation(-np.log1p(-u))
        return rng.exponential(1.0, size=n)
    if pattern == "bursty":
        f = arrivals["burst_factor"]
        persist = arrivals["persistence"]
        r_on, r_off = f, f / (2.0 * f - 1.0)
        out = np.empty(n)
        on = bool(rng.random() < 0.5)
        for i in range(n):
            out[i] = rng.exponential(1.0 / (r_on if on else r_off))
            if rng.random() > persist:
                on = not on
        return out
    raise ValueError(f"unknown arrival pattern {pattern!r}")


def stream(mix: Dict, n: int, rate: float, backlog: int, seed: int,
           vocab: int) -> List[Item]:
    """The run's ``n`` requests: the first ``backlog`` due at virtual time
    0 (the occupancy the rate sustains, admitted during set-up), the rest
    at ``rate`` requests a virtual second from time 0 on."""
    rng = np.random.default_rng(seed)
    block = size_block(mix)
    sizes = []
    while len(sizes) < n:
        sizes.extend(block[j] for j in rng.permutation(len(block)))
    gaps = unit_gaps(mix["arrivals"], mix["gap_pool"], mix["pool_seed"] + 1,
                     mix.get("sampling") == "stratified")
    gaps = np.roll(gaps, -int(rng.integers(len(gaps))))
    reps = -(-(n - backlog) // len(gaps)) if n > backlog else 0
    gaps = np.tile(gaps, max(reps, 1))[:max(n - backlog, 0)]
    t = np.concatenate([np.zeros(backlog), np.cumsum(gaps) / rate])
    items = []
    for k in range(n):
        name, p, d = sizes[k]
        toks = rng.integers(0, vocab, size=p, dtype=np.int64)
        items.append(Item(float(t[k]), p, d, name, toks))
    return items

