"""Radix-style longest-prefix KV cache model (per instance).

Real engines (vLLM with ``enable_prefix_caching``, SGLang's radix tree)
keep the KV blocks of recently served prompts; a new request whose
prompt shares a cached prefix pays prefill only for the uncached
suffix.  For routing, that makes placement *history-dependent*: the
same request is cheap on the instance that served the previous turn of
its conversation and expensive anywhere else -- the affinity signal
the cache-aware policies and the RL state feature consume.

The model is deliberately minimal and fully deterministic:

  * prompts are identified by a chain of per-block content hashes
    (``Request.prefix_hashes``; block = ``block`` tokens, vLLM's
    block-hash scheme).  Like vLLM, a block's hash covers its whole
    prefix, so chains form a radix tree keyed by hash equality --
    matching is "longest shared prefix of two hash chains";
  * ``admit`` returns the cached-token credit for an admission, capped
    at ``prompt_tokens - 1`` (at least one token must be prefilled so
    the engine produces the first logits -- vLLM has the same rule),
    and inserts the prompt's own chain (its blocks are resident after
    the prefill);
  * LRU eviction under a token budget.  Chains are touched
    deepest-block-first, so a parent block is always at least as
    recent as any of its children and LRU eviction removes leaves
    before the prefixes they extend (the radix invariant);
  * the SAME object (plain dict ops, no clocks, no floats) backs the
    Python stepper, a vecsim lane, and the real engine, so hit/miss
    decisions are bit-identical across backends by construction.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence


class PrefixCache:
    """LRU cache over prefix block hashes under a token budget."""

    __slots__ = ("capacity_tokens", "block", "_blocks", "hit_tokens",
                 "lookup_tokens")

    def __init__(self, capacity_tokens: int, block: int = 32):
        if block <= 0:
            raise ValueError(f"block must be positive, got {block}")
        self.capacity_tokens = int(capacity_tokens)
        self.block = int(block)
        self._blocks: OrderedDict = OrderedDict()   # hash -> None (LRU@front)
        # cumulative admission-time stats (exact integers on every
        # backend; benchmarks report hit_tokens / lookup_tokens)
        self.hit_tokens = 0
        self.lookup_tokens = 0

    def __len__(self) -> int:
        return len(self._blocks)

    @property
    def cached_token_count(self) -> int:
        return len(self._blocks) * self.block

    # -- read-only queries (policies / state features) -------------------
    def match(self, hashes: Optional[Sequence]) -> int:
        """Longest cached prefix, in blocks.  Never touches LRU order,
        so featurizing/scoring a request cannot perturb the simulation."""
        if not hashes:
            return 0
        blocks = self._blocks
        n = 0
        for h in hashes:
            if h not in blocks:
                break
            n += 1
        return n

    def cached_tokens(self, prompt_tokens: int,
                      hashes: Optional[Sequence]) -> int:
        """The prefill credit an admission *would* get right now."""
        n = self.match(hashes)
        if not n:
            return 0
        return min(n * self.block, max(int(prompt_tokens) - 1, 0))

    def hit_fraction(self, prompt_tokens: int,
                     hashes: Optional[Sequence]) -> float:
        p = int(prompt_tokens)
        if p <= 0:
            return 0.0
        return self.cached_tokens(p, hashes) / p

    # -- mutations (admission / completion) ------------------------------
    def insert(self, hashes: Optional[Sequence]):
        """Touch-or-add a whole chain, deepest block first (a parent is
        always at least as recent as its children), then evict LRU
        blocks until back under the token budget."""
        if not hashes:
            return
        blocks = self._blocks
        for h in reversed(hashes):
            if h in blocks:
                blocks.move_to_end(h)
            else:
                blocks[h] = None
        budget = self.capacity_tokens
        b = self.block
        while len(blocks) * b > budget:
            blocks.popitem(last=False)

    def admit(self, prompt_tokens: int,
              hashes: Optional[Sequence]) -> int:
        """Admission: credit the cached prefix, record stats, and
        insert the prompt's own chain (its KV is resident after this
        prefill).  Returns the credited token count."""
        if not hashes:
            return 0
        p = int(prompt_tokens)
        cached = self.cached_tokens(p, hashes)
        self.hit_tokens += cached
        self.lookup_tokens += p
        self.insert(hashes)
        return cached

    def clear(self):
        """Instance failure: the KV pool (and its cached prefixes) is
        gone.  Lifetime stats survive a restart."""
        self._blocks.clear()


def hit_fractions(cluster, req) -> "list":
    """Prospective per-instance hit fraction of ``req`` on every
    instance of a Cluster-protocol backend (py, vec, or engine
    adapter).  Read-only; instances without a cache (or a request
    without hashes) score 0.  The scalar loop is shared by every
    caller -- mixing_scores, the sticky policy, and both featurize
    paths -- so the produced floats are identical everywhere."""
    hashes = getattr(req, "prefix_hashes", None)
    p = req.prompt_tokens
    out = [0.0] * cluster.m
    if not hashes or p <= 0:
        return out
    for i, inst in enumerate(cluster.instances):
        pc = getattr(inst, "prefix_cache", None)
        if pc is not None:
            out[i] = pc.hit_fraction(p, hashes)
    return out
