"""How ``correct`` is decided: what the window produced, held to the plain
reference (``portbench/reference``) once the window has closed.

Each number beside its limit (the cell file's ``check``; a cell compares
the gap numbers its file gives a limit):
  logit_gap       -- a sample of the finished requests drawn from the
                     seed, the one with the most served tokens always in
                     it: the reference runs once over each prompt with its
                     served tokens, and at every served token reads how
                     far that token's logit lies below the reference's
                     best; the widest such gap.
  logit_gap_mean  -- the mean of those gaps over every checked token.
  router_mismatch -- the routing decisions of the window whose action
                     differs from the reference Q-network's selection on
                     the same recorded state, where the reference's margin
                     is decisive (above ``ROUTER_TIE``): exact, limit 0.
  bookkeeping     -- requests lost (enqueued and nowhere), finished twice,
                     or finished with another number of served tokens
                     than they asked for: exact, limit 0.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

#: a reference margin under this (float64 selection values) is a tie that
#: float32 Q-values may break either way
ROUTER_TIE = 1e-4


def sample(finished: List, served: Dict, seed: int, k: int) -> List:
    """``k`` finished requests drawn from ``seed``, the longest served
    among them."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(served[r.rid]), r.rid))
    rest = sorted((r for r in finished if r is not longest),
                  key=lambda r: r.rid)
    rng = np.random.default_rng(int(seed) % (1 << 63) ^ 0x5EED)
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) \
        if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def logit_gaps(weights, config, reqs, served, device, control=False):
    """Per request: the served tokens' gaps below the reference's best
    (and, with ``control``, the gaps of the tokens the float8 copy of
    the reference would put first at the same positions)."""
    import torch
    from reference import model as ref
    ref.set_precision()
    out, ctl = [], []
    for r in reqs:
        toks = served[r.rid]
        seq = np.concatenate([np.asarray(r.tokens, np.int64),
                              np.asarray(toks[:-1], np.int64)])
        p = r.prompt_tokens
        rows = list(range(p - 1, p - 1 + len(toks)))
        t = torch.as_tensor(seq, device=device)
        lg = ref.logits_at(weights, config, t, rows)
        best = lg.max(-1).values
        idx = torch.arange(len(rows), device=device)
        got = torch.as_tensor(toks, device=device)
        out.append((best - lg[idx, got]).cpu().numpy())
        if control:
            lc = ref.logits_at(weights, config, t, rows, quant=ref.fp8_rows)
            ctl.append((best - lg[idx, lc.argmax(-1)]).cpu().numpy())
        del lg
    return out, ctl


def gap_numbers(gaps) -> Dict[str, float]:
    """The widest and the mean gap over every checked token."""
    g = np.concatenate([x for x in gaps if len(x)]) if gaps else []
    if not len(g):
        return {"logit_gap": 0.0, "logit_gap_mean": 0.0}
    return {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean())}


def router_mismatches(acts, weights_json) -> int:
    from reference import router
    meta, p = router.load(weights_json)
    bad = 0
    for state, mask, prior, squash, a in acts:
        want, margin = router.select(router.q_values(meta, p, state), mask,
                                     prior, squash)
        if want != a and margin > ROUTER_TIE:
            bad += 1
    return bad


def bookkeeping(rec, adapter, engines) -> Dict[str, int]:
    """Lost, duplicated and miscounted requests.  The adapter lists what
    its ``advance`` calls returned; a request that an engine finished in
    the call that the window's close left (``WindowClosed`` leaves it
    before it extends the list) is in its engine's ``completed`` alone
    and is finished.  One that an engine finished before the last
    ``advance`` returned, and that the adapter does not list, is lost."""
    eng_ids = [r.rid for e in engines for r in e.completed]
    ada_ids = [r.rid for r in adapter.completed]
    dup = (len(eng_ids) - len(set(eng_ids))) \
        + (len(ada_ids) - len(set(ada_ids)))
    where = set(ada_ids) | {r.rid for r in _stranded(rec, adapter, engines)}
    where |= {r.rid for r in adapter.central}
    for e in engines:
        where |= {r.rid for r in e.queue}
        where |= {r.rid for r in e.slots if r is not None}
    lost = sum(1 for rid in rec.enq if rid not in where)
    miscount = sum(1 for r in finished(rec, adapter, engines)
                   if r.decoded != r.decode_tokens
                   or len(rec.served[r.rid]) != r.decode_tokens
                   or len(rec.tok_walls[r.rid]) != r.decode_tokens)
    return {"lost": lost, "duplicated": dup, "miscounted": miscount}


def _stranded(rec, adapter, engines) -> List:
    """Requests an engine finished after the last ``advance`` returned,
    which the adapter cannot list yet."""
    seen = {r.rid for r in adapter.completed}
    t = rec.advance_t
    return [r for e in engines for r in e.completed if r.rid not in seen
            and rec.tok_walls[r.rid]
            and (t is None or rec.tok_walls[r.rid][-1] > t)]


def finished(rec, adapter, engines) -> List:
    """Every finished request: the adapter's, then those finished in the
    ``advance`` call that the window's close left."""
    out = list(adapter.completed)
    seen = {r.rid for r in out}
    for r in _stranded(rec, adapter, engines):
        if r.rid not in seen:
            seen.add(r.rid)
            out.append(r)
    return out


def stranded(rec, adapter, engines) -> int:
    """How many finished in the ``advance`` call the close left."""
    return len({r.rid for r in _stranded(rec, adapter, engines)})
