"""The check sees what it must: a tiny cell on the CPU runs the whole
harness but the look for a card (the program's plain paths, float32), and
``correct`` comes out true; with the timed path broken underneath it
comes out false, once for each fault a serving cell can have.  The
control (the reference in float8 in the program's place) fails the
cell's limit at the same size."""
import copy
import time

import pytest
import torch

import _tiny
from pbench import check, runner

CELLS = ["deepseek-moe-16b.chat_saturated", "falcon-mamba-7b.long_prompt"]
#: the control's cells, at the smallest widths at which the float8
#: reference's gaps reach the cells' limits (they grow with width and
#: depth: at the published widths they are 7-10x the program's, PERF.md)
CONTROL = {
    "deepseek-moe-16b.chat_saturated": {
        "d_model": 512, "vocab_size": 8192, "n_layers": 6, "head_dim": 64,
        "dense_first_d_ff": 1024,
        "moe": {"d_expert": 128, "n_experts": 8, "top_k": 2}},
    "falcon-mamba-7b.chat_burst": {
        "d_model": 1024, "vocab_size": 8192, "n_layers": 12,
        "mamba": {"d_inner": 2048, "dt_rank": 64, "d_state": 16}},
}


def run(tmp_path, cell_name, seconds=2.0, tiny=None, **kw):
    cell = _tiny.tiny_cell(tmp_path, cell_name, tiny=tiny, requests=3000)
    return runner.run(cell, 2147483699, seconds, False, torch.device("cpu"),
                      time.perf_counter(), **kw)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_sound_run_is_correct_and_the_control_fails(tmp_path, cell):
    out = run(tmp_path, cell, tiny=CONTROL[cell], control=True)
    assert out["correct"], out["checks"]
    assert out["detail"]["served_tokens_checked"] > 50
    # the control goes through the same numbers and limits, and fails
    assert out["control_correct"] is False
    ctl = out["control_checks"]
    assert set(ctl) == set(out["checks"]) & {"logit_gap", "logit_gap_mean"}
    assert any(v["value"] > v["limit"] for v in ctl.values())
    assert list(out)[-1] == "checks"


def _stale_cache(orig):
    def decode(params, cfg, cache, tokens=None, embeds=None):
        snap = copy.deepcopy(cache)
        logits, _ = orig(params, cfg, snap, tokens=tokens, embeds=embeds)
        return logits, cache            # the state left unchanged
    return decode


def _half_batch(orig):
    def decode(params, cfg, cache, tokens=None, embeds=None):
        logits, cache = orig(params, cfg, cache, tokens=tokens,
                             embeds=embeds)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:] = logits[:logits.shape[0] - h]   # half left out
        return logits, cache
    return decode


def _altered_token(orig):
    def decode(params, cfg, cache, tokens=None, embeds=None):
        logits, cache = orig(params, cfg, cache, tokens=tokens,
                             embeds=embeds)
        return torch.roll(logits, 1, dims=-1), cache
    return decode


@pytest.mark.parametrize("fault", [_stale_cache, _half_batch,
                                   _altered_token])
def test_broken_decode_is_caught(tmp_path, monkeypatch, fault):
    from repro_torch.models import model
    monkeypatch.setattr(model, "decode_step", fault(model.decode_step))
    out = run(tmp_path, CELLS[0])
    assert not out["correct"]
    assert any(v["value"] > v["limit"] for k, v in out["checks"].items()
               if k.startswith("logit_gap"))


def test_altered_routing_is_caught(tmp_path, monkeypatch):
    from repro_torch.core import dqn
    orig = dqn.DQNAgent.act_batch

    def flipped(self, states, masks, *a, **kw):
        acts = orig(self, states, masks, *a, **kw)
        for i, m in enumerate(masks):
            ok = [j for j in range(len(m)) if m[j] and j != acts[i]]
            if ok:
                acts[i] = ok[0]
        return acts
    monkeypatch.setattr(dqn.DQNAgent, "act_batch", flipped)
    out = run(tmp_path, CELLS[0])
    assert not out["correct"]
    assert out["checks"]["router_mismatch"]["value"] > 0


def test_lost_request_is_caught(tmp_path, monkeypatch):
    from repro_torch.serving import gateway
    orig = gateway.EngineClusterAdapter.route

    def drop(self, idx):
        req = orig(self, idx)
        if req.rid % 5 == 0:
            self.engines[idx].queue.remove(req)      # dropped on the floor
        return req
    monkeypatch.setattr(gateway.EngineClusterAdapter, "route", drop)
    out = run(tmp_path, CELLS[0])
    assert not out["correct"]
    assert out["checks"]["bookkeeping"]["value"] > 0


def test_sample_keeps_the_longest():
    class R:
        def __init__(self, rid):
            self.rid = rid
    reqs = [R(i) for i in range(20)]
    served = {i: [0] * (i % 7) for i in range(20)}
    got = check.sample(reqs, served, 5, 4)
    assert len(got) == 4 and got[0].rid == 13
    assert [r.rid for r in check.sample(reqs, served, 5, 4)] == \
        [r.rid for r in got]


def test_finished_in_the_closing_advance_is_not_lost():
    """The window closes inside ``advance``: a request that an engine
    finished earlier in that call is in the engine's ``completed`` only,
    and is neither lost nor counted twice; one that an engine finished
    before the last ``advance`` returned, and that the adapter does not
    list, is lost."""
    from types import SimpleNamespace as NS
    from collections import deque

    def req(rid, n):
        return NS(rid=rid, decoded=n, decode_tokens=n)
    a, b, c = req(1, 2), req(2, 3), req(3, 1)
    rec = NS(enq={1: 0.0, 2: 0.0, 3: 0.0, 4: 0.0}, advance_t=0.15,
             served={1: [0, 0], 2: [0, 0, 0], 3: [0]},
             tok_walls={1: [0.0, 0.1], 2: [0.0, 0.1, 0.2], 3: [0.0]})
    e0 = NS(completed=[a, b], queue=deque(), slots=[None, None])
    e1 = NS(completed=[c], queue=deque([req(4, 2)]), slots=[None])
    adapter = NS(completed=[a, c], central=deque())
    books = check.bookkeeping(rec, adapter, [e0, e1])
    assert books == {"lost": 0, "duplicated": 0, "miscounted": 0}
    assert [r.rid for r in check.finished(rec, adapter, [e0, e1])] == \
        [1, 3, 2]
    assert check.stranded(rec, adapter, [e0, e1]) == 1
    rec.advance_t = 0.25                     # 2 finished, never listed
    assert check.bookkeeping(rec, adapter, [e0, e1])["lost"] == 1
    assert check.stranded(rec, adapter, [e0, e1]) == 0
    rec.advance_t = 0.15
    e0.completed = [a]                       # 2 now nowhere
    assert check.bookkeeping(rec, adapter, [e0, e1])["lost"] == 1
    e1.completed = [c, c]
    assert check.bookkeeping(rec, adapter, [e0, e1])["duplicated"] == 1
