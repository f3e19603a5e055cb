"""The port's LLMInstance against the JAX reference's, in lockstep.

The same seeded requests (explicit rids, so both engines draw the same
prompt tokens) go through both engines with the reference's parameters
carried over by value.  Virtual-clock stamps, preemptions and trace
events are equal exactly; logits agree within 1e-4 (f32 reduced config)
and greedy tokens are equal wherever the top-2 logit margin exceeds 1e-3.
One request decodes past ``cache_len``."""
import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as REF_REGISTRY
from repro.core.profiles import V100_LLAMA2_7B as REF_V100
from repro.launch import serve as ref_serve
from repro.models import params as ref_params
from repro.serving import engine as ref_engine
from repro.serving import request as ref_request
from repro.serving import trace as ref_trace
from repro.serving.scheduler import get_scheduler as ref_get_scheduler
from repro_torch.configs import get_config
from repro_torch.core.profiles import V100_LLAMA2_7B as PT_V100
from repro_torch.launch import serve as pt_serve
from repro_torch.models import params as pt_params
from repro_torch.serving import engine as pt_engine
from repro_torch.serving import request as pt_request
from repro_torch.serving import trace as pt_trace
from repro_torch.serving.scheduler import get_scheduler as pt_get_scheduler

CACHE_LEN = 32
TOL = 1e-4
STAMPS = ("routed_at", "prefill_done", "first_token", "finished",
          "token_times", "preemptions", "decoded", "prefilled",
          "cached_prefix", "phase")


def _requests(module, n=7, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        p, d = int(rng.integers(4, 20)), int(rng.integers(3, 12))
        if i == 2:
            p, d = 20, 18        # decodes 6 tokens past the cache
        hashes = tuple(range(i % 2, i % 2 + p // 8)) or None
        reqs.append(module.Request(prompt_tokens=p, decode_tokens=d,
                                   rid=1000 + i, prefix_hashes=hashes,
                                   full_hashes=hashes))
    return reqs


class _Recorder:
    """Wraps an engine's model calls and keeps their logits."""

    def __init__(self, inst):
        self.logits = []
        for attr in ("prefill_fn", "decode_fn"):
            fn = getattr(inst, attr)

            def wrapped(*a, _fn=fn, **kw):
                logits, cache = _fn(*a, **kw)
                self.logits.append(np.asarray(
                    logits.float() if isinstance(logits, torch.Tensor)
                    else logits, np.float32))
                return logits, cache
            setattr(inst, attr, wrapped)


def _engines(capacity=60, speed=1.0, arch="qwen3-0.6b"):
    cfg_ref = REF_REGISTRY[arch].reduced()
    cfg_pt = get_config(arch).reduced()
    if cfg_ref.mamba is not None:
        # the reference's scans assert S % min(chunk, S) == 0; a chunk
        # of the cache length takes every prompt here (same function)
        cfg_ref = dataclasses.replace(cfg_ref, mamba=dataclasses.replace(
            cfg_ref.mamba, chunk=CACHE_LEN))
    pr = ref_params.init_params(jax.random.PRNGKey(0), cfg_ref)
    pt = pt_params.from_reference(jax.tree.map(np.asarray, pr),
                                  device="cpu")
    kw = dict(n_slots=4, cache_len=CACHE_LEN, prefix_cache_tokens=64,
              prefix_block=8)
    ref = ref_engine.LLMInstance(
        cfg_ref, pr, dataclasses.replace(REF_V100, capacity_tokens=capacity),
        ref_get_scheduler("fcfs"), **kw)
    port = pt_engine.LLMInstance(
        cfg_pt, pt, dataclasses.replace(PT_V100, capacity_tokens=capacity),
        pt_get_scheduler("fcfs"), device="cpu", **kw)
    ref.speed_factor = port.speed_factor = speed
    ref.trace = ref_trace.TraceRecorder()
    port.trace = pt_trace.TraceRecorder()
    return ref, port


def _drive(inst, reqs, chaos: bool):
    """Submit one request per step, then step to completion; with
    ``chaos``, crash/recover the instance and steal a queued request."""
    pending = list(reqs)
    for t in range(200):
        if pending:
            inst.submit(pending.pop(0))
        if chaos and t == 4:
            for r in inst.fail():
                pending.insert(0, r)
            inst.recover()
        if chaos and t == 6 and inst.queue:
            r = inst.queue[-1]
            assert inst.steal(r)
            pending.append(r)
        inst.step()
        yield t
        if not pending and len(inst.completed) == len(reqs):
            return
    raise AssertionError("engine did not drain")


def _assert_cache_close(ref, port):
    """Every cache entry, the dense first layer's included."""
    want = jax.tree.map(np.asarray, ref.cache)
    np.testing.assert_array_equal(port.cache["pos"].numpy(), want["pos"])
    assert set(port.cache) == set(want)
    pairs = list(zip(port.cache["layers"], want["layers"]))
    if "first_layer" in want:
        pairs.append((port.cache["first_layer"], want["first_layer"]))
    for e_pt, e_ref in pairs:
        assert set(e_pt) == set(e_ref)
        for name in e_ref:
            np.testing.assert_allclose(e_pt[name].numpy(), e_ref[name],
                                       rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("chaos", [False, True])
def test_engine_matches_reference_in_lockstep(chaos):
    _lockstep(chaos, "qwen3-0.6b")


@pytest.mark.parametrize("chaos", [False, True])
def test_mamba_engine_matches_reference_in_lockstep(chaos):
    """Reduced falcon-mamba: slot inserts, gang decode of empty slots,
    preemption and fail/recover/steal over the conv/ssm cache."""
    _lockstep(chaos, "falcon-mamba-7b")


def _lockstep(chaos, arch):
    """Stamps, logits, greedy tokens and the whole cache (K/V, or the
    conv/ssm states) after every step, through slot inserts, preemption
    and, with ``chaos``, fail/recover/steal."""
    ref, port = _engines(speed=1.5 if chaos else 1.0, arch=arch)
    rec_ref, rec_pt = _Recorder(ref), _Recorder(port)
    ref_reqs = _requests(ref_request)
    pt_reqs = _requests(pt_request)
    with torch.no_grad():
        for _ in zip(_drive(ref, ref_reqs, chaos),
                     _drive(port, pt_reqs, chaos)):
            assert len(rec_ref.logits) == len(rec_pt.logits)
            for lr, lp in zip(rec_ref.logits, rec_pt.logits):
                np.testing.assert_allclose(lp, lr, rtol=TOL, atol=TOL)
            rec_ref.logits.clear()
            rec_pt.logits.clear()
            active = [i for i, r in enumerate(ref.slots) if r is not None]
            assert active == [i for i, r in enumerate(port.slots)
                              if r is not None]
            np.testing.assert_array_equal(ref.next_tokens[active],
                                          port.next_tokens[active])
            assert ref.clock == port.clock
            _assert_cache_close(ref, port)
    assert len(port.completed) == len(pt_reqs)
    assert max(r.prompt_tokens + r.decode_tokens for r in pt_reqs) \
        > CACHE_LEN
    if not chaos:
        assert sum(r.preemptions for r in pt_reqs) > 0
    for a, b in zip(ref_reqs, pt_reqs):
        for f in STAMPS:
            va, vb = getattr(a, f), getattr(b, f)
            if f == "phase":
                va, vb = va.value, vb.value
            assert va == vb, (a.rid, f, va, vb)
    assert ref.trace.events() == port.trace.events()
    assert ref.prefix_cache.hit_tokens == port.prefix_cache.hit_tokens


def test_greedy_tokens_agree_where_margin_is_clear():
    """Greedy decode of one long request: the port's tokens equal the
    reference's wherever the reference's top-2 margin exceeds 1e-3."""
    ref, port = _engines(capacity=4000)
    rec_ref, rec_pt = _Recorder(ref), _Recorder(port)
    ref.submit(ref_request.Request(prompt_tokens=9, decode_tokens=30,
                                   rid=77))
    port.submit(pt_request.Request(prompt_tokens=9, decode_tokens=30,
                                   rid=77))
    checked = 0
    with torch.no_grad():
        while not port.completed:
            ref.step()
            port.step()
            for lr, lp in zip(rec_ref.logits, rec_pt.logits):
                row_r, row_p = lr.reshape(-1, lr.shape[-1])[0], \
                    lp.reshape(-1, lp.shape[-1])[0]
                top2 = np.sort(row_r)[-2:]
                if top2[1] - top2[0] > 1e-3:
                    assert np.argmax(row_r) == np.argmax(row_p)
                    checked += 1
            rec_ref.logits.clear()
            rec_pt.logits.clear()
    assert checked >= 25
    assert ref.completed[0].finished == port.completed[0].finished


def test_serve_engine_summary_matches_reference(capsys):
    args = argparse.Namespace(arch="qwen3-0.6b", scheduler="fcfs",
                              instances=2, requests=6, prefix_cache=0,
                              prefix_block=32, profile_json=None,
                              calibrate=False, device="cpu")
    ref_serve.serve_engine(args)
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    with torch.no_grad():
        stats = pt_serve.serve_engine(args)
    assert stats["n"] == 6
    assert repr(stats) == ref_line
