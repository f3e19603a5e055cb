"""The port's wall-clock spans (``serving.trace.span`` / ``sync``): off,
a site returns the shared no-op and records nothing; under
``torch.profiler`` the serving path of two reduced engines behind an
``EngineClusterAdapter`` and the ``rl`` policy records its named spans,
nested as the calls nest, one ``repro.moe.dispatch`` a ``moe_ragged``
call and no sync span inside it (the dispatch and the grouped experts
read nothing to the host), and one ``repro.sync.next_tokens`` a decode
iteration; and the served tokens and routing decisions are the same with
the profiler as without."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import rl_router as rl
from repro_torch.core.profiles import V100_LLAMA2_7B
from repro_torch.models import moe as moe_mod
from repro_torch.models import params as params_lib
from repro_torch.serving import trace
from repro_torch.serving.engine import LLMInstance
from repro_torch.serving.gateway import EngineClusterAdapter, Gateway, \
    GatewayConfig
from repro_torch.serving.policies import RLPolicy
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import get_scheduler

#: (span, its parent) wherever the span is recorded in a serving run
PARENTS = {
    "repro.gateway.admit": None,
    "repro.gateway.route": None,
    "repro.cluster.advance": None,
    "repro.route": "repro.gateway.route",
    "repro.route.featurize": "repro.route",
    "repro.route.act": "repro.route",
    "repro.sync.route_q": "repro.route.act",
    "repro.engine.step": "repro.cluster.advance",
    "repro.engine.prefill": "repro.engine.step",
    "repro.engine.decode": "repro.engine.step",
    "repro.sync.first_token": "repro.engine.prefill",
    "repro.sync.next_tokens": "repro.engine.decode",
    "repro.model.head": ("repro.engine.prefill", "repro.engine.decode"),
    "repro.model.attn": ("repro.engine.prefill", "repro.engine.decode"),
    "repro.model.mamba": ("repro.engine.prefill", "repro.engine.decode"),
    "repro.model.ffn": ("repro.engine.prefill", "repro.engine.decode"),
    "repro.moe.gate": "repro.model.ffn",
    "repro.moe.dispatch": "repro.model.ffn",
    "repro.moe.experts": "repro.model.ffn",
    "repro.moe.combine": "repro.model.ffn",
    "repro.moe.aux": "repro.model.ffn",
    "repro.moe.shared": "repro.model.ffn",
    "repro.mamba.in_proj": "repro.model.mamba",
    "repro.mamba.conv": "repro.model.mamba",
    "repro.mamba.ssm_inputs": "repro.model.mamba",
    "repro.mamba.scan": "repro.model.mamba",
    "repro.mamba.out": "repro.model.mamba",
}
COMMON = {"repro.gateway.admit", "repro.gateway.route",
          "repro.cluster.advance", "repro.route", "repro.route.featurize",
          "repro.route.act", "repro.sync.route_q", "repro.engine.step",
          "repro.engine.prefill", "repro.engine.decode",
          "repro.sync.first_token", "repro.sync.next_tokens",
          "repro.model.head", "repro.model.ffn"}
EXPECTED = {
    "deepseek-moe-16b": COMMON | {
        "repro.model.attn", "repro.moe.gate", "repro.moe.dispatch",
        "repro.moe.experts", "repro.moe.combine", "repro.moe.aux",
        "repro.moe.shared"},
    "falcon-mamba-7b": (COMMON - {"repro.model.ffn"}) | {
        "repro.model.mamba", "repro.mamba.in_proj", "repro.mamba.conv",
        "repro.mamba.ssm_inputs", "repro.mamba.scan", "repro.mamba.out"},
}
PROMPTS = (12, 24, 40)
#: the reduced configs' overrides: falcon-mamba keeps no FFN, as published
OVERRIDES = {"deepseek-moe-16b": {}, "falcon-mamba-7b": {"d_ff": 0}}


def test_off_returns_the_shared_no_op_and_records_nothing():
    assert not autograd_profiler._is_profiler_enabled
    assert trace.span("repro.test.off") is trace.OFF
    assert trace.sync("off") is trace.OFF
    with trace.span("repro.test.off") as got:
        assert got is None
        with trace.sync("off"):
            torch.ones(3).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(3).sum()
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert not any(n.startswith("repro.") for n in names)


def test_the_flag_follows_the_profilers_start_and_stop():
    prof = profile(activities=[ProfilerActivity.CPU])
    assert not autograd_profiler._is_profiler_enabled
    prof.start()
    try:
        assert autograd_profiler._is_profiler_enabled
        sp = trace.span("repro.test.on")
        assert sp is not trace.OFF
        with sp:
            with trace.sync("on"):
                torch.ones(3).sum()
    finally:
        prof.stop()
    assert not autograd_profiler._is_profiler_enabled
    assert trace.span("repro.test.on") is trace.OFF
    got = [_name_span(ev) for ev in prof.profiler.kineto_results.events()]
    names = [g[0] for g in got if g is not None]
    assert names.count("repro.test.on") == 1
    assert names.count("repro.sync.on") == 1
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled
    assert not autograd_profiler._is_profiler_enabled


def _name_span(ev):
    name = ev.name()
    if not name.startswith("repro."):
        return None
    return name, ev.start_ns(), ev.start_ns() + ev.duration_ns()


def _nest(spans):
    """(name, parent name or None) of each span, the parent being the
    innermost span that encloses it."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    out, stack = [], []
    for name, s, e in spans:
        while stack and stack[-1][2] <= s:
            stack.pop()
        assert not stack or e <= stack[-1][2], (name, stack[-1])
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, s, e))
    return out


def _serve(arch, profiled, monkeypatch):
    """Two reduced engines of ``arch`` behind the gateway under an
    untrained ``rl`` policy; returns (decisions, served tokens, spans,
    ``moe_ragged`` calls, decode iterations)."""
    cfg = get_config(arch).reduced(**OVERRIDES[arch])
    params = params_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    prof = dataclasses.replace(V100_LLAMA2_7B, capacity_tokens=400)
    engines = [LLMInstance(cfg, params, prof, get_scheduler("fcfs"),
                           n_slots=4, cache_len=64, instance_id=i,
                           device="cpu") for i in range(2)]
    served = []
    for e in engines:
        step = e.step

        def recording_step(e=e, step=step):
            done = step()
            served.append((e.instance_id, e.next_tokens.tolist(),
                           [None if r is None else r.rid for r in e.slots]))
            return done
        e.step = recording_step
    rcfg = rl.RouterConfig(variant="guided", n_instances=2,
                           q_arch="decomposed", seed=0)
    policy = RLPolicy(rl.make_agent(rcfg, device="cpu"), rcfg)
    cluster = EngineClusterAdapter(engines)
    decisions = []
    route = cluster.route

    def recording_route(idx):
        req = route(idx)
        decisions.append((req.rid, int(idx), cluster.t))
        return req
    cluster.route = recording_route
    rng = np.random.default_rng(3)
    reqs = [Request(prompt_tokens=int(rng.choice(PROMPTS)),
                    decode_tokens=int(rng.integers(2, 6)),
                    arrival=0.03 * i, tenant="t", rid=9000 + i)
            for i in range(6)]
    ragged = [0]
    impl = moe_mod.IMPLS["ragged"]

    def counting(*a, **kw):
        ragged[0] += 1
        return impl(*a, **kw)
    monkeypatch.setitem(moe_mod.IMPLS, "ragged", counting)
    gw = Gateway(GatewayConfig(backend="engine"), None, policy,
                 cluster=cluster)
    spans = []
    with torch.no_grad():
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]) as p:
                gw.run(reqs)
            spans = [s for s in map(_name_span,
                                    p.profiler.kineto_results.events())
                     if s is not None]
        else:
            gw.run(reqs)
    assert all(r.decoded == r.decode_tokens for r in reqs)
    decodes = sum(e.n_decode_steps for e in engines)
    return decisions, served, spans, ragged[0], decodes


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "falcon-mamba-7b"])
def test_serving_spans_nest_and_leave_the_output_alone(arch, monkeypatch):
    dec_off, served_off, none, _, _ = _serve(arch, False, monkeypatch)
    assert none == []
    dec_on, served_on, spans, ragged, decodes = _serve(arch, True,
                                                       monkeypatch)
    assert dec_on == dec_off and len(dec_on) == 6
    assert served_on == served_off

    nest = _nest(spans)
    assert {name for name, _ in nest} == EXPECTED[arch]
    for name, parent in nest:
        want = PARENTS[name]
        ok = parent in want if isinstance(want, tuple) else parent == want
        assert ok, (name, parent)
    count = {}
    for name, _ in nest:
        count[name] = count.get(name, 0) + 1
    assert count["repro.sync.next_tokens"] == decodes > 0
    assert count["repro.engine.decode"] == decodes
    assert count["repro.engine.prefill"] == count["repro.sync.first_token"] \
        == 6
    assert count["repro.route"] == count["repro.sync.route_q"] >= 6
    passes = count["repro.engine.prefill"] + decodes
    assert count["repro.model.head"] == passes
    if arch == "deepseek-moe-16b":
        cfg = get_config(arch).reduced(**OVERRIDES[arch])
        moe_layers = cfg.n_layers - 1
        assert ragged > 0
        assert count["repro.moe.dispatch"] == ragged
        assert count["repro.moe.gate"] == passes * moe_layers
        assert count["repro.model.attn"] == passes * cfg.n_layers
    else:
        assert ragged == 0
        n = get_config(arch).reduced(**OVERRIDES[arch]).n_layers
        assert count["repro.model.mamba"] == count["repro.mamba.scan"] \
            == passes * n
