"""Build the system under test as ``launch/serve.py::serve_gateway`` does
on its ``--backend engine --policy rl`` path, wrap the bound methods the
window reads, and drive ``Gateway.run`` until the wall deadline.

The wrappers (instance attributes over the objects this module built)
stamp, on the host's clock:
  * ``EngineClusterAdapter.enqueue``: each admission (``Gateway._admit``
    hands each admitted request over here);
  * ``EngineClusterAdapter.advance``: when the last call returned (the
    check's bookkeeping);
  * each ``LLMInstance.step``: its start and end, the request it admitted
    (and its prompt tokens), every request that received a token in it
    and that request's context;
  * each ``LLMInstance.decode_fn``: the token each resident was served
    (the engine's host copy of the next tokens, read before the pass);
  * ``RLPolicy.route``: each routing decision's start and end, and
    ``agent.act``'s inputs and answer for the router's check.
A step ends with the engine's host read of the argmax, so its end stamp
follows the device's work.

The engines run on the program's virtual clock: arrivals are due in
virtual seconds and an engine steps while its clock is behind the
gateway's, so the sequence of steps is a function of the seed, the fixed
profile and the router checkpoint; the card sets how long each takes.
The window opens at the first step after the cell's backlog has been
admitted (set-up) and closes at the first step that starts past the
deadline: the step wrapper raises :class:`WindowClosed`, which leaves
``Gateway.run``."""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


class WindowClosed(Exception):
    """Raised by the step wrapper at the first step past the deadline."""


class Recorder:
    def __init__(self, seconds: float, backlog: int, clock=time.perf_counter):
        self.clock = clock
        self.seconds = float(seconds)
        self.backlog = int(backlog)
        self.open_t: Optional[float] = None
        self.close_t: Optional[float] = None
        self.enq: Dict[int, float] = {}
        self.steps: List[Dict] = []
        self.tok_walls: Dict[int, List[float]] = defaultdict(list)
        self.served: Dict[int, List[int]] = defaultdict(list)
        self.routes: List[tuple] = []
        self.acts: List[tuple] = []
        self.prefills = 0
        self.profiler = None        # pbench.profile.Slice, when tracing
        self.advance_t: Optional[float] = None  # the last advance's return
        self.fired = defaultdict(int)

    @property
    def deadline(self) -> float:
        return self.open_t + self.seconds

    def in_window(self, t: float) -> bool:
        return (self.open_t is not None and t >= self.open_t
                and (self.close_t is None or t <= self.close_t))

    def window_steps(self) -> List[Dict]:
        return [s for s in self.steps if self.in_window(s["t0"])
                and s["t1"] <= self.close_t]


def wrap(rec: Recorder, gateway, adapter, engines, policy):
    """Install the wrappers on the objects the harness built."""
    clock = rec.clock
    enqueue = adapter.enqueue

    def enqueue_w(req):
        rec.fired["enqueue"] += 1
        rec.enq[req.rid] = clock()
        return enqueue(req)
    adapter.enqueue = enqueue_w

    advance = adapter.advance

    def advance_w():
        done = advance()
        rec.advance_t = clock()
        return done
    adapter.advance = advance_w

    for idx, e in enumerate(engines):
        _wrap_engine(rec, idx, e)

    route = policy.route

    def route_w(cluster, req, d_hat):
        rec.fired["route"] += 1
        t0 = clock()
        a = route(cluster, req, d_hat)
        rec.routes.append((t0, clock()))
        return a
    policy.route = route_w

    act = policy.agent.act

    def act_w(state, mask, epsilon=0.0, prior=None, q_squash=0.0):
        a = act(state, mask, epsilon=epsilon, prior=prior, q_squash=q_squash)
        rec.acts.append((np.array(state, np.float64), np.array(mask),
                         None if prior is None else np.array(prior),
                         float(q_squash), int(a)))
        return a
    policy.agent.act = act_w


def _wrap_engine(rec: Recorder, idx: int, e):
    clock = rec.clock
    step = e.step
    decode_fn = e.decode_fn

    def decode_w(params, cache=None, tokens=None):
        rec.fired["decode"] += 1
        nxt = e.next_tokens
        for i, r in enumerate(e.slots):
            if r is not None:
                rec.served[r.rid].append(int(nxt[i]))
        return decode_fn(params, cache=cache, tokens=tokens)
    e.decode_fn = decode_w

    def step_w():
        rec.fired["step"] += 1
        t0 = clock()
        if rec.open_t is None and rec.prefills >= rec.backlog:
            rec.open_t = t0
        if rec.open_t is not None and t0 >= rec.deadline:
            rec.close_t = t0
            raise WindowClosed
        prof = rec.profiler
        if prof is not None:
            prof.before_step(rec, t0)
        before = {r.rid: r.decoded for r in e.slots if r is not None}
        n_pref = e.n_prefills
        done = step()
        t1 = clock()
        admitted, prompt = None, 0
        rows = [r for r in e.slots if r is not None] + list(done)
        if e.n_prefills > n_pref:
            new = [r for r in rows if r.rid not in before]
            admitted = new[0].rid
            prompt = new[0].prompt_tokens
            rec.prefills += 1
        ctx = []
        for r in rows:
            if r.decoded > before.get(r.rid, 0):
                rec.tok_walls[r.rid].append(t1)
                # positions the decode pass attended: the prompt and the
                # tokens before this one, and this one
                ctx.append(r.prompt_tokens + r.decoded)
        rec.steps.append({"engine": idx, "t0": t0, "t1": t1,
                          "admitted": admitted, "prompt": prompt,
                          "ctx": ctx})
        if prof is not None:
            prof.after_step(rec, t1)
        return done
    e.step = step_w


def build(cfg, params, config: Dict, router_dir: str, device):
    """The engines, adapter, policy and gateway of ``serve_gateway``'s
    ``--backend engine --policy rl`` path."""
    from repro_torch.serving.engine import LLMInstance
    from repro_torch.serving.gateway import (EngineClusterAdapter, Gateway,
                                             GatewayConfig)
    from repro_torch.serving.policies import restore_rl_policy
    from repro_torch.serving.scheduler import get_scheduler

    from pbench import program
    eng = config["engine"]
    prof = program.profile(config)
    engines = [LLMInstance(cfg, params, prof, get_scheduler("fcfs"),
                           n_slots=eng["slots"], cache_len=eng["cache_len"],
                           instance_id=i, device=device)
               for i in range(eng["instances"])]
    m = eng["instances"]
    policy = restore_rl_policy(program.router_cfg(m), router_dir, m=m,
                               device=device)
    adapter = EngineClusterAdapter(engines)
    gw = Gateway(GatewayConfig(backend="engine"), None, policy,
                 cluster=adapter)
    return gw, adapter, engines, policy


def warm(engines, lengths, sync):
    """One prefill of each length (slot 0 of each engine) and one gang
    decode step: the kernels' library loads, cuBLAS picks its kernels and
    the allocator reaches its working set before the stream starts.  The
    engines' bookkeeping is untouched; their first admissions overwrite
    slot 0."""
    import torch
    for e in engines:
        for n in lengths:
            toks = torch.zeros((1, int(n)), dtype=torch.int64,
                               device=e.device)
            with torch.no_grad():
                _, e.cache = e.prefill_fn(e.params, tokens=toks,
                                          cache=e.cache, slot=0)
        toks = torch.zeros((e.n_slots,), dtype=torch.int64, device=e.device)
        with torch.no_grad():
            _, e.cache = e.decode_fn(e.params, cache=e.cache, tokens=toks)
        e.cache["pos"].zero_()
    sync()
