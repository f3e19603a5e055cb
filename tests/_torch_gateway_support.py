"""Shared set-up of the engine-backed gateway parity tests
(``test_torch_gateway.py`` and ``test_torch_gateway_rl.py``).

Two reduced llama-2-7b engines on each side, as the launchers'
``_tiny_engines`` build them (4 slots, 128-token caches, a 400-token
budget so preemption happens), the port's holding the reference's
parameters by value; ``engines(arch="falcon-mamba-7b")`` builds reduced
falcon-mamba engines instead, the reference's with ``mamba.chunk``
raised to the cache length so that its scans take every prompt length
(the chunk leaves the function unchanged; the port has none).  The
request stream is short and draws its prompt lengths from three values:
every distinct length compiles the JAX engine's prefill again.  A
gateway run records its routing decisions and returns them with the
stats and every request's virtual-clock stamps, which the tests hold
equal exactly."""
import dataclasses
import json

import jax
import numpy as np
import torch

from repro.configs import REGISTRY as REF_REGISTRY
from repro.core import rl_router as ref_rl
from repro.core.profiles import V100_LLAMA2_7B as REF_V100
from repro.models import params as ref_params
from repro.serving import chaos as ref_chaos
from repro.serving import engine as ref_engine
from repro.serving import gateway as ref_gw
from repro.serving import policies as ref_pol
from repro.serving import request as ref_request
from repro.serving.scheduler import get_scheduler as ref_get_scheduler
from repro_torch.configs import get_config
from repro_torch.core import rl_router as pt_rl
from repro_torch.core.profiles import V100_LLAMA2_7B as PT_V100
from repro_torch.models import params as pt_params
from repro_torch.serving import chaos as pt_chaos
from repro_torch.serving import engine as pt_engine
from repro_torch.serving import gateway as pt_gw
from repro_torch.serving import policies as pt_pol
from repro_torch.serving import request as pt_request
from repro_torch.serving.scheduler import get_scheduler as pt_get_scheduler

ARCH = "llama-2-7b"
N_SLOTS, CACHE_LEN, CAPACITY = 4, 128, 400
PROMPTS = (24, 40, 72)
PREFIX_BLOCK = 8


def ref_config(arch, **over):
    """The reference's reduced config; a mamba config's scan chunk is
    raised to the cache length, so that its scans take any prompt."""
    cfg = REF_REGISTRY[arch].reduced(**over)
    if cfg.mamba is not None:
        cfg = dataclasses.replace(cfg, mamba=dataclasses.replace(
            cfg.mamba, chunk=CACHE_LEN))
    return cfg


def engines(int8=False, n=2, prefix_cache=0, arch=ARCH):
    """(reference engines, port engines) sharing one set of weights."""
    over = {"kv_cache_dtype": "int8"} if int8 else {}
    cfg_ref = ref_config(arch, **over)
    cfg_pt = get_config(arch).reduced(**over)
    pr = ref_params.init_params(jax.random.PRNGKey(0), cfg_ref)
    pt = pt_params.from_reference(jax.tree.map(np.asarray, pr),
                                  device="cpu")
    kw = dict(n_slots=N_SLOTS, cache_len=CACHE_LEN,
              prefix_cache_tokens=prefix_cache, prefix_block=PREFIX_BLOCK)
    ref = [ref_engine.LLMInstance(
        cfg_ref, pr, dataclasses.replace(REF_V100, capacity_tokens=CAPACITY),
        ref_get_scheduler("fcfs"), instance_id=i, **kw) for i in range(n)]
    port = [pt_engine.LLMInstance(
        cfg_pt, pt, dataclasses.replace(PT_V100, capacity_tokens=CAPACITY),
        pt_get_scheduler("fcfs"), instance_id=i, device="cpu", **kw)
        for i in range(n)]
    return ref, port


def stream(module, n=10, seed=0, gap=0.05):
    """Seeded requests with explicit rids (both engines then draw the
    same prompt tokens) and prefix hash chains, two conversations'
    worth, so the cache-aware policies see hits."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        p = int(rng.choice(PROMPTS))
        hashes = tuple(range(1000 * (i % 2), 1000 * (i % 2)
                             + p // PREFIX_BLOCK))
        reqs.append(module.Request(
            prompt_tokens=p, decode_tokens=int(rng.integers(5, 60)),
            arrival=gap * i, tenant="engine", rid=5000 + i,
            prefix_hashes=hashes, full_hashes=hashes))
    return reqs


def run(side, engine_list, policy, reqs, **gcfg_kw):
    """Serve ``reqs`` through the gateway over ``engine_list``; return
    (decisions, stats as JSON, per-request stamps)."""
    gw = ref_gw if side == "ref" else pt_gw
    cluster = gw.EngineClusterAdapter(engine_list)
    decisions = []
    route = cluster.route

    def recording_route(idx):
        req = route(idx)
        decisions.append((req.rid, int(idx), cluster.t))
        return req
    cluster.route = recording_route
    g = gw.Gateway(gw.GatewayConfig(**gcfg_kw), None, policy,
                   cluster=cluster)
    stats = g.run(reqs)
    stamps = [(r.rid, r.instance, r.phase.name, r.routed_at,
               r.prefill_done, r.first_token, r.finished, r.token_times,
               r.preemptions, r.retries, r.hedges, r.decoded,
               r.cached_prefix) for r in reqs]
    return decisions, json.dumps(stats, sort_keys=True, default=str), stamps


def assert_same(ref_out, pt_out):
    """Decisions, stats (``n``, admitted, shed, preemptions, the
    snapshot's percentiles...) and stamps equal exactly."""
    assert pt_out[0] == ref_out[0]
    assert pt_out[1] == ref_out[1]
    assert pt_out[2] == ref_out[2]
    assert len(ref_out[0]) > 0


MODULES = {"ref": ref_request, "pt": pt_request}


SIDES = (("ref", ref_rl, ref_pol, ref_chaos), ("pt", pt_rl, pt_pol, pt_chaos))


def rl_policies(arch, m=2):
    """RLPolicy on each side; the port's agent holds the reference's
    parameters."""
    kw = dict(variant="guided", n_instances=m, q_arch=arch, seed=0)
    ref_cfg, pt_cfg = ref_rl.RouterConfig(**kw), pt_rl.RouterConfig(**kw)
    ref_agent = ref_rl.make_agent(ref_cfg)
    pt_agent = pt_rl.make_agent(pt_cfg, device="cpu")
    pt_agent.from_reference(jax.tree.map(np.asarray, ref_agent.params))
    return {"ref": ref_pol.RLPolicy(ref_agent, ref_cfg),
            "pt": pt_pol.RLPolicy(pt_agent, pt_cfg)}


def heuristic(name):
    return {side: pol.make_gateway_policy(name, rl.RouterConfig(
        n_instances=2)) for side, rl, pol, _ in SIDES}


def chaos_schedule(chaos_mod):
    return chaos_mod.FaultSchedule.random(seed=7, m=2, horizon=1.0,
                                          n_crashes=1, n_stragglers=1)


def serve_both(policies, int8=False, prefix_cache=0, chaos=False,
               arch=ARCH, **gcfg):
    """The same stream through the gateway on each side (with
    ``chaos``: a seeded crash + straggler schedule, failover and
    hedging); returns (reference's, port's) ``run`` results."""
    ref_e, pt_e = engines(int8=int8, prefix_cache=prefix_cache, arch=arch)
    out = []
    for (side, _, _, chaos_mod), eng in zip(SIDES, (ref_e, pt_e)):
        kw = dict(gcfg)
        if chaos:
            kw.update(chaos=chaos_schedule(chaos_mod), failover=True,
                      hedge_after_s=0.3)
        with torch.no_grad():
            out.append(run(side, eng, policies[side],
                           stream(MODULES[side]), **kw))
    return out
