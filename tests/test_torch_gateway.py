"""The port's serving gateway over real engines against the JAX
package's, for the heuristic policies (rr, jsq, mixing, mixing+cache,
sticky), with and without a bounded admission queue, and the port's
``serve`` CLI against the reference's.

Two reduced llama-2-7b engines on each side (``_torch_gateway_support``):
the routing decisions, ``n``, admitted, shed, preemptions, the
streaming snapshot's TTFT/TBT/E2E percentiles and every request's
virtual-clock stamps are equal exactly -- the engines' clocks depend on
the scheduling code, which is the reference's line for line, not on the
model's numbers.  The RL policy, chaos and the int8 cache are in
``test_torch_gateway_rl.py``."""
import json
import sys

import pytest
import torch

from _torch_gateway_support import MODULES, assert_same, engines, run, \
    stream
from repro.core import rl_router as ref_rl
from repro.launch import serve as ref_serve
from repro.serving import policies as ref_pol
from repro_torch.core import rl_router as pt_rl
from repro_torch.launch import serve as pt_serve
from repro_torch.serving import policies as pt_pol


def _both(policy, prefix_cache=0, n=10, gap=0.05, **gcfg):
    ref_e, pt_e = engines(prefix_cache=prefix_cache)
    cfg_kw = dict(n_instances=2)
    out = []
    for side, eng, pol, rl in (("ref", ref_e, ref_pol, ref_rl),
                               ("pt", pt_e, pt_pol, pt_rl)):
        policy_obj = pol.make_gateway_policy(policy,
                                             rl.RouterConfig(**cfg_kw))
        with torch.no_grad():
            out.append(run(side, eng, policy_obj,
                           stream(MODULES[side], n, gap=gap),
                           **gcfg))
    return out


@pytest.mark.parametrize("policy", ["rr", "jsq", "mixing", "mixing+cache",
                                    "sticky"])
def test_gateway_over_engines_matches_reference(policy):
    ref, pt = _both(policy, prefix_cache=256)
    assert_same(ref, pt)


@pytest.mark.parametrize("policy,on_full", [("jsq", "shed"),
                                            ("mixing", "defer")])
def test_bounded_queue_over_engines_matches_reference(policy, on_full):
    # four arrivals per 0.02 s routing tick overflow a 2-deep queue
    ref, pt = _both(policy, n=12, gap=0.005, queue_cap=2, on_full=on_full)
    assert_same(ref, pt)
    stats = json.loads(pt[1])
    if on_full == "shed":
        assert stats["shed"] > 0
        assert stats["admitted"] + stats["shed"] == 12
    else:
        assert stats["shed"] == 0 and stats["n"] == 12


CLI = [
    ["--policy", "jsq"],
    ["--policy", "rl"],          # no checkpoint: warns, serves mixing
    ["--policy", "rr", "--chaos-seed", "7", "--failover"],
]


@pytest.mark.parametrize("flags", CLI, ids=lambda f: "-".join(f[1:4:2]))
def test_serve_cli_prints_the_reference_summary(flags, capsys,
                                                monkeypatch):
    argv = ["--mode", "gateway", "--backend", "engine", "--requests", "4",
            "--instances", "2"] + flags
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    ref_serve.main()
    want = capsys.readouterr().out
    pt_serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert "served n=4" in got
    assert got == want
