"""The port's serving paths over reduced falcon-mamba engines against the
JAX package's: ``serve_engine`` (impact-heuristic routing), and the
gateway under ``mixing`` and ``rl`` and under a seeded crash + straggler
schedule with failover and hedging (``fail``, ``recover`` and ``steal``
over an SSM cache).

Two reduced falcon-mamba engines on each side (``_torch_gateway_support``:
4 slots, a 400-token budget so preemption happens, three prompt lengths,
the reference's scan chunk raised so that it takes the ragged ones).
Decisions, stats and every request's virtual-clock stamps are equal
exactly; after a gateway run (explicit rids, so both sides draw the same
prompt tokens) each engine's conv/ssm cache is within 1e-4 of the
reference engine's (the port writes prefill states into the slot in
place, the reference overwrites the whole slot row)."""
import argparse
import json

import jax
import numpy as np
import pytest
import torch

from _torch_gateway_support import MODULES, assert_same, engines, \
    heuristic, rl_policies, run, serve_both, stream
from repro.launch import serve as ref_serve
from repro_torch.launch import serve as pt_serve

ARCH = "falcon-mamba-7b"
TOL = 1e-4
STAMPS = ("instance", "routed_at", "prefill_done", "first_token",
          "finished", "token_times", "preemptions", "decoded")


def _assert_caches_close(ref_engines, pt_engines):
    for ref_e, pt_e in zip(ref_engines, pt_engines):
        ref_c = jax.tree.map(np.asarray, ref_e.cache)
        np.testing.assert_array_equal(pt_e.cache["pos"].numpy(),
                                      ref_c["pos"])
        for e_pt, e_ref in zip(pt_e.cache["layers"], ref_c["layers"]):
            assert set(e_pt) == set(e_ref) == {"conv", "ssm"}
            for name in e_ref:
                np.testing.assert_allclose(e_pt[name].numpy(), e_ref[name],
                                           rtol=TOL, atol=TOL,
                                           err_msg=name)


@pytest.mark.parametrize("policy", ["mixing", "rl"])
def test_gateway_over_mamba_engines_matches_reference(policy):
    ref_e, pt_e = engines(arch=ARCH)
    pols = rl_policies("decomposed") if policy == "rl" \
        else heuristic(policy)
    out = []
    for side, eng in (("ref", ref_e), ("pt", pt_e)):
        with torch.no_grad():
            out.append(run(side, eng, pols[side], stream(MODULES[side])))
    assert_same(*out)
    assert json.loads(out[1][1])["n"] == 10
    _assert_caches_close(ref_e, pt_e)


def test_chaos_failover_over_mamba_engines_matches_reference():
    ref, pt = serve_both(heuristic("mixing"), chaos=True, arch=ARCH)
    assert_same(ref, pt)
    stats = json.loads(pt[1])
    assert stats["orphaned"] > 0 and stats["n"] == 10


def test_serve_engine_over_mamba_engines_matches_reference(capsys,
                                                           monkeypatch):
    """``serve_engine``'s summary and every served request's stamps.
    Its stream takes rids from each package's process-wide counter, so
    the two sides' rids (and prompt tokens) may differ: the caches are
    compared by the gateway tests, preemption over an SSM cache by
    ``test_torch_engine.py``'s lockstep test."""
    ref_e, pt_e = engines(arch=ARCH)
    monkeypatch.setattr(ref_serve, "_tiny_engines", lambda args: ref_e)
    args = argparse.Namespace(arch=ARCH, scheduler="fcfs", instances=2,
                              requests=6, prefix_cache=0, prefix_block=32,
                              profile_json=None, calibrate=False,
                              device="cpu")
    ref_serve.serve_engine(args)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    with torch.no_grad():
        stats = pt_serve.serve_engine(args, insts=pt_e)
    assert stats["n"] == 6 and repr(stats) == want
    for ref_i, pt_i in zip(ref_e, pt_e):
        assert [tuple(getattr(r, f) for f in STAMPS)
                for r in pt_i.completed] == [
            tuple(getattr(r, f) for f in STAMPS) for r in ref_i.completed]
