"""The port's gateway over the ``py`` simulator with the learned length
predictor in the loop, against the JAX package's; the trace and metrics
export (``serving/obs.py``); and the launcher's simulator modes on the
CPU.  Predictors and agents are carried from the reference by value;
the streams are short (40-60 requests, 3 instances)."""
import json
import os

import jax
import numpy as np
import pytest
from _torch_rl_support import assert_same

from repro.core import predictor as ref_pred
from repro.core import rl_router as ref_rl
from repro.core import workload as ref_wl
from repro.core.profiles import V100_LLAMA2_7B as REF_V100
from repro.serving import gateway as ref_gw
from repro.serving import obs as ref_obs
from repro.serving import policies as ref_pol
from repro.serving import trace as ref_trace
from repro_torch.core import predictor as pt_pred
from repro_torch.core import rl_router as pt_rl
from repro_torch.core import workload as pt_wl
from repro_torch.core.profiles import V100_LLAMA2_7B as PT_V100
from repro_torch.launch import serve
from repro_torch.serving import gateway as pt_gw
from repro_torch.serving import obs as pt_obs
from repro_torch.serving import policies as pt_pol
from repro_torch.serving import trace as pt_trace

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_trace.json")
SMALL = dict(seq_len=32, d_model=16, n_heads=2, n_layers=1)


def _predictors():
    ref = ref_pred.BucketPredictor(ref_pred.PredictorConfig(**SMALL),
                                   REF_V100, seed=0)
    ref.fit(ref_wl.generate(256, seed=1), epochs=1, seed=2)
    pt = pt_pred.BucketPredictor(pt_pred.PredictorConfig(**SMALL),
                                 PT_V100, device="cpu")
    pt.from_reference(jax.tree.map(np.asarray, ref.params))
    return ref, pt


def _policies(name):
    kw = dict(n_instances=3, q_arch="decomposed")
    if name != "rl":
        return (ref_pol.make_gateway_policy(name, ref_rl.RouterConfig()),
                pt_pol.make_gateway_policy(name, pt_rl.RouterConfig()))
    ref_agent = ref_rl.make_agent(ref_rl.RouterConfig(**kw))
    pt_agent = pt_rl.make_agent(pt_rl.RouterConfig(**kw), device="cpu")
    pt_agent.from_reference(jax.tree.map(np.asarray, ref_agent.params))
    return (ref_pol.RLPolicy(ref_agent, ref_rl.RouterConfig(**kw)),
            pt_pol.RLPolicy(pt_agent, pt_rl.RouterConfig(**kw)))


def _gateway_run(gw, wl, trace, obs, prof, pred, policy, **gcfg):
    scn = wl.make_tenant_scenario(seed=7, n_requests=60, rate=2.5,
                                  pattern="bursty", profiles=(prof,) * 3)
    length = gw.MicroBatchPredictor(pred)
    rec = trace.TraceRecorder()
    g = gw.Gateway(gw.GatewayConfig(attribution=True, **gcfg),
                   (prof,) * 3, policy, length=length, trace=rec)
    stats = g.run(scn)
    return (stats, [(r.instance, r.finished, r.predicted_bucket)
                    for r in scn.requests],
            (length.hits, length.misses, length.forwards),
            _rebased(obs.chrome_trace(rec),
                     min(r.rid for r in scn.requests)))


def _rebased(doc, base):
    """A Chrome trace with request ids rebased to 0..n-1: ids come from
    a process-wide counter, so they depend on what ran before."""
    for e in doc["traceEvents"]:
        rid = e.get("args", {}).get("rid")
        if rid is not None and rid >= 0:
            e["args"]["rid"] = rid - base
    return json.loads(json.dumps(doc))



@pytest.mark.parametrize("gcfg", [{}, {"queue_cap": 4}],
                         ids=["unbounded", "shedding"])
@pytest.mark.parametrize("policy", ["mixing", "rl"])
def test_gateway_with_predictor_matches_reference(policy, gcfg):
    pred_r, pred_p = _predictors()
    pol_r, pol_p = _policies(policy)
    want = _gateway_run(ref_gw, ref_wl, ref_trace, ref_obs, REF_V100, pred_r,
                        pol_r, **gcfg)
    # the port's request ids start elsewhere than the reference's, as
    # they do after other tests in the same process
    pt_wl.to_requests(pt_wl.generate(7, seed=0), rate=1.0)
    got = _gateway_run(pt_gw, pt_wl, pt_trace, pt_obs, PT_V100, pred_p,
                       pol_p, **gcfg)
    assert_same(got[0], want[0])
    assert got[1] == want[1]
    assert got[2] == want[2] and got[2][1] > 0
    if gcfg:
        assert got[0]["shed"] > 0
    # the traces render to the same Chrome document (the rl policy's
    # route events carry its float32 Q-values, |Q| < 1 here, held to
    # 1e-6 of their scale as in test_torch_router.py), and the
    # registries to the same Prometheus text
    assert_same(got[3], want[3], "trace",
                 abs_=1e-6 if policy == "rl" else 1e-12)
    regs = []
    for obs, (stats, *_), agent in ((ref_obs, want, getattr(pol_r, "agent",
                                                            None)),
                                    (pt_obs, got, getattr(pol_p, "agent",
                                                          None))):
        reg = obs.MetricsRegistry()
        reg.ingest_snapshot(stats["snapshot"])
        if agent is not None:
            reg.ingest_rl(agent.telemetry())
        regs.append(reg)
    assert regs[1].to_prometheus() == regs[0].to_prometheus()
    assert regs[1].to_json() == regs[0].to_json() and len(regs[1]) > 50


def _golden_run():
    """``tests/test_trace.py``'s golden gateway run, on the port."""
    scn = pt_wl.make_tenant_scenario(seed=2, n_requests=15, rate=6.0,
                                     profiles=(PT_V100,) * 2)
    rec = pt_trace.TraceRecorder()
    gw = pt_gw.Gateway(pt_gw.GatewayConfig(), (PT_V100,) * 2,
                       pt_pol.make_gateway_policy("mixing"), trace=rec)
    gw.run(scn)
    return _rebased(pt_obs.chrome_trace(rec, title="golden"),
                    min(r.rid for r in scn.requests))


def test_chrome_trace_matches_golden_snapshot():
    doc = _golden_run()
    assert pt_obs.validate_chrome_trace(doc) == []
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert doc == golden


def test_validate_chrome_trace_matches_reference():
    docs = [[], {}, {"traceEvents": 3}, _golden_run(),
            {"traceEvents": [{"name": "x", "ph": "Z", "pid": 0, "ts": 0.0},
                             {"name": "x", "ph": "X", "pid": 0, "ts": 0.0},
                             {"name": "x", "ph": "i", "pid": 0, "ts": -1.0},
                             {"name": "x", "ph": "C", "pid": 0, "ts": 0.0,
                              "args": {}}, "not-an-object",
                             {"ph": "M"}]}]
    for doc in docs:
        assert pt_obs.validate_chrome_trace(doc) == \
            ref_obs.validate_chrome_trace(doc)


def test_registry_renders_as_reference(tmp_path):
    snap = {"e2e": {"p95": 1.5, "n_window": 10}, "slo_rate": 0.9,
            "tenants": {"a-b": {"shed": 2}}, "skipped": None, "ok": True,
            "label": "text", "9lives": 3, "lst": [1, 2]}
    regs = []
    for obs in (ref_obs, pt_obs):
        reg = obs.MetricsRegistry()
        reg.ingest_snapshot(snap)
        reg.ingest_rl({"loss": 0.25, "learn_steps": 3.0})
        reg.set("x.y", 2)
        regs.append(reg)
    assert regs[1].to_prometheus() == regs[0].to_prometheus()
    assert regs[1].to_json() == regs[0].to_json()
    assert regs[1]["gateway_e2e_p95"] == 1.5
    for name in ("m.json", "m.prom"):
        regs[1].save(str(tmp_path / ("pt_" + name)))
        regs[0].save(str(tmp_path / ("ref_" + name)))
        assert (tmp_path / ("pt_" + name)).read_text() == \
            (tmp_path / ("ref_" + name)).read_text()


def test_obs_cli_validates_and_rejects(tmp_path, capsys):
    good = tmp_path / "good.json"
    good.write_text(json.dumps(_golden_run()))
    metrics = tmp_path / "m.json"
    metrics.write_text(json.dumps({"a": 1.0}))
    assert pt_obs.main(["--validate", str(good), "--metrics",
                        str(metrics)]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"name": "x", "ph": "Z",
                                                "pid": 0, "ts": 0}]}))
    assert pt_obs.main(["--validate", str(bad)]) == 1
    metrics.write_text(json.dumps({"a": "b"}))
    assert pt_obs.main(["--validate", str(good), "--metrics",
                        str(metrics)]) == 1
    out = capsys.readouterr().out
    assert "OK" in out and "INVALID" in out


def test_cli_sim_mode_on_the_cpu(capsys):
    stats = serve.serve_sim(serve.build_parser().parse_args(
        ["--mode", "sim", "--requests", "40", "--train-episodes", "1",
         "--instances", "3", "--rate", "2.5", "--device", "cpu"]))
    assert stats["n"] == 40 and stats["events"] == []
    assert "served n=40" in capsys.readouterr().out


def test_cli_gateway_rl_on_the_cpu_writes_trace_and_metrics(tmp_path,
                                                            capsys):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.prom"
    serve.main(["--mode", "gateway", "--policy", "rl", "--requests", "40",
                "--train-episodes", "1", "--rate", "2.5", "--trace",
                str(trace), "--metrics-out", str(metrics), "--device",
                "cpu"])
    out = capsys.readouterr().out
    assert "policy=rl served n=40 admitted=40 shed=0" in out
    assert "predictor: hits=0 misses=40" in out
    doc = json.loads(trace.read_text())
    assert pt_obs.validate_chrome_trace(doc) == []
    assert len(doc["traceEvents"]) > 100
    prom = metrics.read_text()
    assert "gateway_e2e_p95" in prom and "rl_learn_steps" in prom
    assert "gateway_attribution" in prom


def test_cli_gateway_restores_the_router_from_a_checkpoint(tmp_path,
                                                          capsys):
    """``--policy rl --checkpoint`` over the simulator, from a router
    trained and saved by the port."""
    from repro_torch.training.checkpoint import CheckpointManager
    args = serve.build_parser().parse_args(
        ["--mode", "gateway", "--policy", "rl", "--requests", "30",
         "--instances", "2", "--train-episodes", "1", "--rate", "2.5",
         "--device", "cpu", "--pattern", "poisson"])
    agent = serve._train_quick_agent(args, serve._router_cfg(args))[
        "agent"]
    mgr = CheckpointManager(str(tmp_path))
    try:
        mgr.save(1, agent.state_dict(), sync=True)
    finally:
        mgr.close()
    args.checkpoint = str(tmp_path)
    stats = serve.serve_gateway(args)
    assert stats["n"] == 30 and stats["policy"] == "rl"
    assert stats["predictor"]["misses"] == 30
