"""The launcher's gateway over the vectorized simulator and with online
learning (``--backend vec``, ``--online`` over ``py`` and ``vec``)
against the JAX package's CLI for the same flags, on the CPU: the stats
its gateway returns, the online learner's counters and every printed
summary line.  The length predictor and the learner's initial weights
are carried from the reference by value (both CLIs otherwise draw them
from their own frameworks' seeded inits); 30-48 requests on 2-4
instances."""
import dataclasses
import sys

import jax
import numpy as np
import pytest
from _torch_rl_support import assert_same, one_torch_thread  # noqa: F401

from repro.core import predictor as ref_pred
from repro.core import rl_router as ref_rl
from repro.core import workload as ref_wl
from repro.core.profiles import V100_LLAMA2_7B as REF_V100
from repro.launch import serve as ref_serve
from repro.training import online as ref_online
from repro_torch.core import dqn as pt_dqn
from repro_torch.core import predictor as pt_pred
from repro_torch.core import rl_router as pt_rl
from repro_torch.core.profiles import V100_LLAMA2_7B as PT_V100
from repro_torch.launch import serve as pt_serve
from repro_torch.training import online as pt_online

SMALL = dict(seq_len=32, d_model=16, n_heads=2, n_layers=1)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def carried(monkeypatch):
    """Both CLIs' predictor is one small reference predictor (the port's
    a copy by value); the port's online learner starts from the
    reference learner's initial weights.  Returns the captured reference
    gateway stats and trainers."""
    ref = ref_pred.BucketPredictor(ref_pred.PredictorConfig(**SMALL),
                                   REF_V100, seed=0)
    ref.fit(ref_wl.generate(256, seed=1), epochs=1, seed=2)
    monkeypatch.setattr(ref_serve, "quick_bucket_predictor",
                        lambda *a, **kw: ref)

    def port_predictor(base, n_train, epochs, device):
        pt = pt_pred.BucketPredictor(pt_pred.PredictorConfig(**SMALL),
                                     PT_V100, device=device)
        pt.from_reference(jax.tree.map(np.asarray, ref.params))
        return pt
    monkeypatch.setattr(pt_serve, "quick_bucket_predictor", port_predictor)

    captured = {"stats": [], "trainers": []}

    class RefGateway(ref_serve.Gateway):
        def run(self, *a, **kw):
            stats = super().run(*a, **kw)
            captured["stats"].append(stats)
            return stats
    monkeypatch.setattr(ref_serve, "Gateway", RefGateway)

    class RefTrainer(ref_online.OnlineTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured["trainers"].append(self)
    monkeypatch.setattr(ref_online, "OnlineTrainer", RefTrainer)

    def port_trainer(cfg, ocfg, m, device):
        ref_cfg = ref_rl.RouterConfig(**dataclasses.asdict(cfg))
        agent = pt_rl.make_agent(cfg, m=m, device=device)
        agent.from_reference(jax.tree.map(
            np.asarray, ref_rl.make_agent(ref_cfg, m=m).params))
        tr = pt_online.OnlineTrainer(cfg, ocfg, agent=agent, m=m,
                                     device=device)
        captured["trainers"].append(tr)
        return tr
    monkeypatch.setattr(pt_serve, "OnlineTrainer", port_trainer)
    return captured


FLAGS = [
    ["--backend", "vec", "--policy", "mixing"],
    ["--backend", "vec", "--online"],
    ["--backend", "py", "--online"],
    ["--backend", "vec", "--online", "--drift", "--guardrail", "0.05",
     "--online-eps", "0.2"],
]


@pytest.mark.parametrize("flags", FLAGS,
                         ids=["vec-mixing", "vec-online", "py-online",
                              "vec-online-drift"])
def test_cli_gateway_matches_reference_cli(flags, carried, capsys,
                                           monkeypatch):
    argv = ["--mode", "gateway", "--requests", "48", "--rate", "3.0"] + \
        flags
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    ref_serve.main()
    want_out = capsys.readouterr().out.splitlines()
    got = pt_serve.serve_gateway(pt_serve.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    got_out = capsys.readouterr().out.splitlines()
    (want,) = carried["stats"]
    pred = got.pop("predictor")
    assert pred["misses"] == 48 and pred["forwards"] > 0
    online = got.pop("online", None)
    assert_same(got, want)
    assert [line for line in got_out if not line.startswith("predictor:")] \
        == want_out
    assert got["n"] + got["shed"] + got["cancelled"] == 48
    if "--online" in flags:
        tr_r, tr_p = carried["trainers"]
        t_r = tr_r.telemetry()
        for key in ("decisions", "transitions", "publishes", "explored",
                    "fallback_entries", "fallback_decisions", "mode",
                    "learn_steps"):
            assert online[key] == t_r[key], key
        assert online["decisions"] > 0 and online["publishes"] == 1
        assert any(line.startswith("online: ") for line in got_out)
        if "--drift" in flags:
            assert online["explored"] > 0 and got["orphaned"] > 0


def test_cli_online_saves_the_learner_and_warm_starts(tmp_path, capsys,
                                                      monkeypatch):
    """``--save-learner`` writes the full learner at run end (and closes
    its writer); ``--checkpoint`` warm-starts the next run from it.  A
    small predictor and a 4096-row replay buffer keep the run short."""
    monkeypatch.setattr(
        pt_serve, "quick_bucket_predictor",
        lambda base, n_train, epochs, device: pt_pred.BucketPredictor(
            pt_pred.PredictorConfig(**SMALL), PT_V100, device=device))

    def small_trainer(cfg, ocfg, m, device):
        agent = pt_rl.make_agent(cfg, m=m, device=device)
        agent = pt_dqn.DQNAgent(dataclasses.replace(
            agent.cfg, buffer_size=4096), device=device)
        return pt_online.OnlineTrainer(cfg, ocfg, agent=agent, m=m,
                                       device=device)
    monkeypatch.setattr(pt_serve, "OnlineTrainer", small_trainer)
    save = str(tmp_path / "learner")
    argv = ["--mode", "gateway", "--backend", "vec", "--online",
            "--requests", "30", "--rate", "3.0", "--instances", "2",
            "--device", "cpu"]
    first = pt_serve.serve_gateway(pt_serve.build_parser().parse_args(
        argv + ["--save-learner", save]))
    assert first["n"] == 30 and first["online"]["publishes"] == 1
    from repro_torch.training.checkpoint import CheckpointManager
    mgr = CheckpointManager(save)
    try:
        assert mgr.latest_step() == 0
    finally:
        mgr.close()
    stats = pt_serve.serve_gateway(pt_serve.build_parser().parse_args(
        argv + ["--checkpoint", save]))
    assert stats["n"] == 30
    # the replay buffer carries the first run's transitions on
    assert stats["online"]["replay_size"] == \
        first["online"]["transitions"] + stats["online"]["transitions"]
