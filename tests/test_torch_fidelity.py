"""The port's sim-vs-engine fidelity harness (``repro_torch.serving.
fidelity``) held to the reference's: streams, per-backend reports,
pairwise deltas and the formatted report equal key for key and float for
float (every clock is virtual), over the ``py`` and ``vec`` simulators
and over reduced qwen3-0.6b engines holding the reference's parameters,
for the default stream, the saturating stream and the multi-turn session
stream with a prefix cache.  Both sides run with ``backends`` that leave
out ``jax``: the reference's device-resident simulator does not import
on this tree (the port's runs against the reference's in
tests/test_torch_jaxsim*.py, and against ``vec`` here, where the
gateway's one-tick spans keep it on its host rounds)."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as REF_REGISTRY
from repro.core.profiles import V100_LLAMA2_7B as REF_V100
from repro.models import params as ref_params
from repro.serving import fidelity as ref_fid
from repro_torch.configs import get_config
from repro_torch.core import jaxsim
from repro_torch.core.profiles import V100_LLAMA2_7B as PT_V100
from repro_torch.models import params as pt_params
from repro_torch.serving import fidelity as pt_fid

# engine-sized streams on reduced engines (a few seconds a side)
STREAMS = {
    "default": dict(n_requests=12, n_instances=1, n_slots=2, cache_len=64,
                    capacity_tokens=200, prompt_lengths=(16, 32),
                    decode_range=(4, 12), rate=6.0),
    "saturate": dict(n_requests=12, n_instances=1, n_slots=2, cache_len=64,
                     capacity_tokens=80, prompt_lengths=(16, 32),
                     decode_range=(4, 12), rate=6.0, saturate=True),
    "sessions": dict(n_requests=12, n_instances=2, n_slots=2, cache_len=128,
                     capacity_tokens=400, prompt_lengths=(16, 32),
                     decode_range=(4, 12), rate=6.0, sessions=True,
                     prefix_cache_tokens=256),
}
SIM = ("py", "vec")
ALL = ("py", "vec", "engine")


def _configs(kind, backends, **over):
    kw = dict(STREAMS[kind], backends=backends, **over)
    return ref_fid.FidelityConfig(**kw), pt_fid.FidelityConfig(**kw)


@pytest.fixture(scope="module")
def reduced_qwen3():
    """(reference cfg, params), (port cfg, the same params by value)."""
    cfg_ref = REF_REGISTRY["qwen3-0.6b"].reduced()
    pr = ref_params.init_params(jax.random.PRNGKey(0), cfg_ref)
    pt = pt_params.from_reference(jax.tree.map(np.asarray, pr),
                                  device="cpu")
    return (cfg_ref, pr), (get_config("qwen3-0.6b").reduced(), pt)


def test_config_defaults_and_the_one_difference():
    ref, port = (dataclasses.asdict(ref_fid.FidelityConfig()),
                 dataclasses.asdict(pt_fid.FidelityConfig()))
    assert port["backends"] == ("py", "vec", "jax", "engine")
    assert port == ref
    assert pt_fid.METRICS == ref_fid.METRICS


@pytest.mark.parametrize("kind", sorted(STREAMS))
@pytest.mark.parametrize("n", [12, 31])
def test_stream_equals_the_reference(kind, n):
    ref, port = _configs(kind, SIM, n_requests=n)
    stream = pt_fid.make_stream(port)
    assert stream == ref_fid.make_stream(ref)
    assert len(stream) == n
    assert stream == pt_fid.make_stream(port)


@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_simulator_reports_equal_the_reference(kind):
    ref, port = _configs(kind, SIM)
    rep = pt_fid.run_fidelity(PT_V100, port)
    assert rep == ref_fid.run_fidelity(REF_V100, ref)
    assert rep["backends"]["vec"] == rep["backends"]["py"]
    for metric in pt_fid.METRICS:
        for pct in rep["deltas"]["vec_vs_py"][metric].values():
            assert pct["abs"] == 0.0 and pct["rel"] == 0.0
    assert rep["profile"]["capacity_tokens"] <= port.capacity_tokens
    assert rep["profile"]["max_batch"] == port.n_slots


@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_jax_leg_runs_host_rounds_and_equals_vec(kind, monkeypatch):
    """The ``jax`` leg (on the CPU) reports what ``vec`` reports; the
    gateway advances one tick a call, under the pool's 8-tick minimum
    span, so its one pool runs only the inherited numpy rounds."""
    pools = []

    class CountedPool(jaxsim.JaxSimPool):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            pools.append(self)
    monkeypatch.setattr(jaxsim, "JaxSimPool", CountedPool)
    _, port = _configs(kind, ("py", "vec", "jax"))
    rep = pt_fid.run_fidelity(PT_V100, port, device="cpu")
    assert rep["backends"]["jax"] == rep["backends"]["vec"]
    assert rep["backends"]["jax"]["completed"] == port.n_requests
    assert len(pools) == 1 and pools[0].device.type == "cpu"
    assert pools[0].n_jax_calls == 0 and pools[0].n_numpy_calls > 0


@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_engine_reports_equal_the_reference(kind, reduced_qwen3):
    (cfg_ref, pr), (cfg_pt, pt) = reduced_qwen3
    ref, port = _configs(kind, ALL)
    rep = pt_fid.run_fidelity(PT_V100, port, model_cfg=cfg_pt, params=pt)
    ref_rep = ref_fid.run_fidelity(REF_V100, ref, model_cfg=cfg_ref,
                                   params=pr)
    assert rep == ref_rep
    assert pt_fid.format_report(rep) == ref_fid.format_report(ref_rep)
    engine = rep["backends"]["engine"]
    assert engine["completed"] == port.n_requests
    if kind == "saturate":
        assert rep["deltas"]["engine_vs_py"]["preemptions"]["both_preempt"]
    if kind == "sessions":
        assert engine["cache_hit_rate"] > 0


def test_calibrated_profile_report_and_text_equal_the_reference(tmp_path):
    """A profile with a prefill intercept and a slower decode base, as a
    card's calibration gives, through the simulators; the saved report
    is plain JSON."""
    over = dict(t_decode_base=0.06, grad1=5e-5, grad2=1e-9,
                t_prefill_base=0.02, name="calibrated")
    ref, port = _configs("default", SIM)
    rep = pt_fid.run_fidelity(dataclasses.replace(PT_V100, **over), port)
    ref_rep = ref_fid.run_fidelity(dataclasses.replace(REF_V100, **over),
                                   ref)
    assert rep == ref_rep
    assert pt_fid.format_report(rep) == ref_fid.format_report(ref_rep)
    path = tmp_path / "report.json"
    pt_fid.save_report(rep, str(path))
    ref_path = tmp_path / "ref.json"
    ref_fid.save_report(ref_rep, str(ref_path))
    assert path.read_text() == ref_path.read_text()
    assert json.loads(path.read_text())["profile"]["name"] == "calibrated"


def test_engine_leg_builds_seeded_engines_on_the_given_device():
    """Without params the engine leg builds seeded parameters on
    ``device`` (the card unless the caller asks for the CPU); without a
    model config it refuses."""
    _, port = _configs("default", ("py", "engine"), n_requests=4)
    cfg = get_config("qwen3-0.6b").reduced()
    rep = pt_fid.run_fidelity(PT_V100, port, model_cfg=cfg, device="cpu")
    assert rep["backends"]["engine"]["completed"] == 4
    with pytest.raises(ValueError, match="model_cfg"):
        pt_fid.run_fidelity(PT_V100, port, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt_fid.run_fidelity(PT_V100, port, model_cfg=cfg)
