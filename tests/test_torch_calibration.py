"""The port's calibration (``repro_torch.core.calibrate``,
``core.profiles.fit`` and ``launch.serve --calibrate``) held to the
reference's on the same samples: fits, artifacts and reports equal, the
JSON artifact readable across packages, the sweeps' grids, and the CLI's
output and gate.  The samples are the reference test's stub engine
(``tests/test_calibration.py``): a known profile's timings, with and
without noise, and an inverted-gradient profile that must fail the
sanity check."""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as REF_REGISTRY
from repro.core import calibrate as ref_cal
from repro.core import profiles as ref_profiles
from repro.launch import serve as ref_serve
from repro_torch.configs import get_config
from repro_torch.core import calibrate as pt_cal
from repro_torch.core import profiles as pt_profiles
from repro_torch.launch import serve as pt_serve
from repro_torch.models import params as pt_params

GROUND_TRUTH = dict(name="stub-gpu", grad1=2.4e-4, grad2=1.9e-5,
                    t_decode_base=0.011, t_prefill_base=3.0e-4,
                    capacity_tokens=5_000)
INVERTED = dict(GROUND_TRUTH, grad1=1e-6, grad2=1e-4)
CASES = {"noiseless": (GROUND_TRUTH, 0.0), "noisy": (GROUND_TRUTH, 0.01),
         "inverted": (INVERTED, 0.0)}


def _stub_engine_samples(fields, noise=0.0, seed=0):
    """What the sweep would measure on an engine whose true cost model
    is the profile ``fields``, on the reference's default grid (the
    reference test's helper)."""
    profile = ref_profiles.HardwareProfile(**fields)
    rng = np.random.default_rng(seed)
    ccfg = ref_cal.CalibrationConfig()

    def jitter():
        return 1.0 + noise * rng.standard_normal()
    pre = [(float(p),
            (profile.t_prefill_base + profile.grad1 * p) * jitter())
           for p in ccfg.prompt_grid]
    dec = [(float(b * c),
            (profile.t_decode_base + profile.grad2 * b * c) * jitter())
           for b, c in ccfg.decode_grid]
    return pre, dec


def _fits(case):
    fields, noise = CASES[case]
    pre, dec = _stub_engine_samples(fields, noise)
    ref = ref_cal.fit_calibration(
        pre, dec, base=ref_profiles.HardwareProfile(**fields), name="refit")
    port = pt_cal.fit_calibration(
        pre, dec, base=pt_profiles.HardwareProfile(**fields), name="refit")
    return pre, dec, ref, port


def test_defaults_equal_the_reference():
    assert (dataclasses.asdict(pt_cal.CalibrationConfig())
            == dataclasses.asdict(ref_cal.CalibrationConfig()))
    assert pt_cal.load_profile is pt_profiles.load_profile


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_equals_the_reference(case):
    pre, dec, ref, port = _fits(case)
    for samples in (pre, dec):
        assert (pt_cal.linear_fit(samples).to_json()
                == ref_cal.linear_fit(samples).to_json())
    assert port.to_json() == ref.to_json()
    assert port.ok == ref.ok == (case != "inverted")
    assert pt_cal.format_result(port) == ref_cal.format_result(ref)
    # the thresholds are inherited from the base, not fitted
    assert port.profile.capacity_tokens == GROUND_TRUTH["capacity_tokens"]
    base_ref = ref_profiles.HardwareProfile(**CASES[case][0])
    base_pt = pt_profiles.HardwareProfile(**CASES[case][0])
    assert (pt_profiles.profile_to_json(pt_profiles.fit(pre, dec, base_pt))
            == ref_profiles.profile_to_json(
                ref_profiles.fit(pre, dec, base_ref)))


def test_fit_recovers_ground_truth():
    _, _, _, port = _fits("noiseless")
    assert port.prefill_fit.r2 == pytest.approx(1.0, abs=1e-9)
    assert port.profile.grad1 == pytest.approx(GROUND_TRUTH["grad1"],
                                               rel=1e-6)
    assert port.profile.t_prefill_base == pytest.approx(
        GROUND_TRUTH["t_prefill_base"], rel=1e-6)
    with pytest.raises(ValueError, match=">= 2 samples"):
        pt_cal.linear_fit([(1.0, 1.0)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_artifacts_load_across_packages(case, tmp_path):
    _, _, ref, port = _fits(case)
    port_path, ref_path = tmp_path / "port.json", tmp_path / "ref.json"
    port.save(str(port_path))
    ref.save(str(ref_path))
    assert json.loads(port_path.read_text()) == json.loads(
        ref_path.read_text())
    assert (dataclasses.asdict(ref_cal.load_profile(str(port_path)))
            == dataclasses.asdict(port.profile))
    assert (dataclasses.asdict(pt_cal.load_profile(str(ref_path)))
            == dataclasses.asdict(ref.profile))
    back = pt_cal.CalibrationResult.from_json(
        json.loads(ref_path.read_text()))
    assert back.to_json() == ref.to_json()
    assert back.decode_fit == port.decode_fit
    # a bare profile dict loads too
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps(pt_profiles.profile_to_json(port.profile)))
    assert pt_cal.load_profile(str(bare)) == port.profile


TINY = pt_cal.CalibrationConfig(prompt_grid=(8, 16, 24),
                                decode_grid=((1, 8), (2, 8), (2, 16)),
                                decode_steps_per_call=2, repeats=2,
                                warmup=1, prefill_cache_len=16)


@pytest.fixture(scope="module")
def reduced_qwen3():
    cfg = get_config("qwen3-0.6b").reduced()
    return cfg, pt_params.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")


def test_sweeps_cover_the_grid(reduced_qwen3):
    """Only the grid and positive times: fit quality on a shared CPU is
    noise."""
    cfg, params = reduced_qwen3
    pre = pt_cal.sweep_prefill(cfg, params, TINY)
    dec = pt_cal.sweep_decode(cfg, params, TINY)
    assert [x for x, _ in pre] == [8.0, 16.0, 24.0]
    assert [x for x, _ in dec] == [8.0, 16.0, 32.0]
    assert all(t > 0 for _, t in pre + dec)
    res = pt_cal.calibrate(cfg, params, TINY)
    assert res.profile.name == f"{cfg.name}-calibrated"
    assert res.prefill_fit.n == res.decode_fit.n == 3
    assert pt_cal.calibrate_profile(cfg, params, TINY,
                                    name="x").name == "x"


def _stub_sweeps(monkeypatch, module, threads=None):
    pre, dec = _stub_engine_samples(GROUND_TRUTH, noise=0.01)

    def prefill(cfg, params, ccfg):
        if threads is not None:
            threads.append(torch.get_num_threads())
        return pre

    monkeypatch.setattr(module, "sweep_prefill", prefill)
    monkeypatch.setattr(module, "sweep_decode", lambda *a: dec)
    return pre, dec


def _ref_cli(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(SystemExit) as exc:
        ref_serve.main()
    return exc.value.code, capsys.readouterr().out


def _port_cli(capsys, argv):
    with pytest.raises(SystemExit) as exc:
        pt_serve.main(argv + ["--device", "cpu"])
    return exc.value.code, capsys.readouterr().out


def test_calibrate_cli_equals_the_reference(monkeypatch, capsys, tmp_path):
    threads = []
    _stub_sweeps(monkeypatch, ref_cal)
    pre, dec = _stub_sweeps(monkeypatch, pt_cal, threads)
    before = torch.get_num_threads()
    argv = ["--calibrate", "--arch", "qwen3-0.6b", "--profile-json"]
    code, out = _port_cli(capsys, argv + [str(tmp_path / "port.json")])
    ref_code, ref_out = _ref_cli(monkeypatch, capsys,
                                 argv + [str(tmp_path / "ref.json")])
    assert code == ref_code == 0
    assert threads == [1] and torch.get_num_threads() == before
    assert out.replace("port.json", "x") == ref_out.replace("ref.json", "x")
    name = REF_REGISTRY["qwen3-0.6b"].reduced().name
    expected = ref_cal.fit_calibration(pre, dec, name=f"{name}-calibrated")
    assert ref_cal.format_result(expected) in out
    assert (json.loads((tmp_path / "port.json").read_text())
            == expected.to_json())
    assert "CALIBRATION GATE" not in out


def test_calibrate_cli_gate_exits_as_the_reference(monkeypatch, capsys):
    _stub_sweeps(monkeypatch, ref_cal)
    _stub_sweeps(monkeypatch, pt_cal)
    argv = ["--calibrate", "--arch", "qwen3-0.6b", "--min-r2", "1.01"]
    code, out = _port_cli(capsys, argv)
    ref_code, ref_out = _ref_cli(monkeypatch, capsys, argv)
    assert code == ref_code == 1
    assert out == ref_out
    gate = [ln for ln in out.splitlines() if ln.startswith("CALIBRATION GATE")]
    assert len(gate) == 2 and "prefill R^2" in gate[0]


def test_calibrate_cli_ignores_profile_json_as_input(tmp_path):
    """Under --calibrate, --profile-json names the output; other modes
    read it as the serving profile."""
    args = pt_serve.build_parser().parse_args(
        ["--calibrate", "--profile-json", str(tmp_path / "missing.json")])
    assert pt_serve._base_profile(args) is pt_profiles.V100_LLAMA2_7B
    path = tmp_path / "p.json"
    prof = dataclasses.replace(pt_profiles.V100_LLAMA2_7B, name="loaded")
    path.write_text(json.dumps(pt_profiles.profile_to_json(prof)))
    args = pt_serve.build_parser().parse_args(
        ["--mode", "gateway", "--profile-json", str(path)])
    assert pt_serve._base_profile(args) == prof
