"""The port stands alone: it imports neither JAX nor the reference
package (nor ``msgpack``, ``zstandard`` or ``flax``, which the card's
machine does not have), and its entry points refuse to run on the CPU
unless asked."""
import os
import pathlib
import re
import subprocess
import sys
import textwrap
import warnings

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _port_modules():
    return sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_port_imports_no_jax_and_no_reference():
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {_port_modules()!r}:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax")
                     or m == "repro" or m.startswith("repro.")
                     or m.split(".")[0] in ("msgpack", "zstandard",
                                            "flax"))
        assert not bad, bad
        print(len({_port_modules()!r}))
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(_port_modules()) > 20
    assert {"repro_torch.core.calibrate", "repro_torch.serving.fidelity",
            "repro_torch.models.moe",
            "repro_torch.models.mla", "repro_torch.training.optimizer",
            "repro_torch.training.data", "repro_torch.launch.steps",
            "repro_torch.launch.train", "repro_torch.launch.dryrun",
            "repro_torch.kernels.meta"} <= set(_port_modules())


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu")]
    + [REPO / "chip_smoke.py"]), ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_never_name_jax_or_reference(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert not re.search(r"^\s*(import|from)\s+(msgpack|zstandard|flax)\b",
                         text, re.M)
    assert not re.search(r"^\s*(import\s+repro\b(?!_)|from\s+repro[\s.])",
                         text, re.M)


def _cpu_only():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")


def test_entry_points_default_to_the_card():
    _cpu_only()
    from repro_torch.configs import get_config
    from repro_torch.core.profiles import V100_LLAMA2_7B
    from repro_torch.launch import serve
    from repro_torch.models import params
    from repro_torch.serving.engine import LLMInstance
    from repro_torch.serving.scheduler import get_scheduler
    cfg = get_config("qwen3-0.6b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params.init_params(cfg, torch.Generator())
    p = params.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMInstance(cfg, p, V100_LLAMA2_7B, get_scheduler("fcfs"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--mode", "engine", "--requests", "1",
                    "--instances", "1", "--arch", "qwen3-0.6b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--mode", "gateway", "--backend", "engine",
                    "--requests", "1", "--instances", "1",
                    "--arch", "qwen3-0.6b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--calibrate", "--arch", "qwen3-0.6b"])
    from repro_torch.launch import train
    from repro_torch.training.train_loop import init_train_state
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen3-0.6b", "--reduced", "--steps", "1"])
    for argv in (["--mode", "sim"], ["--mode", "gateway"],
                 ["--mode", "gateway", "--backend", "py", "--policy", "rl"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(argv + ["--requests", "4", "--train-episodes", "1"])


def test_serve_cli_refuses_unported_modes(monkeypatch, capsys):
    from repro_torch.core import calibrate as cal
    from repro_torch.launch import serve
    # the device-resident simulator is ported: its modes serve
    for argv in (["--mode", "gateway", "--backend", "jax"],
                 ["--mode", "gateway", "--backend", "jax", "--online"],
                 ["--mode", "gateway", "--sim-backend", "jax"]):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            serve.main(argv + ["--device", "cpu", "--requests", "12"])
        assert "served n=12" in capsys.readouterr().out
    # calibration is ported: it runs (on stub sweeps here) and exits 0
    monkeypatch.setattr(cal, "sweep_prefill",
                        lambda *a: [(32.0, 0.01), (64.0, 0.02)])
    monkeypatch.setattr(cal, "sweep_decode",
                        lambda *a: [(64.0, 0.011), (128.0, 0.012)])
    with pytest.raises(SystemExit) as exc:
        serve.main(["--calibrate", "--device", "cpu"])
    assert exc.value.code == 0
    assert "sanity (grad1 > grad2 > 0): OK" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="simulator backend"):
        serve.main(["--mode", "gateway", "--backend", "engine", "--online",
                    "--device", "cpu"])


@pytest.mark.parametrize("flag", [
    ["--pattern", "poisson"], ["--sim-backend", "py"], ["--sessions"],
    ["--drift"], ["--train-episodes", "2"]])
def test_serve_cli_rejects_simulator_only_flags(flag):
    """Flags that only the simulator-backed modes read are refused over
    engines, so none is silently ignored."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="only over the simulator"):
        serve.main(["--mode", "gateway", "--backend", "engine",
                    "--device", "cpu"] + flag)


@pytest.mark.parametrize("flag", [
    ["--guardrail", "0.1"], ["--online-eps", "0.1"],
    ["--save-learner", "d"], ["--min-r2", "0.5"]])
def test_serve_cli_rejects_online_and_calibration_flags(flag):
    """Flags that only online learning reads are refused without
    ``--online``, and the flag only calibration reads is refused without
    ``--calibrate``, so none is silently ignored."""
    from repro_torch.launch import serve
    mode = "--calibrate" if flag[0] == "--min-r2" else "--online"
    with pytest.raises(SystemExit, match=f"only with {mode}"):
        serve.main(["--mode", "gateway", "--device", "cpu"] + flag)


def test_chip_smoke_fails_without_the_card(tmp_path):
    _cpu_only()
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
