"""The port stands alone: it imports neither JAX nor the reference
package, and its entry points refuse to run on the CPU unless asked."""
import os
import pathlib
import re
import subprocess
import sys
import textwrap

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
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print(len({_port_modules()!r}))
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(_port_modules()) > 20


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu")]
    + [REPO / "chip_smoke.py"]), ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_never_name_jax_or_reference(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
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


def test_serve_cli_refuses_unported_modes():
    from repro_torch.launch import serve
    for mode in ("sim", "gateway"):
        with pytest.raises(SystemExit, match="later slice"):
            serve.main(["--mode", mode, "--device", "cpu"])


def test_chip_smoke_fails_without_the_card(tmp_path):
    _cpu_only()
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
