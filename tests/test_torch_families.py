"""Every model family of ``repro.configs.REGISTRY`` through the port's
model, engine and launcher, against the JAX reference.

Whole models at reduced size (``_torch_model_support``): prefill + 4
decode steps with logits and every cache entry within 1e-4, for the
families this file owns -- gated cross-attention with vision inputs
(llama-3.2-vision-11b, its gates set non-zero) and embedding inputs
(musicgen-medium), each also with a ragged prompt whose decode runs past
the cache, and the GQA and Mamba-1 families ported earlier; the MoE
families are in ``test_torch_moe.py`` and MLA in ``test_torch_mla.py``,
with their engines in lockstep with the reference's.  Then the launcher
over reduced engines: ``--mode engine`` and ``--backend engine`` for
deepseek-moe-16b and minicpm3-4b against the reference's CLI, and
``--calibrate`` for those two and jamba-v0.1-52b (whose engines are held
to the reference's in ``test_torch_moe.py``'s lockstep)."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_model_support import configs, inputs, params_both, \
    run_model_both
from _torch_model_support import torch_one_thread  # noqa: F401
from repro.launch import serve as ref_serve
from repro.models import attention as ref_attn
from repro.models import model as ref_model
from repro_torch.core.profiles import V100_LLAMA2_7B as PT_V100
from repro_torch.launch import serve as pt_serve
from repro_torch.models import attention as pt_attn
from repro_torch.models import model as pt_model
from repro_torch.serving import engine as pt_engine
from repro_torch.serving import request as pt_request
from repro_torch.serving.scheduler import get_scheduler as pt_get_scheduler

TOL = 1e-4
NEW = ("llama-3.2-vision-11b", "musicgen-medium")
EARLIER = ("gemma-7b", "starcoder2-7b", "qwen3-0.6b", "falcon-mamba-7b",
           "llama-2-7b")


@pytest.mark.parametrize("prompt,cache_len", [(12, 32), (13, 14)])
@pytest.mark.parametrize("arch", NEW)
def test_vision_and_embedding_models_match_reference(arch, prompt,
                                                     cache_len):
    run_model_both(arch, prompt, cache_len)


@pytest.mark.parametrize("arch", EARLIER)
def test_earlier_families_match_reference(arch):
    run_model_both(arch, 12, 32)


def test_cross_attention_over_1024_rows_matches_both_branches():
    """Above 1024 query rows the reference runs ``gqa_blocked``, below it
    ``gqa_core``; the port's one f32 path agrees with both within 1e-4
    in f32."""
    cfg_ref, cfg_pt = configs("llama-3.2-vision-11b")
    pr, pt = params_both(cfg_ref)
    p_ref, p_pt = pr["layers"][4]["attn"], pt["layers"][4]["attn"]
    p_ref = {k: v[0] for k, v in p_ref.items()}
    p_pt = {k: v[0] for k, v in p_pt.items()}
    rng = np.random.default_rng(3)
    vis = rng.standard_normal((1, cfg_ref.vision_tokens,
                               cfg_ref.d_model)).astype(np.float32)
    for s in (37, 1536):
        x = rng.standard_normal((1, s, cfg_ref.d_model)).astype(np.float32)
        want = ref_attn.cross_attention(
            p_ref, cfg_ref, jnp.asarray(x),
            ref_attn.vision_kv(p_ref, cfg_ref, jnp.asarray(vis)))
        got = pt_attn.cross_attention(
            p_pt, cfg_pt, torch.as_tensor(x),
            pt_attn.vision_kv(p_pt, cfg_pt, torch.as_tensor(vis)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=f"S={s}")


def test_cross_layers_need_vision_inputs():
    """Like the reference, a prefill of a cross-attention model without
    vision inputs raises a ValueError, and so the engine, which passes
    none, refuses at its first admission."""
    cfg_ref, cfg_pt = configs("llama-3.2-vision-11b")
    pr, pt = params_both(cfg_ref)
    toks = inputs(cfg_ref, 1, 8)["tokens"]
    with pytest.raises(ValueError):
        ref_model.prefill(pr, cfg_ref, tokens=jnp.asarray(toks), cache_len=16)
    with pytest.raises(ValueError, match="vision"):
        pt_model.prefill(pt, cfg_pt, torch.as_tensor(toks), cache_len=16)
    inst = pt_engine.LLMInstance(cfg_pt, pt, PT_V100,
                                 pt_get_scheduler("fcfs"), n_slots=2,
                                 cache_len=16, device="cpu")
    inst.submit(pt_request.Request(prompt_tokens=8, decode_tokens=2))
    with pytest.raises(ValueError, match="vision"):
        inst.step()


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "minicpm3-4b"])
def test_serve_cli_over_engines_prints_the_reference_summary(
        arch, capsys, monkeypatch):
    """``serve --mode gateway --backend engine`` and ``--mode engine``
    over the reduced engines print the reference's output."""
    for mode in (["--mode", "gateway", "--backend", "engine"],
                 ["--mode", "engine"]):
        argv = mode + ["--requests", "4", "--instances", "2", "--arch",
                       arch]
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        ref_serve.main()
        want = capsys.readouterr().out
        with torch.no_grad():
            pt_serve.main(argv + ["--device", "cpu"])
        assert capsys.readouterr().out == want


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-moe-16b",
                                  "jamba-v0.1-52b"])
def test_calibrate_cli_sweeps_the_new_families(arch, monkeypatch, capsys):
    """``--calibrate`` sweeps the reduced engine's own prefill and decode
    (a short grid here: four prompts, three decode points, one repeat)
    and fits and prints a profile.  Its sanity ordering is left to the
    CPU's timing noise; the R^2 gate is off."""
    from repro_torch.core import calibrate as cal
    short = cal.CalibrationConfig(prompt_grid=(8, 16, 32, 64),
                                  decode_grid=((1, 16), (2, 32), (4, 64)),
                                  decode_steps_per_call=2, repeats=1,
                                  warmup=0, prefill_cache_len=64)
    monkeypatch.setattr(cal, "CalibrationConfig", lambda: short)
    with pytest.raises(SystemExit) as exc:
        pt_serve.main(["--calibrate", "--arch", arch, "--min-r2", "0",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"calibrated profile '{arch}-calibrated'" in out
    assert "n=4)" in out and "n=3)" in out
    assert "R^2" not in "".join(ln for ln in out.splitlines()
                                if ln.startswith("CALIBRATION GATE"))
    assert exc.value.code in (0, 1)
