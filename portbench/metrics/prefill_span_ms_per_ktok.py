"""Wall of the program's ``repro.engine.prefill`` spans in the profiled
slice (each admission's prefill up to and including its logits' host
read; the step's decode left out) per 1,000 prompt tokens that the
slice's steps admitted (see _spans)."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "_spans", Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(r):
    d = _mod.read(r)
    if not _mod.has(d, "repro.engine.prefill"):
        return None
    tokens = sum(s["prompt"] for s in r.slice_steps)
    if not tokens:
        return None
    return d["spans"]["repro.engine.prefill"]["wall_s"] / tokens * 1e6
