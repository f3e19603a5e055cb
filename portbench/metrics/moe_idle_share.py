"""Share of the profiled slice's wall during which the card is idle
while any of the program's ``repro.moe.*`` spans is open (the MoE
layer's gate, dispatch, experts, combine, aux loss and shared experts;
see _spans)."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "_spans", Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(r):
    d = _mod.read(r)
    if d is None or not any(k.startswith("repro.moe.") for k in d["spans"]):
        return None
    return 100.0 * d["idle_under"]("repro.moe.") / ((d["hi"] - d["lo"])
                                                     * 1e-9)
