"""Share of the profiled slice's wall in the self time of the program's
``repro.gateway.*`` spans (admission and the tick's routing, less the
routing policy's own span; see _spans)."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "_spans", Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(r):
    d = _mod.read(r)
    if d is None:
        return None
    own = [v["self_s"] for k, v in d["spans"].items()
           if k.startswith("repro.gateway.")]
    if not own:
        return None
    return 100.0 * sum(own) / ((d["hi"] - d["lo"]) * 1e-9)
