"""Host reads per engine step in the profiled slice that the program's
``repro.sync.*`` spans enclose: each device-to-host copy launched inside
one (see _spans).  Equal to ``syncs_per_step`` when every copy is
wrapped; a site may enclose more than one copy (``torch.bincount`` reads
its input's min and max)."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "_spans", Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(r):
    d = _mod.read(r)
    if d is None or not d["sync_sites"] or not r.trace["steps"]:
        return None
    return d["d2h_in_sync"] / r.trace["steps"]
