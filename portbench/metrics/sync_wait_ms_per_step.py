"""The host's wait on the card per engine step in the profiled slice:
the summed walls of the program's ``repro.sync.*`` spans (see _spans)."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "_spans", Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(r):
    d = _mod.read(r)
    if d is None or not r.trace["steps"]:
        return None
    walls = [v["wall_s"] for k, v in d["spans"].items()
             if k.startswith(_mod.SYNC)]
    if not walls:
        return None
    return sum(walls) / r.trace["steps"] * 1e3
