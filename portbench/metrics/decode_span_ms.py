"""Median wall of the program's ``repro.engine.decode`` span in the
profiled slice: one gang decode pass up to and including its argmax's
host read (see _spans)."""
import importlib.util
import statistics
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "_spans", Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(r):
    d = _mod.read(r)
    if not _mod.has(d, "repro.engine.decode"):
        return None
    return statistics.median(d["spans"]["repro.engine.decode"]["walls"]) \
        * 1e3
