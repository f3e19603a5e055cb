"""Median wall of the program's ``repro.route`` span in the profiled
slice: the rl policy's decision (its inputs, the Q-network and the
masked argmax with the Q read), timed inside the program (see _spans)."""
import importlib.util
import statistics
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "_spans", Path(__file__).with_name("_spans.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(r):
    d = _mod.read(r)
    if not _mod.has(d, "repro.route"):
        return None
    return statistics.median(d["spans"]["repro.route"]["walls"]) * 1e3
