"""Wall of the admitting steps per 1,000 prompt tokens (see _prefill)."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "_prefill", Path(__file__).with_name("_prefill.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(r):
    return _mod.ms_per_ktok(r)
