"""The whole step's share of the card's bf16 peak (see _mfu)."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "_mfu", Path(__file__).with_name("_mfu.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(r):
    return _mod.mfu(r)
