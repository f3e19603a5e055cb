"""The kernels' work on the ``meta`` device, for the dry-run.

Each kernel module has a plain function ``cost(...)`` of its shapes and
dtypes giving the work of the FUNCTION the kernel computes (not of its
implementation): the FLOPs it must do, the bytes it must move (each input
read once, each output written once) and, for the scan's backward, the
exponentials it needs on the special-function units.  ``chip_smoke.py``
divides these by the card's rates for its Bound column, and the dry-run
adds them to its per-device counts.

Given meta tensors, each wrapper returns empty meta tensors of its plain
version's shapes and dtypes and adds its kernel's cost here (the plain
versions are not run on meta: a count needs no values, and the scan's
Python loop over S would take minutes at S = 32768).  The dry-run reads
:data:`tally` and resets it around each step it traces.
"""
from __future__ import annotations

from typing import Dict, NamedTuple


class KernelCost(NamedTuple):
    flops: float
    bytes: float
    #: special-function operations (exponentials), where they bound the
    #: function rather than its FLOPs
    exps: float = 0.0


#: {kernel name: [calls, flops, bytes]} since the last reset
tally: Dict[str, list] = {}


def record(name: str, cost: KernelCost) -> None:
    entry = tally.setdefault(name, [0, 0.0, 0.0])
    entry[0] += 1
    entry[1] += cost.flops
    entry[2] += cost.bytes


def reset() -> None:
    tally.clear()


def causal_pairs(sq: int, skv: int, q_offset: int = 0) -> int:
    """The (query, key) pairs causal attention computes: query row i sits
    at position i + q_offset and sees keys j <= i + q_offset, j < skv."""
    full = max(0, min(sq, skv - q_offset))        # rows not clipped at skv
    return (full * (q_offset + 1) + full * (full - 1) // 2
            + (sq - full) * skv)


def is_meta(t) -> bool:
    return t.device.type == "meta"
