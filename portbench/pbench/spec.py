"""Find a cell's files by name.

``BENCHMARK.json`` at the root of the checkout names the cells; every
other thing a cell needs is a file of its own under ``portbench/``:

  configs/<config>.json      the model's published sizes, engines, profile
  traffic/<traffic>.json     the mix (``pbench.traffic``)
  cells/<cell>.json          rate, backlog, profiled slice, the limits of
                             the correctness check
  routers/<cell>/            the ``rl`` router's checkpoint (+ weights.json)
  metrics/<metric>.py        one reader a per-layer metric
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent


def load_json(path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    cell: Dict
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)
    root: Path = ROOT
    router_dir: Path = None

    def __post_init__(self):
        if self.router_dir is None:
            self.router_dir = self.root / "routers" / self.name


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Dict = None, root: Path = ROOT,
              repo: Path = REPO) -> Cell:
    """The cell ``name`` of ``bench`` (default: the checkout's
    BENCHMARK.json) with its files read from ``root``."""
    bench = bench or load_json(Path(repo) / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    w = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    centry = cfgs[w["config"]]
    config = load_json(Path(repo) / centry["file"])
    root = Path(root)
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        mix=load_json(root / "traffic" / f"{w['traffic']}.json"),
        cell=load_json(root / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        root=root)
