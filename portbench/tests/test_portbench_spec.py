"""Every cell's files parse and agree with BENCHMARK.json; a cell, a mix
and a metric added as new files are found by name alone."""
import json
import shutil

import _tiny  # noqa: F401  (puts src and portbench on sys.path)
import pytest

from pbench import spec

BENCH = spec.load_json(spec.REPO / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_parse(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert cell.cell["rate"] > 0 and cell.cell["backlog"] >= 0
    assert set(cell.cell["check"]) & {"logit_gap", "logit_gap_mean"}
    assert (cell.router_dir / "weights.json").exists()
    assert (cell.router_dir / "latest").exists()
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert (spec.ROOT / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in names


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert len(json.dumps(BENCH)) < 64 * 1024
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in BENCH["configs"]:
        assert (spec.REPO / c["file"]).exists()


def test_new_files_are_found(tmp_path):
    root = tmp_path / "portbench"
    for d in ("traffic", "metrics", "cells", "routers", "configs"):
        shutil.copytree(spec.ROOT / d, root / d)
    mix = spec.load_json(root / "traffic" / "table1.json")
    mix["name"] = "throwaway_mix"
    (root / "traffic" / "throwaway_mix.json").write_text(json.dumps(mix))
    src = "deepseek-moe-16b.chat_saturated"
    new = "deepseek-moe-16b.throwaway"
    shutil.copy(root / "cells" / f"{src}.json", root / "cells" / f"{new}.json")
    shutil.copytree(root / "routers" / src, root / "routers" / new)
    (root / "metrics" / "throwaway_metric.py").write_text(
        "def read(r):\n    return 42.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": new, "config": "deepseek-moe-16b",
                               "traffic": "throwaway_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "throwaway_metric", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "output_tok_s",
                               "workloads": [new]})
    cell = spec.load_cell(new, bench=bench, root=root)
    assert cell.mix["name"] == "throwaway_mix"
    assert cell.router_dir == root / "routers" / new
    # a metric's readers run only in the cells it lists
    assert [m["name"] for m in cell.per_layer] == ["throwaway_metric"]
    from pbench import runner
    assert runner._reader(root, "throwaway_metric")(None) == 42.0
