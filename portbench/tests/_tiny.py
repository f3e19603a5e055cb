"""A tiny copy of a cell for the CPU tests: the program's ``reduced()``
model of the cell's configuration, the cell's own traffic, router and
metric readers, written under a temporary directory."""
import json
import shutil
import sys
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
REPO = PB.parent
for p in (REPO / "src", PB):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


#: cells whose files are kept under portbench/ for a later PR, but that
#: BENCHMARK.json does not list (their end-to-end numbers did not reproduce
#: between machines: PERF.md, Open questions); the tests still run them
HELD = [{"name": "deepseek-moe-16b.chat_saturated",
         "config": "deepseek-moe-16b", "traffic": "table1", "chips": 1,
         "why": "Table 1 sizes at 5x the knee: 16-row decode"},
        {"name": "falcon-mamba-7b.chat_burst", "config": "falcon-mamba-7b",
         "traffic": "table1_bursty", "chips": 1,
         "why": "Table 1 chat in bursts of 6x at 0.8 of the knee"}]


def model_dict(cfg):
    """The reference's view of a program ModelConfig."""
    keep = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
            "vocab_size", "norm_eps", "rope_theta", "dtype",
            "dense_first_layer", "dense_first_d_ff", "tie_embeddings")
    out = {k: getattr(cfg, k) for k in keep}
    if cfg.moe is not None:
        out["moe"] = {k: getattr(cfg.moe, k) for k in
                      ("n_experts", "top_k", "d_expert", "n_shared")}
    if cfg.mamba is not None:
        out["mamba"] = {"d_inner": cfg.mamba.d_inner,
                        "d_state": cfg.mamba.d_state,
                        "d_conv": cfg.mamba.d_conv,
                        "dt_rank": cfg.dt_rank}
    return out


def tiny_cell(tmp: Path, cell_name: str, dtype="float32", slots=4,
              tiny=None, **cell_over):
    from pbench import spec
    bench = spec.load_json(REPO / "BENCHMARK.json")
    bench = dict(bench, workloads=bench["workloads"] + HELD)
    w = next(x for x in bench["workloads"] if x["name"] == cell_name)
    centry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = spec.load_json(REPO / centry["file"])
    tiny = dict(tiny or {}, dtype=dtype)
    config["tiny"] = tiny
    from pbench import program
    cfg = program.model_config(dict(config, model={}))
    config["model"] = model_dict(cfg)
    cache_len = config["engine"]["cache_len"]
    config["engine"] = {"instances": 2, "slots": slots,
                        "cache_len": cache_len}
    config["profile"] = dict(config["profile"],
                             capacity_tokens=slots * cache_len,
                             max_batch=slots)
    root = tmp / "portbench"
    for d in ("traffic", "metrics", "routers"):
        shutil.copytree(PB / d, root / d)
    (root / "configs").mkdir(parents=True)
    (root / "cells").mkdir()
    cfile = root / "configs" / f"{config['name']}.json"
    cfile.write_text(json.dumps(config))
    cell = spec.load_json(PB / "cells" / f"{cell_name}.json")
    cell.update(cell_over)
    (root / "cells" / f"{cell_name}.json").write_text(json.dumps(cell))
    bench = dict(bench, configs=[dict(centry, file=str(cfile))])
    return spec.load_cell(cell_name, bench=bench, root=root, repo=tmp)

