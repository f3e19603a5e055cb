"""Train a cell's ``rl`` router on the CPU and write it as the cell's
data: ``portbench/routers/<cell>/`` gets the program's checkpoint (what
``restore_rl_policy`` reads) and ``weights.json``, the same Q-network's
weights as plain lists for the harness's reference.

  python3 portbench/tools/train_router.py deepseek-moe-16b.chat_saturated \
      --rate 3.0 --episodes 8 --requests 400

The program's ``training/train_loop.py::train_router`` (batched, over
the ``vec`` simulator, bit-equal to ``py``) runs from seed 0 at the
cell's profile, slots and mix; episode ``ep`` serves the mix's stream of
seed ``ep`` at ``--rate`` virtual requests a second.
"""
import argparse
import json
import shutil

import _path  # noqa: F401
import torch

from pbench import program, spec, traffic


def main():
    from repro_torch.core import workload as wl
    from repro_torch.core.batched_rl import BatchedRLConfig
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.train_loop import train_router
    ap = argparse.ArgumentParser()
    ap.add_argument("cell")
    ap.add_argument("--rate", type=float, required=True)
    ap.add_argument("--episodes", type=int, default=8)
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--out", default=None,
                    help="write here instead of the cell's router directory")
    a = ap.parse_args()
    torch.manual_seed(0)
    cell = spec.load_cell(a.cell)
    cfg = cell.config
    m = cfg["engine"]["instances"]
    prof = program.profile(cfg)
    rcfg = program.router_cfg(m)

    def scenario(ep):
        items = traffic.stream(cell.mix, a.requests, a.rate, 0, ep, vocab=8)
        return wl.Scenario.homogeneous(prof, m, program.requests(items))
    out = train_router(rcfg, scenario, a.episodes,
                       batch_cfg=BatchedRLConfig(backend="vec", m_max=m),
                       device="cpu")
    agent = out["agent"]
    from pathlib import Path
    d = Path(a.out) if a.out else cell.router_dir
    shutil.rmtree(d, ignore_errors=True)
    mgr = CheckpointManager(str(d), keep=1)
    try:
        mgr.save(a.episodes, agent.state_dict(), sync=True)
    finally:
        mgr.close()
    net = agent.params
    tree = {name: p.detach().double().tolist()
            for name, p in net.named_parameters()}
    meta = {"q_arch": net.cfg.q_arch, "inst_dims": net.cfg.inst_dims,
            "router_dims": net.cfg.router_dims, "q_squash": rcfg.q_squash,
            "command": f"python3 portbench/tools/train_router.py {a.cell} "
                       f"--rate {a.rate} --episodes {a.episodes} "
                       f"--requests {a.requests}",
            "history_last": {k: float(v) for k, v in
                             out["history"][-1].items()
                             if isinstance(v, (int, float))}}
    with open(d / "weights.json", "w") as f:
        json.dump({"meta": meta, "params": tree}, f)
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
