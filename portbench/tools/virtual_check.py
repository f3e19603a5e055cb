"""Confirm on the card that the engines' virtual stamps equal the
program's ``py`` simulator's for the same stream (the premise of the CPU
knee sweep): a cell's engines, router and profile serve ``--requests``
requests of its mix to completion, then the ``py`` simulator serves a
copy of the same stream under the same router; per request, the first
token's and the completion's virtual times are compared.

  python3 portbench/tools/virtual_check.py deepseek-moe-16b.chat_saturated \
      --requests 16 --seed 7
"""
import argparse
import copy
import sys

import _path  # noqa: F401
import torch

from pbench import program, serve, spec, traffic
from pbench import weights as wts


def stamps(reqs):
    return {r.rid: (r.first_token, r.finished) for r in reqs}


def main(argv=None, device=None, cell=None):
    from repro_torch.serving.gateway import (Gateway, GatewayConfig,
                                             simulator_cluster)
    from repro_torch.serving.policies import restore_rl_policy
    ap = argparse.ArgumentParser()
    ap.add_argument("cell")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--seed", type=int, default=7)
    a = ap.parse_args(argv)
    cell = cell or spec.load_cell(a.cell)
    device = device or torch.device("cuda", 0)
    cfg = program.model_config(cell.config)
    params = wts.make(cell.config, a.seed, device)
    gw, adapter, engines, policy = serve.build(
        cfg, params, cell.config, str(cell.router_dir), device)
    items = traffic.stream(cell.mix, a.requests, cell.cell["rate"], 0,
                           a.seed, cell.config["model"]["vocab_size"])
    reqs = program.requests(items)
    twins = copy.deepcopy(reqs)
    gw.run(reqs)
    m = cell.config["engine"]["instances"]
    prof = program.profile(cell.config)
    gcfg = GatewayConfig(backend="py")
    sim = Gateway(gcfg, (prof,) * m,
                  restore_rl_policy(program.router_cfg(m),
                                    str(cell.router_dir), m=m,
                                    device=device),
                  cluster=simulator_cluster(gcfg, (prof,) * m,
                                            device=device))
    sim.run(twins)
    e, s = stamps(reqs), stamps(twins)
    worst = max(abs(e[k][i] - s[k][i]) for k in e for i in (0, 1))
    print(f"{cell.name}: {len(e)} requests served to completion on "
          f"{device}; the widest |engine - py| virtual stamp "
          f"(first token, completion): {worst!r} s")
    return worst


if __name__ == "__main__":
    sys.exit(0 if main() == 0.0 else 1)
