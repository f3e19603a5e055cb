"""Find a cell's knee on the CPU: the program's gateway over its ``py``
simulator at the cell's profile, slots, mix and router, at a list of
virtual rates.  The engines run on the same virtual clock (the program's
``EngineClusterAdapter`` steps an engine while its clock is behind the
gateway's), so the schedule of engine steps, and with it the knee, is a
property of the virtual schedule and needs no card.

  python3 portbench/tools/knee.py falcon-mamba-7b.long_prompt \
      --rates 0.5 1 2 4 --requests 600 [--policy mixing]

For each rate: the requests served, the mean wait before the first token
in the second and last quarters of the stream (a backlog that grows shows
as a last quarter far above the second), and the mean number of resident
requests an engine (the occupancy the backlog of a cell stands for).
"""
import argparse

import _path  # noqa: F401
import numpy as np

from pbench import program, spec, traffic


def run(cell, rate, n, policy_name, seed=1):
    from repro_torch.serving.gateway import (Gateway, GatewayConfig,
                                             simulator_cluster)
    from repro_torch.serving.policies import (make_gateway_policy,
                                              restore_rl_policy)
    cfg = cell.config
    m = cfg["engine"]["instances"]
    prof = program.profile(cfg)
    items = traffic.stream(cell.mix, n, rate, 0, seed, vocab=8)
    reqs = program.requests(items)
    rcfg = program.router_cfg(m)
    if policy_name == "rl":
        policy = restore_rl_policy(rcfg, str(cell.router_dir), m=m,
                                   device="cpu")
    else:
        policy = make_gateway_policy(policy_name, rcfg)
    gcfg = GatewayConfig(backend="py")
    profiles = (prof,) * m
    gw = Gateway(gcfg, profiles, policy,
                 cluster=simulator_cluster(gcfg, profiles, device="cpu"))
    gw.run(reqs)
    done = [r for r in reqs if r.first_token is not None]
    waits = np.array([r.first_token - r.arrival for r in done])
    q = len(waits) // 4
    horizon = max(r.finished for r in done) - min(r.arrival for r in done)
    busy = sum(r.finished - r.prefill_done for r in done
               if r.finished is not None and r.prefill_done is not None)
    return {"rate": rate, "served": len(done),
            "wait_q2": float(waits[q:2 * q].mean()),
            "wait_q4": float(waits[3 * q:].mean()),
            "occupancy": busy / horizon / m,
            "virtual_s": horizon}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cell")
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=600)
    ap.add_argument("--policy", default="rl")
    ap.add_argument("--router", default=None,
                    help="a router directory other than the cell's")
    a = ap.parse_args()
    cell = spec.load_cell(a.cell)
    if a.router:
        cell.router_dir = a.router
    for r in a.rates:
        out = run(cell, r, a.requests, a.policy)
        print(" ".join(f"{k}={v:.4g}" if isinstance(v, float)
                       else f"{k}={v}" for k, v in out.items()),
              flush=True)


if __name__ == "__main__":
    main()
