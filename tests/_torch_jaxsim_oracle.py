"""The JAX package's device-resident simulator as an oracle, run in a
process of its own.

    python tests/_torch_jaxsim_oracle.py OUT_DIR rounds|featurize

``repro.core.jaxsim`` and ``repro.core.state.featurize_jax_many`` import
``enable_x64`` from ``jax.experimental``, which jax 0.9 dropped; this
process sets ``jax.experimental.enable_x64 = jax.enable_x64`` before the
import, and nothing else.  The shim stays in this process: the pytest
process that starts it (``tests/test_torch_jaxsim*.py``) never sets it,
so the JAX package's own tests see the tree as it is.

``rounds``: the four seeded heuristic cases of ``tests/test_jaxsim.py``
through the reference's ``JaxSimPool(1, min_span_ticks=0)`` (per-request
stamps and stats to ``cases.json``), and staged ``(ro, carry)`` pairs of
its ``_run_kernel`` with their outputs (``captures.npz``): from each case
the call with the most rounds, the most preemptions and the most
completions, and from the batched trainer over ``backend="jax"`` the
three span-mode calls with the largest span buckets.

``featurize``: the reference's ``featurize_jax_many`` at each decision
point of ``test_featurize_jax_many_bit_parity``'s episode pair, for its
four flag sets (``featurize.npz``).
"""
import json
import os
import sys

import jax
import jax.experimental

jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402

from repro.core import batched_rl, rl_router as rl  # noqa: E402
from repro.core import jaxsim  # noqa: E402
from repro.core import state as state_lib  # noqa: E402
from repro.core.policies import make_policy  # noqa: E402
from repro.core.profiles import V100_LLAMA2_7B as PROF  # noqa: E402
from repro.core.simulator import run_heuristic  # noqa: E402
from repro.core.vecsim import VecCluster  # noqa: E402
from repro.core.workload import Scenario, generate, to_requests  # noqa: E402

CASES = ((0, "fcfs"), (64, "fcfs"), (0, "bin_packing"),
         (128, "least_work_left"))
FLAGS = ({}, {"include_hardware": True},
         {"include_cache": True, "include_health": True},
         {"include_impact": False, "include_hardware": True})


def reqs(n, seed, rate=20.0):
    return to_requests(generate(n, seed=seed), rate=rate, seed=seed + 1)


def stamps(rs):
    return [[r.finished, r.first_token, r.prefill_done, r.routed_at,
             r.instance, r.preemptions, r.decoded, r.prefilled,
             r.phase.name, len(r.token_times), r.tbt] for r in rs]


class Recorder:
    """Wraps ``jaxsim._run_kernel``: every call's inputs and outputs as
    numpy arrays."""

    def __init__(self):
        self.calls = []
        self.inner = jaxsim._run_kernel

    def __call__(self, ro, carry):
        out = self.inner(ro, carry)
        self.calls.append(tuple(
            {k: np.array(v) for k, v in d.items()}
            for d in (ro, carry, out)))
        return out


def pick(calls, score, n):
    order = sorted(range(len(calls)), key=lambda i: -score(calls[i]))
    return [calls[i] for i in order[:n]]


def rounds(out_dir):
    cases, captures = [], []
    for chunk, sched in CASES:
        rec = Recorder()
        jaxsim._run_kernel = rec
        rs = reqs(100, seed=5)
        cluster = VecCluster(PROF, 3, pool=jaxsim.JaxSimPool(
            1, min_span_ticks=0), scheduler=sched, chunked_prefill=chunk)
        st = run_heuristic(cluster, rs, make_policy("round_robin", PROF))
        jaxsim._run_kernel = rec.inner
        cases.append({"chunk": chunk, "sched": sched, "stamps": stamps(rs),
                      "e2e_mean": st["e2e_mean"],
                      "ttft_mean": st["ttft_mean"], "spikes": st["spikes"],
                      "n_jax_calls": cluster.pool.n_jax_calls})
        for score in (lambda c: int(c[2]["round_no"]),
                      lambda c: int(c[2]["a_preempts"].sum()
                                    - c[1]["a_preempts"].sum()),
                      lambda c: int((c[2]["done_round"] >= 0).sum())):
            captures.append((f"{sched}-{chunk}", pick(rec.calls, score,
                                                       1)[0]))

    def scenario(ep):
        return Scenario.homogeneous(PROF, 3, reqs(40, seed=700 + ep))

    rec = Recorder()
    jaxsim._run_kernel = rec
    batched_rl.train_batched(
        rl.RouterConfig(variant="guided", n_instances=3,
                        explore_episodes=2, q_arch="decomposed", seed=0),
        scenario, 3, bcfg=batched_rl.BatchedRLConfig(n_envs=3, m_max=3,
                                                     backend="jax"))
    jaxsim._run_kernel = rec.inner
    for call in pick(rec.calls, lambda c: float(np.abs(c[2]["d_lane"])
                                                 .sum()), 3):
        captures.append(("span", call))
    arrays = {}
    for i, (_, (ro, carry, out)) in enumerate(captures):
        for part, d in (("ro", ro), ("carry", carry), ("out", out)):
            for k, v in d.items():
                arrays[f"{i}/{part}/{k}"] = v
    np.savez(os.path.join(out_dir, "captures.npz"), **arrays)
    with open(os.path.join(out_dir, "cases.json"), "w") as f:
        json.dump({"cases": cases, "captures": [t for t, _ in captures]},
                  f)


def featurize(out_dir):
    arrays = {}
    for fi, flags in enumerate(FLAGS):
        pool = jaxsim.JaxSimPool(2, min_span_ticks=0)
        cfg = rl.RouterConfig(variant="guided", n_instances=3, seed=0)
        envs = [rl.RoutingEnv(cfg, PROF, pool=pool, pool_ep=i)
                for i in range(2)]
        for i, env in enumerate(envs):
            env.reset(reqs(30, seed=40 + i))
        for step in range(25):
            for env in envs:
                a = (int(np.argmax(env.guidance_bonus()[:env.cluster.m]))
                     if env.cluster.central else env.cluster.m)
                env.step(a)
            dev = state_lib.featurize_jax_many(
                [e.cluster for e in envs], [e.profile for e in envs],
                [e.predict_decode for e in envs], n_buckets=cfg.n_buckets,
                alpha=cfg.alpha, **flags)
            arrays[f"{fi}/{step}"] = np.stack(dev)
    np.savez(os.path.join(out_dir, "featurize.npz"), **arrays)


if __name__ == "__main__":
    {"rounds": rounds, "featurize": featurize}[sys.argv[2]](sys.argv[1])
