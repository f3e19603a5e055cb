"""Shared by ``tests/test_torch_jaxsim*.py``: the reference oracle's
subprocess, the seeded streams and the per-request stamps.

The oracle (``tests/_torch_jaxsim_oracle.py``) runs the JAX package's
``core.jaxsim`` in a process of its own, with the one shim it needs set
there; nothing here imports it or JAX."""
import json
import os
import subprocess
import sys

import numpy as np

from repro_torch.core import workload as wl
from repro_torch.core.policies import make_policy
from repro_torch.core.profiles import V100_LLAMA2_7B as PROF
from repro_torch.core import vecsim

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the four (chunked_prefill, scheduler) cases of tests/test_jaxsim.py
CASES = ((0, "fcfs"), (64, "fcfs"), (0, "bin_packing"),
         (128, "least_work_left"))


def run_oracle(tmp_path_factory, part: str):
    """Run one part of the oracle into a fresh directory; returns it."""
    out = tmp_path_factory.mktemp(f"jaxsim_oracle_{part}")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    subprocess.run([sys.executable,
                    os.path.join(HERE, "_torch_jaxsim_oracle.py"),
                    str(out), part], env=env, cwd=ROOT, check=True,
                   timeout=900)
    return out


def load_json(path):
    with open(path) as f:
        return json.load(f)


def reqs(n, seed, rate=20.0):
    return wl.to_requests(wl.generate(n, seed=seed), rate=rate,
                          seed=seed + 1)


def stamps(rs):
    """Every request field a stepper writes, as the oracle records them;
    ``tbt`` last (it telescopes synthesized times, so against ``py`` it
    is held to rel 1e-12, as tests/test_vecsim.py holds it)."""
    return [[r.finished, r.first_token, r.prefill_done, r.routed_at,
             r.instance, r.preemptions, r.decoded, r.prefilled,
             r.phase.name, len(r.token_times), r.tbt] for r in rs]


def assert_stamps_equal(got, want, exact_tbt=True):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a[:-1] == b[:-1], (a, b)
        if exact_tbt or a[-1] is None or b[-1] is None:
            assert a[-1] == b[-1]
        else:
            assert np.isclose(a[-1], b[-1], rtol=1e-12, atol=0.0)


def drive_pooled(pool, all_reqs, m=2, span_cap=256):
    """benchmarks/bench_jaxsim.py's drive (``vecsim.drive_pooled``) with
    jsq routing over ``m`` instances of the V100 profile."""
    vecsim.drive_pooled(pool, all_reqs, make_policy("jsq", PROF), PROF, m,
                        span_cap=span_cap)
