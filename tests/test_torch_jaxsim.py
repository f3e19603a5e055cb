"""The port's device-resident simulator (``core/jaxsim.py`` and the round
loop of ``kernels/sim_rounds``) against the JAX package's, on the CPU.

The reference runs in a subprocess (``_torch_jaxsim_oracle.py rounds``,
one a module): the four seeded heuristic cases of ``tests/test_jaxsim.py``
through its ``JaxSimPool(1, min_span_ticks=0)``, and staged ``(ro,
carry)`` pairs of its jitted ``_run_kernel`` with their outputs, from
those cases and from span-mode calls of the batched trainer.  Here:

* the round loop's plain version, and the same through the packed blocks
  of ``sim_rounds``, on every captured pair: every int field equal, the
  clock and every per-request time bit-equal, the backlog sums, the span
  buckets and ``lane_ivv`` within 1e-9 of their scale (the reference's
  own tolerance for a summation order, ``jaxsim.py:28-34``);
* the port's pool on the CPU request by request against the port's
  ``py`` and ``vec`` and the reference's pool."""
import numpy as np
import pytest
import torch
from _torch_jaxsim_support import (CASES, assert_stamps_equal, load_json,
                                   reqs, run_oracle, stamps)

from repro_torch.core import vecsim
from repro_torch.core.jaxsim import JaxSimPool
from repro_torch.core.policies import make_policy
from repro_torch.core.profiles import V100_LLAMA2_7B as PROF
from repro_torch.core.simulator import Cluster, run_heuristic
from repro_torch.core.vecsim import VecCluster
from repro_torch.kernels.sim_rounds import ops as sim_ops

# 3 calls from each of the four cases, 3 span-mode calls of the trainer
N_CAPTURES = 15
# carry fields compared within a summation order's tolerance; every other
# field bit for bit
REWARD_FIELDS = ("bk_s", "bk_t", "d_lane", "lane_ivv")


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = run_oracle(tmp_path_factory, "rounds")
    meta = load_json(out / "cases.json")
    with np.load(out / "captures.npz") as z:
        arrays = dict(z)
    caps = []
    for i in range(len(meta["captures"])):
        caps.append({part: {k.split("/", 2)[2]: v
                            for k, v in arrays.items()
                            if k.startswith(f"{i}/{part}/")}
                     for part in ("ro", "carry", "out")})
    assert len(caps) == N_CAPTURES
    return meta, caps


def _assert_carry_equal(got, want):
    assert set(want) <= set(got) | {"fp_zero"}, set(want) - set(got)
    for name, w in want.items():
        g = np.asarray(got[name])
        if name in REWARD_FIELDS:
            scale = max(float(np.abs(w).max()), 1e-300)
            np.testing.assert_allclose(g, w, rtol=1e-9,
                                       atol=1e-9 * scale, err_msg=name)
        elif w.dtype == bool:
            assert np.array_equal(g.astype(bool), w), name
        else:
            # NaN (not yet stamped) compares equal to NaN
            np.testing.assert_array_equal(g, w, err_msg=name)


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()
            if k != "fp_zero"}


def test_codes_are_the_pools():
    assert (sim_ops.SS_EMPTY, sim_ops.SS_PREFILL, sim_ops.SS_DECODE) == (
        vecsim.SS_EMPTY, vecsim.SS_PREFILL, vecsim.SS_DECODE)
    assert (sim_ops.PH_PREFILL, sim_ops.PH_PREEMPTED, sim_ops.PH_DONE) == (
        vecsim.PH_PREFILL, vecsim.PH_PREEMPTED, vecsim.PH_DONE)
    assert (sim_ops.SCHED_FCFS, sim_ops.SCHED_BIN) == (
        vecsim.SCHED_FCFS, vecsim.SCHED_BIN)
    assert sim_ops.BIG == vecsim._BIG


@pytest.mark.parametrize("i", range(N_CAPTURES))
def test_plain_rounds_equal_the_reference_kernel(oracle, i):
    cap = oracle[1][i]
    out = sim_ops.rounds_plain(_torch(cap["ro"]), _torch(cap["carry"]))
    _assert_carry_equal({k: v.numpy() for k, v in out.items()},
                        cap["out"])
    assert int(out["round_no"]) > 0


@pytest.mark.parametrize("i", range(N_CAPTURES))
def test_packed_rounds_equal_the_reference_kernel(oracle, i):
    """The blocks a call stages (``Layout.pack``) through ``sim_rounds``
    on CPU tensors: what the pool runs, with the reference's full
    257-column span buckets."""
    ro, carry, want = (oracle[1][i][p] for p in ("ro", "carry", "out"))
    L, S = carry["res_gid"].shape
    layout = sim_ops.Layout(L, S, carry["q"].shape[1],
                            ro["prompt"].shape[0], carry["bk_t"].shape[0],
                            carry["d_lane"].shape[1])
    fb = torch.full((layout.n_f,), np.nan, dtype=torch.float64)
    ib = torch.full((layout.n_i,), -7, dtype=torch.int64)
    layout.pack(ro, {k: v for k, v in carry.items() if k != "d_lane"},
                fb.numpy(), ib.numpy())
    sim_ops.sim_rounds(layout, fb, ib)
    _assert_carry_equal(layout.carry_out(fb, ib), want)
    assert sim_ops.launches == 0        # the plain version never counts


def test_sim_rounds_checks_its_blocks():
    layout = sim_ops.Layout(2, 8, 16, 64, 1, 1)
    fb = torch.zeros(layout.n_f, dtype=torch.float64)
    ib = torch.zeros(layout.n_i, dtype=torch.int64)
    with pytest.raises(ValueError, match="elements"):
        sim_ops.sim_rounds(layout, fb[:-1], ib)
    with pytest.raises(ValueError, match="float64 and int64"):
        sim_ops.sim_rounds(layout, fb.float(), ib)
    with pytest.raises(ValueError, match="no kernel"):
        sim_ops.sim_rounds(layout, fb.to("meta"), ib.to("meta"))


@pytest.mark.parametrize("chunk,sched", CASES)
def test_pool_matches_py_vec_and_the_reference(oracle, chunk, sched):
    case = next(c for c in oracle[0]["cases"]
                if (c["chunk"], c["sched"]) == (chunk, sched))
    out = {}
    for name, make in (
            ("py", lambda: Cluster(PROF, 3, scheduler=sched,
                                   chunked_prefill=chunk)),
            ("vec", lambda: Cluster(PROF, 3, scheduler=sched,
                                    chunked_prefill=chunk, backend="vec")),
            ("jax", lambda: VecCluster(
                PROF, 3, pool=JaxSimPool(1, min_span_ticks=0,
                                         device="cpu"),
                scheduler=sched, chunked_prefill=chunk))):
        rs = reqs(100, seed=5)
        cluster = make()
        out[name] = (run_heuristic(cluster, rs,
                                   make_policy("round_robin", PROF)),
                     stamps(rs), cluster)
    stats, got, cluster = out["jax"]
    assert cluster.pool.n_jax_calls == case["n_jax_calls"] > 0
    assert cluster.pool.n_numpy_calls == 0
    assert_stamps_equal(got, case["stamps"])
    assert_stamps_equal(got, out["vec"][1])
    assert_stamps_equal(got, out["py"][1], exact_tbt=False)
    for key in ("e2e_mean", "ttft_mean", "spikes"):
        assert stats[key] == case[key] == out["py"][0][key], key
