"""The port's vectorized simulator (``core/vecsim.py``) against the JAX
package's, bit for bit, and against the port's own ``py`` stepper
wherever the reference's two steppers agree: heuristic routing on plain
streams, multi-turn session streams through the prefix-cache model,
instance failure and recovery, work stealing by the gateway's hedged
re-dispatch under chaos, multi-episode pools advanced by
``advance_span``, and the batched featurizer.  Streams are short (60-120
requests, 1-5 instances)."""
import types

import numpy as np
import pytest
from _hypothesis_support import given, settings, st

from repro.core import policies as ref_legacy
from repro.core import simulator as ref_sim
from repro.core import state as ref_state
from repro.core import vecsim as ref_vec
from repro.core import workload as ref_wl
from repro.core.profiles import A100_LLAMA31_8B as REF_A100
from repro.core.profiles import V100_LLAMA2_7B as REF_V100
from repro.serving import chaos as ref_chaos
from repro.serving import gateway as ref_gw
from repro.serving import policies as ref_pol
from repro_torch.core import policies as pt_legacy
from repro_torch.core import simulator as pt_sim
from repro_torch.core import state as pt_state
from repro_torch.core import vecsim as pt_vec
from repro_torch.core import workload as pt_wl
from repro_torch.core.profiles import A100_LLAMA31_8B as PT_A100
from repro_torch.core.profiles import V100_LLAMA2_7B as PT_V100
from repro_torch.serving import chaos as pt_chaos
from repro_torch.serving import gateway as pt_gw
from repro_torch.serving import policies as pt_pol

REF = types.SimpleNamespace(sim=ref_sim, vec=ref_vec, wl=ref_wl,
                            legacy=ref_legacy, state=ref_state,
                            gw=ref_gw, pol=ref_pol, chaos=ref_chaos,
                            v100=REF_V100, a100=REF_A100)
PT = types.SimpleNamespace(sim=pt_sim, vec=pt_vec, wl=pt_wl,
                           legacy=pt_legacy, state=pt_state,
                           gw=pt_gw, pol=pt_pol, chaos=pt_chaos,
                           v100=PT_V100, a100=PT_A100)


def _stamps(reqs, exact_times=True):
    """Every request field a stepper writes.  Against the ``py``
    stepper the per-token times are synthesized by ``vec`` (evenly
    spaced between the true first and last emission), so only their
    count is compared there."""
    out = []
    for r in reqs:
        row = (r.finished, r.first_token, r.prefill_done, r.routed_at,
               r.instance, r.preemptions, r.decoded, r.prefilled,
               r.phase.name, r.cached_prefix, r.retries, r.hedges,
               len(r.token_times))
        if exact_times:
            row += (tuple(r.token_times),)
        out.append(row)
    return out


def _reqs(ns, n, seed, rate=20.0):
    return ns.wl.to_requests(ns.wl.generate(n, seed=seed), rate=rate,
                             seed=seed + 1)


def _heuristic(ns, backend, policy, m, chunk, sched, seed, n=120,
               hetero=False):
    reqs = _reqs(ns, n, seed)
    prof = (ns.v100, ns.a100) if hetero else ns.v100
    cluster = ns.sim.Cluster(prof, m, scheduler=sched,
                             chunked_prefill=chunk, backend=backend)
    stats = ns.sim.run_heuristic(cluster, reqs,
                                 ns.legacy.make_policy(policy, ns.v100))
    return reqs, stats, cluster


@pytest.mark.parametrize("policy,m,chunk,sched,hetero", [
    ("round_robin", 3, 0, "fcfs", False),
    ("jsq", 4, 0, "fcfs", False),
    ("impact_greedy", 3, 0, "fcfs", False),
    ("min_min", 3, 0, "fcfs", False),
    ("round_robin", 2, 256, "fcfs", False),
    ("round_robin", 3, 0, "bin_packing", False),
    ("round_robin", 3, 128, "least_work_left", False),
    ("jsq", 2, 0, "fcfs", True),
])
def test_vec_cluster_matches_reference_bit_for_bit(policy, m, chunk, sched,
                                                   hetero):
    args = (policy, m, chunk, sched, 3)
    ref_reqs, ref_stats, _ = _heuristic(REF, "vec", *args, hetero=hetero)
    pt_reqs, pt_stats, cluster = _heuristic(PT, "vec", *args,
                                            hetero=hetero)
    assert isinstance(cluster, pt_vec.VecCluster)
    assert _stamps(pt_reqs) == _stamps(ref_reqs)
    assert pt_stats == ref_stats
    # and the port's two steppers agree, as the reference's do
    py_reqs, py_stats, _ = _heuristic(PT, "py", *args, hetero=hetero)
    assert _stamps(py_reqs, False) == _stamps(pt_reqs, False)
    for key in ("e2e_mean", "ttft_mean", "spikes", "n"):
        assert py_stats[key] == pt_stats[key], key
    assert [r.tbt for r in py_reqs] == pytest.approx(
        [r.tbt for r in pt_reqs], rel=1e-12)


def _drive_with_failures(ns, backend, seed, m, pc_tokens, inject_failure,
                         sessions, n=100, add=False):
    """Round-robin routing by hand, as the reference's session parity
    property drives it: past t=1 instance 0 fails, and past t=1.5 it is
    restored, then fails again on the next tick, and so on (one
    instance is added at the first restore, with ``add``)."""
    if sessions:
        scn = ns.wl.make_tenant_scenario(
            seed=seed, n_requests=n, rate=24.0, pattern="poisson",
            profiles=(ns.v100,) * m,
            sessions=ns.wl.SessionConfig(block=16))
        rs = scn.requests
    else:
        rs = _reqs(ns, n, seed)
    cluster = ns.sim.Cluster(ns.v100, m, backend=backend,
                             prefix_cache_tokens=pc_tokens,
                             prefix_block=16)
    pending = sorted(rs, key=lambda r: r.arrival)
    i, rr, failed, added = 0, 0, False, False
    while len(cluster.completed) < len(rs) and cluster.t < 3000:
        while i < len(pending) and pending[i].arrival <= cluster.t:
            cluster.enqueue(pending[i])
            i += 1
        if inject_failure and m > 1 and not failed and cluster.t > 1.0:
            cluster.fail_instance(0)
            failed = True
        if failed and cluster.t > 1.5:
            if add and not added:
                cluster.add_instance()
                added = True
            cluster.instances[0].restore()
            cluster.instances[0].clock = cluster.t
            failed = False
        alive = cluster.alive()
        while cluster.central and alive:
            cluster.route(alive[rr % len(alive)])
            rr += 1
            alive = cluster.alive()
        cluster.advance()
    assert len(cluster.completed) == len(rs)
    caches = [(pc.hit_tokens, pc.lookup_tokens, list(pc._blocks))
              if pc is not None else None
              for pc in (getattr(inst, "prefix_cache", None)
                         for inst in cluster.instances)]
    return rs, caches


def _check_failures_and_caches(seed, m, pc_tokens, inject_failure,
                               sessions, add=False):
    args = (seed, m, pc_tokens, inject_failure, sessions)
    ref_v = _drive_with_failures(REF, "vec", *args, add=add)
    pt_v = _drive_with_failures(PT, "vec", *args, add=add)
    assert _stamps(pt_v[0]) == _stamps(ref_v[0])
    assert pt_v[1] == ref_v[1]
    # the port's py stepper against its vec one wherever the reference's
    # two agree: every stamp, and each cache's hits and blocks; the
    # lookup counter only where the reference's steppers count alike
    ref_p = _drive_with_failures(REF, "py", *args, add=add)
    pt_p = _drive_with_failures(PT, "py", *args, add=add)
    assert _stamps(pt_p[0]) == _stamps(ref_p[0])
    assert pt_p[1] == ref_p[1]
    assert _stamps(pt_p[0], False) == _stamps(pt_v[0], False)
    for cp, cv, rp, rv in zip(pt_p[1], pt_v[1], ref_p[1], ref_v[1]):
        assert (cp is None) == (cv is None)
        if cp is not None:
            assert (cp[0], cp[2]) == (cv[0], cv[2])
            assert (cp[1] == cv[1]) == (rp[1] == rv[1])
    return ref_p[1] != ref_v[1]


@pytest.mark.parametrize("sessions,pc_tokens,inject_failure,add", [
    (False, 0, True, True),
    (True, 4096, False, False),
    (True, 256, False, False),
    (True, 256, True, False),
])
def test_failures_and_prefix_caches_match_reference(sessions, pc_tokens,
                                                    inject_failure, add):
    _check_failures_and_caches(3, 3, pc_tokens, inject_failure, sessions,
                               add=add)


def test_reference_lookup_counter_divergence_is_reproduced():
    """The reference's ``vec`` counts ``PrefixCache.lookup_tokens``
    differently from its ``py`` stepper on this session stream
    (instance 0's cache: 13968 on ``py`` against 11904 on ``vec``) while
    every stamp and hit agrees; the port reproduces both counts rather
    than fixing one."""
    assert _check_failures_and_caches(0, 2, 256, True, True)
    caches = [_drive_with_failures(PT, b, 0, 2, 256, True, True)[1]
              for b in ("py", "vec")]
    assert [c[0][1] for c in caches] == [13968, 11904]   # instance 0
    assert caches[0][1] == caches[1][1]                  # instance 1


@given(seed=st.integers(0, 40), m=st.integers(1, 5),
       chunk=st.sampled_from([0, 64, 256]))
@settings(max_examples=8, deadline=None, derandomize=True)
def test_vec_parity_property(seed, m, chunk):
    args = ("round_robin", m, chunk, "fcfs", seed)
    ref_reqs, _, _ = _heuristic(REF, "vec", *args, n=60)
    pt_reqs, _, _ = _heuristic(PT, "vec", *args, n=60)
    py_reqs, _, _ = _heuristic(PT, "py", *args, n=60)
    assert _stamps(pt_reqs) == _stamps(ref_reqs)
    assert _stamps(py_reqs, False) == _stamps(pt_reqs, False)


@given(seed=st.integers(0, 30), m=st.integers(1, 4),
       pc_tokens=st.sampled_from([0, 256, 4096]),
       inject_failure=st.booleans())
@settings(max_examples=6, deadline=None, derandomize=True)
def test_session_cache_parity_property(seed, m, pc_tokens, inject_failure):
    _check_failures_and_caches(seed, m, pc_tokens, inject_failure, True)


def _chaos_gateway(ns, backend):
    """The gateway under a crash and a straggler with failover and
    hedged re-dispatch (``cluster.steal``) over ``backend``."""
    scn = ns.wl.make_tenant_scenario(seed=9, n_requests=120, rate=14.0,
                                     pattern="bursty",
                                     profiles=(ns.v100,) * 3)
    gcfg = ns.gw.GatewayConfig(backend=backend, failover=True,
                               hedge_after_s=1.0, queue_cap=16)
    gcfg.chaos = ns.chaos.FaultSchedule.random(
        seed=3, m=3, horizon=8.0, n_crashes=1, n_stragglers=1)
    g = ns.gw.Gateway(gcfg, (ns.v100,) * 3,
                      ns.pol.make_gateway_policy("mixing"))
    stats = g.run(scn)
    return scn.requests, stats


def test_gateway_chaos_and_stealing_match_reference():
    ref_reqs, ref_stats = _chaos_gateway(REF, "vec")
    pt_reqs, pt_stats = _chaos_gateway(PT, "vec")
    assert pt_stats["hedged"] == ref_stats["hedged"] > 0
    assert pt_stats["orphaned"] == ref_stats["orphaned"] > 0
    assert _stamps(pt_reqs) == _stamps(ref_reqs)
    assert pt_stats == ref_stats
    py_reqs, py_stats = _chaos_gateway(PT, "py")
    assert _stamps(py_reqs, False) == _stamps(pt_reqs, False)
    for key in ("n", "shed", "hedged", "orphaned", "retried", "admitted"):
        assert py_stats[key] == pt_stats[key], key


def _pool_spans(ns, n_spans=400):
    """Three episodes of different widths in one pool, routed round
    robin, advanced by ``advance_span`` over spans of 1-13 ticks, with
    backlog terms registered so the span reward is non-zero."""
    pool = ns.vec.VecSimPool(3)
    clusters = [ns.vec.VecCluster((ns.v100,) * m, m, pool=pool, ep=ep)
                for ep, m in enumerate((2, 3, 4))]
    streams = [sorted(_reqs(ns, 30, seed=20 + ep, rate=12.0),
                      key=lambda r: r.arrival) for ep in range(3)]
    idx = [0, 0, 0]
    out = []
    for step in range(n_spans):
        spans = []
        for ep, (c, rs) in enumerate(zip(clusters, streams)):
            while idx[ep] < len(rs) and rs[idx[ep]].arrival <= c.t:
                r = rs[idx[ep]]
                c.enqueue(r)
                pool.set_backlog_terms(c.gid_of(r), ep,
                                       max(r.decode_tokens // 2, 1),
                                       1.0 / r.decode_tokens)
                idx[ep] += 1
            k = 0
            while c.central:
                c.route(k % c.m)
                k += 1
            t, bounds = c.t, []
            for _ in range(1 + (step + ep) % 13):
                t = t + 0.02
                bounds.append(t)
            spans.append((ep, bounds))
        res = pool.advance_span(spans)
        for ep, bounds in spans:
            gids, bk = res[ep]
            done = clusters[ep].collect_span(gids, len(bounds))
            out.append((ep, [r.rid - streams[ep][0].rid for r in done], bk))
    for c in clusters:
        c.sync_all()
    return out, [_stamps(rs) for rs in streams]


def test_advance_span_matches_reference():
    ref_out, ref_stamps = _pool_spans(REF)
    pt_out, pt_stamps = _pool_spans(PT)
    assert pt_out == ref_out
    assert any(bk != 0.0 for _, _, bk in pt_out)
    assert sum(len(d) for _, d, _ in pt_out) == 90
    assert pt_stamps == ref_stamps


def _featurized(ns, backend, **kw):
    """States of one cluster per tick under round-robin routing, by the
    scalar featurizer (py) or the batched one over the packed arrays
    (vec), and ``featurize_vec_many`` over two clusters of one pool."""
    reqs = _reqs(ns, 60, seed=5, rate=30.0)
    cluster = ns.sim.Cluster((ns.v100, ns.a100, ns.v100), 3,
                             backend=backend, prefix_cache_tokens=2048,
                             prefix_block=16)
    pending = sorted(reqs, key=lambda r: r.arrival)
    feats, masks, i, rr = [], [], 0, 0
    while len(cluster.completed) < len(reqs) and cluster.t < 300:
        while i < len(pending) and pending[i].arrival <= cluster.t:
            cluster.enqueue(pending[i])
            i += 1
        if cluster.t > 0.5 and not cluster.instances[1].failed \
                and cluster.t < 0.6:
            cluster.fail_instance(1)
        if cluster.central:
            feats.append(ns.state.featurize(
                cluster, ns.v100, predict_decode=lambda r: r.decode_tokens,
                **kw))
            masks.append(ns.state.action_mask(cluster))
            alive = cluster.alive()
            if alive:
                cluster.route(alive[rr % len(alive)])
                rr += 1
        cluster.advance()
    return np.stack(feats), np.stack(masks)


@pytest.mark.parametrize("kw", [
    {}, {"include_hardware": True, "include_cache": True,
         "include_health": True}], ids=["base", "hardware-cache-health"])
def test_featurizer_over_vec_matches_reference_and_py(kw):
    ref_f, ref_m = _featurized(REF, "vec", **kw)
    pt_f, pt_m = _featurized(PT, "vec", **kw)
    py_f, py_m = _featurized(PT, "py", **kw)
    assert pt_f.dtype == np.float32 and len(pt_f) > 50
    assert np.array_equal(pt_f, ref_f) and np.array_equal(pt_m, ref_m)
    assert np.array_equal(pt_f, py_f) and np.array_equal(pt_m, py_m)


def _many(ns):
    pool = ns.vec.VecSimPool(2)
    clusters = [ns.vec.VecCluster((ns.v100,) * m, m, pool=pool, ep=ep)
                for ep, m in enumerate((2, 4))]
    for ep, c in enumerate(clusters):
        for r in _reqs(ns, 12, seed=40 + ep, rate=1e6)[:9]:
            c.enqueue(r)
        for k in range(6):
            c.route(k % c.m)
    pool.advance([0, 1])
    return ns.state.featurize_vec_many(
        clusters, [ns.v100, ns.v100], [None, None], include_hardware=True)


def test_featurize_vec_many_matches_reference():
    got, want = _many(PT), _many(REF)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and np.array_equal(a, b)
