"""Vectorized structure-of-arrays simulator core (``vecsim``): the
port's own copy of ``repro.core.vecsim`` (numpy only, float64
throughout, every sum in the reference's association order).

``SimInstance`` advances one request at a time in pure Python; every
training decision and every gateway tick bottoms out in that loop, so
episode wall time is O(requests x instances x episodes).  This module
packs all requests of all instances -- and, under the batched RL
trainer, all *episodes* -- into fixed-width numpy arrays and advances
every instance of every episode in fused vector ops per "round" (one
engine iteration on every lane that is behind its episode clock):

  * a request **arena**: per-request ``prompt / prefilled / decoded /
    admit_seq / phase / ...`` rows for every request ever enqueued
    (authoritative while a request is queued or finished);
  * **lane** arrays: per-instance ``clock / rts / qps / outstanding /
    failed`` plus profile constants, a ring-buffer queue ``q_gid[L, Q]``
    and slot-aligned resident matrices (``s_prompt / s_prefilled /
    s_decoded / ...`` [L, S], authoritative while a request is
    resident, so a round touches no arena gathers on its hot path);
  * one round = vectorized admission (scheduler pick over masked queue
    heads), chunked-prefill progress, gang decode, spike detection, and
    newest-first capacity preemption (oldest-resident liveness grace),
    replicating ``SimInstance._iteration`` decision for decision.

All token quantities are integers carried in float64/int64 (float64
arithmetic on integers below 2^53 is exact), and every arithmetic
expression mirrors the scalar code's association order, so clocks,
admission decisions, and preemption choices are **bit-exact** against
the Python stepper (asserted by tests/test_vecsim.py and
tests/test_torch_vecsim.py).  The only
divergences are documented: the ordering of completions *within* one
``advance`` call, per-token ``token_times`` (synthesized evenly spaced
between the true first/last emission, so ``Request.tbt``, which sums
their spans as floats, agrees with the Python stepper's to about an ulp:
1e-12 relative in the tests, not bit for bit), and the float summation
order of the RL backlog accumulators (reward-only, never decisions).

Entry points:
  * ``Cluster(..., backend="vec")`` returns a :class:`VecCluster`
    (drop-in for the Cluster protocol: run_heuristic, the gateway, the
    RL env, and ManagedCluster all work unchanged);
  * ``VecSimPool(n_episodes)`` + ``VecCluster(..., pool=, ep=)`` packs
    many episodes into ONE set of arrays so the batched RL trainer
    steps all of them per round (``pool.advance([eps...])``) -- cost
    becomes O(rounds), not O(requests x instances x episodes).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.profiles import HardwareProfile
from repro_torch.serving import trace as _trace
from repro_torch.serving.request import Phase, Request

# phase codes (arena ``phase`` column) <-> serving.request.Phase
PH_QUEUED, PH_IQUEUE, PH_PREFILL, PH_DECODE, PH_PREEMPTED, PH_DONE = \
    range(6)
_PH_TO_ENUM = (Phase.QUEUED, Phase.INSTANCE_QUEUE, Phase.PREFILL,
               Phase.DECODE, Phase.PREEMPTED, Phase.DONE)
_ENUM_TO_PH = {p: i for i, p in enumerate(_PH_TO_ENUM)}

# resident slot states
SS_EMPTY, SS_PREFILL, SS_DECODE = 0, 1, 2

SCHED_FCFS, SCHED_BIN, SCHED_LWL = 0, 1, 2
_SCHED_CODE = {"fcfs": SCHED_FCFS, "bin_packing": SCHED_BIN,
               "least_work_left": SCHED_LWL}

# large-but-overflow-safe sentinel (added to int64 admission counters)
_BIG = np.int64(1) << 62


class VecSimPool:
    """Structure-of-arrays state for E episodes' worth of instances.

    Lanes are pool-global instance slots; each episode owns an ordered
    subset (``ep_lanes[ep]``).  The request arena grows monotonically
    (episode resets park old rows; ~150 B/request, so even thousand-
    episode training runs stay in the tens of MB)."""

    def __init__(self, n_episodes: int = 1, arena_cap: int = 1024):
        e = n_episodes
        self.E = e
        self._hw = 0                # high-water resident column + 1
        self._all = np.empty(0, np.int64)   # cached arange(L)
        self._target = np.empty(0)          # persistent advance buffer
        self._ep_min_clock = np.zeros(e)    # lower bound per episode
        self._hw_check = 0                  # periodic hw re-tighten
        self._span = None                   # advance_span bucket state
        self._lanes_cache: Dict[tuple, tuple] = {}   # eps -> lane set
        self._lanes_ver = 0
        self.ep_t = np.zeros(e)
        self.ep_dt = np.full(e, 0.02)
        # RL backlog accumulators (Eq. 3 term 1): S = sum 1/t_hat over
        # delivered-unfinished, T = sum frac/t_hat.  Maintained by the
        # round loop once any request registers inv terms (``track``).
        self.bk_s = np.zeros(e)
        self.bk_t = np.zeros(e)
        self.track = False
        # sum of inv_d*inv_t over decoding-and-uncapped residents, per
        # LANE: the per-round T accrual reduces to one masked bincount
        # (each uncapped decoding request contributes inv_d*inv_t per
        # token) with event-time corrections at the d_hat cap crossing.
        # Lane granularity matters: only lanes active in a round decode.
        self.lane_ivv = np.zeros(0)
        # python-int gates for the round loop (numpy .any() costs
        # microseconds per call on small arrays; these are free)
        self._tot_q = 0            # queued requests across all lanes
        self._tot_pref = 0         # residents still prefilling
        self._tot_dec = 0          # residents decoding
        self._next_fin = 10 ** 9   # lower bound on rounds to next finish
        self._all_fcfs = True
        self.ep_lanes: List[np.ndarray] = [np.empty(0, np.int64)
                                           for _ in range(e)]
        self._ep_gids: List[List[int]] = [[] for _ in range(e)]
        # -- lanes -------------------------------------------------------
        self._L = 0
        self._free: List[int] = []
        self._S = 8                 # resident slot columns (grows)
        self._Q = 16                # queue ring width (grows)
        z = np.zeros
        self.lane_ep = z(0, np.int64)
        self.lane_local = z(0, np.int64)    # instance index inside its ep
        self.failed = z(0, bool)
        self.clock = z(0)
        self.rts = z(0)             # resident context token sum
        self.qps = z(0)             # queued prompt token sum
        self.outst = z(0)           # outstanding prompt+decode tokens
        self.cap = z(0)
        self.nslots = z(0, np.int64)
        self.grad1 = z(0)
        self.grad2 = z(0)
        self.tdec = z(0)
        self.tpre = z(0)            # profile.t_prefill_base
        self.eps_lat = z(0)         # profile.epsilon (Eq. 1 tolerance)
        self.speed = z(0)           # straggler factor (1.0 = nominal)
        self.chunk = z(0, np.int64)
        self.sched = z(0, np.int8)
        self.admit_ctr = z(0, np.int64)
        self.res_cnt = z(0, np.int64)
        self.pref_cnt = z(0, np.int64)      # residents still prefilling
        self.qhead = z(0, np.int64)
        self.qcnt = z(0, np.int64)
        self.q_gid = np.full((0, self._Q), -1, np.int64)
        # -- resident slot matrices [L, S] ------------------------------
        s = self._S
        self.res_gid = np.full((0, s), -1, np.int64)
        self.s_state = np.zeros((0, s), np.int8)
        self.s_prompt = np.zeros((0, s), np.int64)
        self.s_dtotal = np.zeros((0, s), np.int64)
        self.s_prefilled = np.zeros((0, s), np.int64)
        self.s_decoded = np.zeros((0, s), np.int64)
        self.s_admit = np.zeros((0, s), np.int64)
        self.s_first = np.zeros((0, s))
        self.s_pfdone = np.zeros((0, s))
        self.s_invd = np.zeros((0, s))
        self.s_invt = np.zeros((0, s))
        self.s_capat = np.zeros((0, s), np.int64)   # d_hat cap tokens
        self.spikes: List[List[float]] = []
        self.lane_profile: List[HardwareProfile] = []
        # per-lane prefix/KV cache objects (core.prefix_cache) -- the
        # SAME class the Python stepper uses, so hit/miss decisions are
        # bit-identical by construction.  ``_any_cache`` is a python
        # gate: cache-free pools (every existing workload) never touch
        # the admission-time scalar loop.
        self.lane_cache: List[Optional[PrefixCache]] = []
        self._any_cache = False
        # -- request arena ----------------------------------------------
        self._G = 0
        self._cap_g = arena_cap
        g = arena_cap
        self.prompt = np.zeros(g, np.int64)
        self.dtotal = np.zeros(g, np.int64)
        self.prefilled = np.zeros(g, np.int64)
        self.decoded = np.zeros(g, np.int64)
        self.admit_seq = np.full(g, -1, np.int64)
        self.phase = np.zeros(g, np.int8)
        self.lane = np.full(g, -1, np.int64)
        self.preempts = np.zeros(g, np.int64)
        self.routed_at = np.full(g, np.nan)
        self.prefill_done = np.full(g, np.nan)
        self.first_tok = np.full(g, np.nan)
        self.finished = np.full(g, np.nan)
        self.nemit = np.zeros(g, np.int64)
        self.inv_d = np.zeros(g)
        self.inv_t = np.zeros(g)
        self.capat = np.zeros(g, np.int64)
        self.cachedp = np.zeros(g, np.int64)   # cached-prefix-length lane
        self.objs: List[Request] = []
        # lifecycle tracing: the fused round loop appends PACKED
        # per-round arrays (fancy-index copies of the round's lanes/
        # gids/timestamps) to _trbuf; drain_trace() unpacks them into
        # recorder events at advance/span boundaries so per-event
        # Python work never runs inside the vectorized loop
        self.trace = _trace.NULL
        self._trbuf: List[tuple] = []

    # -- growth ----------------------------------------------------------
    _LANE_1D = ("lane_ep", "lane_local", "failed", "clock", "rts", "qps",
                "outst", "cap", "nslots", "grad1", "grad2", "tdec",
                "tpre", "eps_lat", "speed", "chunk", "sched",
                "admit_ctr", "res_cnt", "pref_cnt", "qhead", "qcnt",
                "lane_ivv")
    _SLOT_2D = ("res_gid", "s_state", "s_prompt", "s_dtotal",
                "s_prefilled", "s_decoded", "s_admit", "s_first",
                "s_pfdone", "s_invd", "s_invt", "s_capat")
    # ``nemit`` is the emission count at (re)admission time; a resident's
    # live total is nemit + s_decoded (every decoded token of the current
    # run emits exactly once), so the hot decode loop never touches it.
    _ARENA = ("prompt", "dtotal", "prefilled", "decoded", "admit_seq",
              "phase", "lane", "preempts", "routed_at", "prefill_done",
              "first_tok", "finished", "nemit", "inv_d", "inv_t",
              "capat", "cachedp")

    @staticmethod
    def _fill_value(name):
        if name in ("routed_at", "prefill_done", "first_tok", "finished"):
            return np.nan
        if name in ("admit_seq", "lane", "res_gid", "q_gid"):
            return -1
        return 0

    def _add_lanes(self, n: int) -> List[int]:
        ids = list(range(self._L, self._L + n))
        for name in self._LANE_1D:
            a = getattr(self, name)
            setattr(self, name,
                    np.concatenate([a, np.zeros(n, a.dtype)]))
        for name in self._SLOT_2D:
            a = getattr(self, name)
            pad = np.full((n, a.shape[1]), self._fill_value(name),
                          a.dtype)
            setattr(self, name, np.concatenate([a, pad]))
        self.q_gid = np.concatenate(
            [self.q_gid, np.full((n, self._Q), -1, np.int64)])
        self.spikes.extend([] for _ in range(n))
        self.lane_profile.extend([None] * n)
        self.lane_cache.extend([None] * n)
        self._L += n
        self._all = np.arange(self._L, dtype=np.int64)
        self._target = np.full(self._L, -np.inf)
        return ids

    def _grow_res(self):
        s = self._S
        for name in self._SLOT_2D:
            a = getattr(self, name)
            pad = np.full((self._L, s), self._fill_value(name), a.dtype)
            setattr(self, name, np.concatenate([a, pad], axis=1))
        self._S = 2 * s

    def _grow_queue(self):
        q = self._Q
        new = np.full((self._L, 2 * q), -1, np.int64)
        for lane in range(self._L):
            c = self.qcnt[lane]
            if c:
                pos = (self.qhead[lane] + np.arange(c)) % q
                new[lane, :c] = self.q_gid[lane, pos]
        self.q_gid = new
        self.qhead[:] = 0
        self._Q = 2 * q

    def _grow_arena(self):
        g = self._cap_g
        for name in self._ARENA:
            a = getattr(self, name)
            b = np.full(2 * g, self._fill_value(name), a.dtype)
            b[:g] = a
            setattr(self, name, b)
        self._cap_g = 2 * g

    # -- episode / lane management --------------------------------------
    def configure_episode(self, ep: int,
                          profiles: Sequence[HardwareProfile],
                          scheduler: str = "fcfs", dt: float = 0.02,
                          chunked_prefill: int = 0,
                          n_slots: Optional[int] = None,
                          prefix_cache_tokens: int = 0,
                          prefix_block: int = 32) -> np.ndarray:
        """(Re)assign lanes for an episode and reset its clocks and
        backlog accumulators.  Reuses freed lanes; grows the pool as
        needed."""
        for lane in self.ep_lanes[ep]:
            # freed lanes must go COLD: stale residents/queues would
            # keep the _tot_* gates, the _next_fin countdown, and the
            # _hw re-tightening pinned hot (correctness is unaffected
            # -- active masks exclude them -- but the fast paths the
            # pool exists for would be silently defeated)
            self._release_lane(int(lane))
            self._free.append(int(lane))
        # drop the previous occupant's Request references: the arena
        # rows stay (cheap), but the Python objects -- and their
        # synthesized token_times -- must not be pinned for the pool's
        # lifetime across a long training run
        for gid in self._ep_gids[ep]:
            self.objs[gid] = None
        self._ep_gids[ep] = []
        m = len(profiles)
        take = [self._free.pop() for _ in range(min(m, len(self._free)))]
        if len(take) < m:
            take += self._add_lanes(m - len(take))
        lanes = np.array(sorted(take), np.int64)
        self.ep_lanes[ep] = lanes
        self._lanes_ver += 1
        self._ep_min_clock[ep] = 0.0
        self.ep_t[ep] = 0.0
        self.ep_dt[ep] = dt
        self.bk_s[ep] = 0.0
        self.bk_t[ep] = 0.0
        for k, (lane, prof) in enumerate(zip(lanes, profiles)):
            self._config_lane(int(lane), ep, k, prof, scheduler,
                              chunked_prefill, n_slots,
                              prefix_cache_tokens, prefix_block)
        return lanes

    def _release_lane(self, lane: int):
        """Retire a lane's occupancy from the python-int gates and
        clear its slot/queue state (idempotent; also run by
        _config_lane at reuse time)."""
        self._tot_q -= int(self.qcnt[lane])
        self._tot_pref -= int(self.pref_cnt[lane])
        self._tot_dec -= int(np.count_nonzero(
            self.s_state[lane] == SS_DECODE))
        self.res_cnt[lane] = 0
        self.pref_cnt[lane] = 0
        self.lane_ivv[lane] = 0.0
        self.qhead[lane] = 0
        self.qcnt[lane] = 0
        self.q_gid[lane] = -1
        self.res_gid[lane] = -1
        self.s_state[lane] = SS_EMPTY
        self.rts[lane] = 0.0
        self.qps[lane] = 0.0
        self.outst[lane] = 0.0
        self.lane_cache[lane] = None

    def _config_lane(self, lane: int, ep: int, local: int,
                     prof: HardwareProfile, scheduler: str,
                     chunked_prefill: int, n_slots: Optional[int],
                     prefix_cache_tokens: int = 0,
                     prefix_block: int = 32):
        self.lane_ep[lane] = ep
        self.lane_local[lane] = local
        self.failed[lane] = False
        self.clock[lane] = 0.0
        self.rts[lane] = 0.0
        self.qps[lane] = 0.0
        self.outst[lane] = 0.0
        self.cap[lane] = prof.capacity_tokens
        self.nslots[lane] = n_slots or prof.max_batch
        self.grad1[lane] = prof.grad1
        self.grad2[lane] = prof.grad2
        self.tdec[lane] = prof.t_decode_base
        self.tpre[lane] = prof.t_prefill_base
        self.eps_lat[lane] = prof.epsilon
        self.speed[lane] = 1.0
        self.chunk[lane] = chunked_prefill
        self.sched[lane] = _SCHED_CODE[scheduler]
        if self.sched[lane] != SCHED_FCFS:
            self._all_fcfs = False
        self.admit_ctr[lane] = 0
        self._release_lane(lane)
        self.spikes[lane] = []
        self.lane_profile[lane] = prof
        self.lane_cache[lane] = (PrefixCache(prefix_cache_tokens,
                                             prefix_block)
                                 if prefix_cache_tokens > 0 else None)
        if prefix_cache_tokens > 0:
            self._any_cache = True

    def extend_episode(self, ep: int, prof: HardwareProfile,
                       scheduler: str, chunked_prefill: int,
                       n_slots: Optional[int],
                       prefix_cache_tokens: int = 0,
                       prefix_block: int = 32) -> int:
        """Elastic scale-out: one more lane for an episode; its clock
        starts at the episode's current time (Cluster.add_instance
        parity)."""
        lane = (self._free.pop() if self._free
                else self._add_lanes(1)[0])
        local = len(self.ep_lanes[ep])
        self._config_lane(lane, ep, local, prof, scheduler,
                          chunked_prefill, n_slots,
                          prefix_cache_tokens, prefix_block)
        self.clock[lane] = self.ep_t[ep]
        self.ep_lanes[ep] = np.append(self.ep_lanes[ep], lane)
        self._lanes_ver += 1
        # the new lane's clock sits at ep_t, which may be BEHIND the
        # episode's cached min-clock bound (existing lanes overshoot
        # ticks); without lowering it the advance() fast path would
        # skip stepping the new lane entirely
        self._ep_min_clock[ep] = min(self._ep_min_clock[ep],
                                     self.clock[lane])
        return lane

    # -- request intake --------------------------------------------------
    def register(self, req: Request, ep: int = 0) -> int:
        if self._G == self._cap_g:
            self._grow_arena()
        g = self._G
        self._G += 1
        self._ep_gids[ep].append(g)
        self.prompt[g] = req.prompt_tokens
        self.dtotal[g] = req.decode_tokens
        self.prefilled[g] = req.prefilled
        self.decoded[g] = req.decoded
        self.phase[g] = _ENUM_TO_PH.get(req.phase, PH_QUEUED)
        self.preempts[g] = req.preemptions
        self.cachedp[g] = req.cached_prefix
        self.objs.append(req)
        return g

    def submit(self, gid: int, lane: int):
        """Route a registered request onto an instance lane
        (SimInstance.submit parity)."""
        self.phase[gid] = PH_IQUEUE
        self.lane[gid] = lane
        self.routed_at[gid] = self.clock[lane]
        self._qpush_right(lane, gid)
        self.qps[lane] += self.prompt[gid]
        self.outst[lane] += self.prompt[gid] + self.dtotal[gid]

    def set_backlog_terms(self, gid: int, ep: int, d_hat: int,
                          inv_t: float):
        """Stamp the RL env's per-request backlog terms; S accrues on
        delivery (RoutingEnv._deliver parity).  ``d_hat`` is the decode
        estimate whose reciprocal scales per-token progress (the T
        contribution saturates once ``decoded >= d_hat``)."""
        self.inv_d[gid] = 1.0 / d_hat
        self.inv_t[gid] = inv_t
        self.capat[gid] = d_hat
        self.bk_s[ep] += inv_t
        self.track = True

    # -- queue ring ------------------------------------------------------
    def _qpush_right(self, lane: int, gid: int):
        if self.qcnt[lane] == self._Q:
            self._grow_queue()
        pos = (self.qhead[lane] + self.qcnt[lane]) % self._Q
        self.q_gid[lane, pos] = gid
        self.qcnt[lane] += 1
        self._tot_q += 1

    def _qpush_left(self, lane: int, gid: int):
        if self.qcnt[lane] == self._Q:
            self._grow_queue()
        self.qhead[lane] = (self.qhead[lane] - 1) % self._Q
        self.q_gid[lane, self.qhead[lane]] = gid
        self.qcnt[lane] += 1
        self._tot_q += 1

    def _qpop_at(self, lane: int, k: int) -> int:
        """Remove the k-th (logical) queue entry, preserving order."""
        q, h, c = self._Q, int(self.qhead[lane]), int(self.qcnt[lane])
        gid = int(self.q_gid[lane, (h + k) % q])
        for j in range(k, c - 1):
            self.q_gid[lane, (h + j) % q] = \
                self.q_gid[lane, (h + j + 1) % q]
        self.qcnt[lane] -= 1
        self._tot_q -= 1
        return gid

    def queue_gids(self, lane: int) -> np.ndarray:
        c = int(self.qcnt[lane])
        pos = (int(self.qhead[lane]) + np.arange(c)) % self._Q
        return self.q_gid[lane, pos]

    def resident_cols(self, lane: int) -> np.ndarray:
        """Occupied slot columns in admission order (Python residents
        list-order parity)."""
        row = self.res_gid[lane]
        cols = np.flatnonzero(row >= 0)
        return cols[np.argsort(self.s_admit[lane, cols])]

    # -- the fused round loop -------------------------------------------
    def advance(self, eps: Sequence[int]) -> Dict[int, List[int]]:
        """Advance each episode's clock by its dt and run every lane of
        every episode to the new time in fused rounds.  Returns
        completed gids per episode (ordering within one call is
        round-major, unlike the Python stepper's instance-major -- no
        consumer depends on intra-tick ordering)."""
        key = tuple(int(e) for e in eps)
        if len(key) == 1:
            # scalar fast path: most advances cover one episode (ticks
            # are 0.02 s but an iteration is >= t_decode_base, so about
            # half the calls find every lane already past the target
            # and must cost almost nothing)
            e = key[0]
            t = self.ep_t[e] + self.ep_dt[e]
            self.ep_t[e] = t
            if self._ep_min_clock[e] >= t:
                return {e: []}
            lanes_all = self.ep_lanes[e]
            done: Dict[int, List[int]] = {e: []}
            if lanes_all.size == 0:
                return done
            self._advance_rounds(lanes_all, done)
            self._ep_min_clock[e] = self.clock[lanes_all].min()
            return done
        cache = self._lanes_cache.get(key)
        if cache is None or cache[0] != self._lanes_ver:
            # single-episode calls returned via the scalar fast path
            lanes_all = np.concatenate([self.ep_lanes[e] for e in key])
            eps_arr = np.asarray(key, np.int64)
            cache = (self._lanes_ver, lanes_all, eps_arr)
            self._lanes_cache[key] = cache
        _, lanes_all, eps_arr = cache
        self.ep_t[eps_arr] = self.ep_t[eps_arr] + self.ep_dt[eps_arr]
        done = {e: [] for e in key}
        if lanes_all.size == 0:
            return done
        if (self._ep_min_clock[eps_arr] >= self.ep_t[eps_arr]).all():
            return done
        self._advance_rounds(lanes_all, done)
        for e in key:
            lanes = self.ep_lanes[e]
            if lanes.size:
                self._ep_min_clock[e] = self.clock[lanes].min()
        return done

    def advance_span(self, spans) -> Dict[int, tuple]:
        """Advance several episodes by SEVERAL ticks each in one fused
        round sequence -- the batched trainer's stepping primitive.

        ``spans`` is a list of ``(ep, boundaries)`` where ``boundaries``
        is the episode's next tick times built by sequential ``t += dt``
        adds (so clock targets match the Python stepper bit for bit).
        Lanes of all episodes iterate in shared rounds toward their
        episode's FINAL boundary; because an engine iteration is
        typically several dt long, lanes that a per-tick advance would
        touch in different calls now coincide in the same round -- this
        is what makes stepping cost O(rounds) instead of
        O(episodes x instances x ticks).

        Returns ``{ep: (completed gids, backlog_reward)}`` where
        ``backlog_reward`` is ``sum over ticks of (T-S) * dt`` with the
        per-tick samples reconstructed from bucketed contributions: a
        round's T/S deltas count toward exactly the samples a per-tick
        stepper would have seen (same values up to float summation
        order, which is already this backend's documented reward-side
        divergence)."""
        done: Dict[int, List[int]] = {}
        pen0 = {}
        k_tot = 0
        offs = {}
        for ep, bounds in spans:
            done[ep] = []
            offs[ep] = k_tot
            k_tot += len(bounds) + 1
            pen0[ep] = float(self.bk_t[ep] - self.bk_s[ep])
        d_flat = np.zeros(k_tot)
        lane_off = np.zeros(self._L, np.int64)
        lane_k = np.zeros(self._L, np.int64)
        span_t0 = np.zeros(self._L)
        target = np.full(self._L, -np.inf)
        for ep, bounds in spans:
            lanes = self.ep_lanes[ep]
            t0 = self.ep_t[ep]
            self.ep_t[ep] = bounds[-1]
            if lanes.size == 0:
                continue
            span_t0[lanes] = t0
            lane_off[lanes] = offs[ep]
            lane_k[lanes] = len(bounds)
            target[lanes] = bounds[-1]
        self._span = (span_t0, lane_off, lane_k, d_flat)
        try:
            self._run_rounds(target, done)
        finally:
            self._span = None
        out = {}
        for ep, bounds in spans:
            lanes = self.ep_lanes[ep]
            if lanes.size:
                self._ep_min_clock[ep] = self.clock[lanes].min()
            k = len(bounds)
            off = offs[ep]
            pen = pen0[ep] + np.cumsum(d_flat[off + 1:off + k + 1])
            out[ep] = (done[ep], float(pen.sum() * self.ep_dt[ep]))
        return out

    def _span_bucket(self, lanes, clocks):
        """Flat d_flat indices for contributions whose iteration starts
        at ``clocks`` on ``lanes`` (full-width or subset aligned)."""
        span_t0, lane_off, lane_k, _ = self._span
        b = np.floor((clocks - span_t0[lanes])
                     / self.ep_dt[self.lane_ep[lanes]]).astype(np.int64) \
            + 1
        np.clip(b, 1, lane_k[lanes], out=b)
        return lane_off[lanes] + b

    def _run_rounds(self, target: np.ndarray,
                    done: Dict[int, List[int]]):
        """Round loop over an explicit full-width target vector.

        This is the backend override point: everything above it
        (enqueue/route/collect, span bookkeeping) is pure SoA state
        manipulation shared by every pooled backend, and everything
        below is the per-round simulation semantics.  ``JaxSimPool``
        (core.jaxsim) overrides ONLY this method to run the same rounds
        as one kernel launch on the card."""
        behind = self.clock < target
        if behind.any():
            runnable = ((self.res_cnt > 0) | (self.qcnt > 0)) \
                & ~self.failed
            jump = behind & ~runnable
            if jump.any():
                self.clock[jump] = target[jump]
            active = behind & runnable
            while active.any():
                self._iterate(active, done)
                active &= self.clock < target
                if not active.any():
                    break
                dry = active & ~((self.res_cnt > 0)
                                 | (self.qcnt > 0))
                if dry.any():
                    self.clock[dry] = target[dry]
                    active &= ~dry
        if self._trbuf:
            self.drain_trace()

    def _advance_rounds(self, lanes_all: np.ndarray,
                        done: Dict[int, List[int]]):
        # periodically re-tighten the resident column high-water mark
        # (a transient burst can double it and every matrix op pays)
        self._hw_check += 1
        if self._hw_check >= 512:
            self._hw_check = 0
            peak = int(self.res_cnt.max()) if self._L else 0
            if self._hw > 2 * peak + 2:
                occ = (self.res_gid >= 0).any(0)
                self._hw = (int(np.flatnonzero(occ).max()) + 1
                            if occ.any() else 0)
        # full-width target vector (persistent buffer): lanes outside
        # the advance set carry -inf and can never activate.  All
        # round-loop state is held as [L]-wide masks so the hot ops
        # below never fancy-index.
        target = self._target
        target[lanes_all] = self.ep_t[self.lane_ep[lanes_all]]
        self._run_rounds(target, done)
        target[lanes_all] = -np.inf     # stale targets must not linger
        return done

    def _iterate(self, active: np.ndarray, done: Dict[int, List[int]]):
        """One engine iteration on every lane where ``active`` ([L]
        bool) is set -- the vectorized transliteration of
        ``SimInstance._iteration``.  Operating full-width with a mask
        (row index == lane id) keeps every hot op an in-place
        contiguous vector op; inactive lanes contribute zeros and are
        never written (x + 0.0 == x exactly, so clock/rts stay
        bit-identical)."""
        hw = self._hw
        # span reward bucketing reads iteration START clocks after the
        # clock write below, so it needs a real snapshot; the per-tick
        # path only reads clock0 before the write and an alias is free
        clock0 = (self.clock.copy() if self._span is not None
                  else self.clock)
        rts = self.rts                     # rebound before any mutation
        # -- admission: one request per lane if a slot is free ----------
        if self._tot_q:
            can = active & (self.res_cnt < self.nslots) & (self.qcnt > 0)
            al = np.flatnonzero(can)
            if al.size:
                budget = self.cap[al] - rts[al]
                picks = self._sched_pick(al, budget)
                sel = picks >= 0
                if sel.any():
                    al2 = al[sel]
                    gids = self._queue_remove(al2, picks[sel])
                    self.qps[al2] -= self.prompt[gids]
                    seq = self.admit_ctr[al2]
                    self.admit_seq[gids] = seq
                    self.admit_ctr[al2] = seq + 1
                    self.phase[gids] = PH_PREFILL
                    if self._any_cache:
                        # prefix-cache lookups are per-lane scalar ops
                        # (at most one admission per lane per round);
                        # the arena ``prefilled`` must carry the credit
                        # BEFORE _res_insert copies it into the slot
                        for k in range(al2.size):
                            pc = self.lane_cache[int(al2[k])]
                            if pc is None:
                                continue
                            gid = int(gids[k])
                            r = self.objs[gid]
                            if r is None or not r.prefix_hashes:
                                continue
                            cached = pc.admit(int(self.prompt[gid]),
                                              r.prefix_hashes)
                            if cached:
                                self.prefilled[gid] = cached
                                self.cachedp[gid] = cached
                    self._res_insert(al2, gids, seq)
                    hw = self._hw
                    # SimInstance adds the admitted request's
                    # prefilled+decoded to rts here; by the queue
                    # invariant (queued progress is always zero --
                    # preemption resets before requeue) that term is
                    # exactly 0 UNLESS a prefix-cache hit credited the
                    # prompt.  The in-place add below lands on the
                    # ``rts`` alias the it_time expression reads, and
                    # the cached part of the prompt leaves the
                    # outstanding-work sum (it is never prefilled) --
                    # both mirror the scalar stepper; with no cache the
                    # adds are exactly 0 and x + 0.0 == x keeps bits.
                    if self._any_cache:
                        add = self.prefilled[gids] + self.decoded[gids]
                        self.rts[al2] += add
                        self.outst[al2] -= add
                    if self.trace.enabled:
                        # clock0 may alias self.clock here, but the
                        # fancy index copies the pre-advance values
                        self._trbuf.append(
                            ("adm", clock0[al2], al2, gids,
                             self.cachedp[gids]))
        act2 = active[:, None]
        # -- prefill progress (full, or one chunk per iteration) --------
        prefill_tokens = 0
        had_transition = False
        if self._tot_pref:
            st = self.s_state[:, :hw]                    # views
            spf = self.s_prefilled[:, :hw]
            spr = self.s_prompt[:, :hw]
            pref = (st == SS_PREFILL) & act2
            rem = (spr - spf) * pref
            step = np.minimum(self.chunk[:, None], rem) * pref
            # unchunked lanes: only the FIRST (by admission order)
            # prefilling resident runs, for its full remaining prompt
            un = self.chunk == 0
            if un.any():
                aseq = self.s_admit[:, :hw] + (~pref) * _BIG
                first = aseq.argmin(1)
                ustep = np.zeros_like(step)
                rows = np.flatnonzero(un & pref.any(1))
                ustep[rows, first[rows]] = rem[rows, first[rows]]
                if un.all():
                    step = ustep
                else:
                    step = np.where(un[:, None], ustep, step)
            if self.trace.enabled:
                # chunk events only on chunked lanes (SimInstance
                # emits them only when self.chunk is set)
                chm = (step > 0) & (self.chunk[:, None] > 0)
                if chm.any():
                    trl, trc = np.nonzero(chm)
                    self._trbuf.append(
                        ("chunk", clock0[trl], trl,
                         self.res_gid[trl, trc], step[trl, trc]))
            spf += step                                  # in place
            prefill_tokens = step.sum(1)
            fin_pref = pref & (spf >= spr)
            n_tr = int(np.count_nonzero(fin_pref))
            if n_tr:
                had_transition = True
                if self.trace.enabled:
                    trl, trc = np.nonzero(fin_pref)
                    self._trbuf.append(
                        ("pfd", clock0[trl], trl,
                         self.res_gid[trl, trc]))
                st[fin_pref] = SS_DECODE
                pfd = self.s_pfdone[:, :hw]
                pfd[fin_pref] = np.broadcast_to(
                    clock0[:, None], fin_pref.shape)[fin_pref]
                self.pref_cnt -= fin_pref.sum(1)
                self._tot_pref -= n_tr
                self._tot_dec += n_tr
                self._next_fin = 0        # force the completion check
                if self.track:
                    # transitioned residents start contributing their
                    # per-token T increment (all uncapped: decoded==0)
                    ivv = (self.s_invd[:, :hw] * self.s_invt[:, :hw]
                           * fin_pref)
                    self.lane_ivv += ivv.sum(1)
            self.outst -= prefill_tokens
        # -- iteration time + spikes (Fig. 1a); the prefill-base term
        # mirrors HardwareProfile.iteration_time's association order
        # (x + 0.0 == x, so zero-tpre profiles stay bit-identical) ------
        # the straggler factor multiplies the finished sum exactly like
        # SimInstance (x * 1.0 == x, so nominal lanes stay bit-identical)
        it_time = (self.tdec + self.grad1 * prefill_tokens
                   + self.grad2 * rts
                   + self.tpre * (prefill_tokens > 0)) * self.speed
        sp = active & (it_time > 2.0 * self.tdec * self.speed)
        if sp.any():
            for i in np.flatnonzero(sp):
                self.spikes[int(i)].append(float(it_time[i]))
        clock1 = clock0 + it_time
        np.copyto(self.clock, clock1, where=active)
        rts = rts + prefill_tokens
        # -- gang decode ------------------------------------------------
        if self._tot_dec:
            dec = (self.s_state[:, :hw] == SS_DECODE) & act2
            per_lane = dec.sum(1)
            sdec = self.s_decoded[:, :hw]
            sdec += dec                                  # in place
            if had_transition:
                # a first-ever token can only be emitted in a round
                # where some request just finished its prefill (it
                # decodes the same iteration); all other rounds skip
                # the first-token bookkeeping entirely
                sfirst = self.s_first[:, :hw]
                fresh = dec & np.isnan(sfirst)
                if fresh.any():
                    if self.trace.enabled:
                        trl, trc = np.nonzero(fresh)
                        self._trbuf.append(
                            ("ft", clock1[trl], trl,
                             self.res_gid[trl, trc]))
                    sfirst[fresh] = np.broadcast_to(
                        clock1[:, None], fresh.shape)[fresh]
            rts = rts + per_lane
            self.outst -= per_lane
            if self.track:
                # T accrues inv_d*inv_t per decoding-uncapped resident
                # (event-maintained per-lane sums, masked by the round's
                # active lanes) with a correction on the round a
                # request crosses its d_hat cap
                delta = self.lane_ivv * active
                self.bk_t += np.bincount(self.lane_ep, weights=delta,
                                         minlength=self.E)
                if self._span is not None:
                    np.add.at(self._span[3],
                              self._span_bucket(self._all, clock0),
                              delta)
                crossed = dec & (sdec == self.s_capat[:, :hw])
                if crossed.any():
                    cl, cc = np.nonzero(crossed)
                    ivd = self.s_invd[cl, cc]
                    ivt = self.s_invt[cl, cc]
                    capat = self.s_capat[cl, cc]
                    full_tok = ivd * ivt
                    part = (1.0 - (capat - 1) * ivd) * ivt
                    np.add.at(self.bk_t, self.lane_ep[cl],
                              part - full_tok)
                    np.subtract.at(self.lane_ivv, cl, full_tok)
                    if self._span is not None:
                        np.add.at(self._span[3],
                                  self._span_bucket(cl, clock0[cl]),
                                  part - full_tok)
            # -- completions (countdown skips the check on rounds
            #    where no decoding resident can possibly finish) ------
            self._next_fin -= 1
            if self._next_fin <= 0:
                fin = dec & (sdec >= self.s_dtotal[:, :hw])
                np.copyto(self.rts, rts, where=active)
                if fin.any():
                    self._complete(fin, clock0, clock1, done)
                dmask = self.s_state[:, :hw] == SS_DECODE
                if dmask.any():
                    left = (self.s_dtotal[:, :hw] - sdec)[dmask]
                    self._next_fin = int(left.min())
                else:
                    self._next_fin = 10 ** 9
            else:
                np.copyto(self.rts, rts, where=active)
        else:
            np.copyto(self.rts, rts, where=active)
        # -- capacity enforcement: evict newest-admitted ----------------
        over = self.rts > self.cap
        if over.any():
            over &= active & (self.res_cnt > 1)
            for i in np.flatnonzero(over):
                self._preempt_lane(int(i), float(clock0[i]))

    def _complete(self, fin, clock0, clock1, done):
        """Retire finished residents: arena write-back + slot clear.
        ``fin`` is a full-width [L, hw] mask (row index == lane id)."""
        lf, fc = np.nonzero(fin)
        fg = self.res_gid[lf, fc]
        if self.trace.enabled:
            self._trbuf.append(("fin", clock1[lf], lf, fg))
        self.phase[fg] = PH_DONE
        self.finished[fg] = clock1[lf]
        self.prefilled[fg] = self.s_prefilled[lf, fc]
        self.decoded[fg] = self.s_decoded[lf, fc]
        self.first_tok[fg] = self.s_first[lf, fc]
        self.nemit[fg] += self.s_decoded[lf, fc]
        self.prefill_done[fg] = self.s_pfdone[lf, fc]
        drop = (self.s_prefilled[lf, fc] + self.s_decoded[lf, fc]
                ).astype(np.float64)
        if lf.size == 1:
            lane = int(lf[0])
            self.rts[lane] -= drop[0]
            self.res_cnt[lane] -= 1
        else:
            np.subtract.at(self.rts, lf, drop)
            np.subtract.at(self.res_cnt, lf, 1)
        self.res_gid[lf, fc] = -1
        self.s_state[lf, fc] = SS_EMPTY
        self._tot_dec -= lf.size
        if self.track:
            ivt_f = self.inv_t[fg]
            if ivt_f.any():
                ep_idx = self.lane_ep[lf]
                prog = np.minimum(self.decoded[fg] * self.inv_d[fg],
                                  1.0) * ivt_f
                self.bk_s -= np.bincount(ep_idx, weights=ivt_f,
                                         minlength=self.E)
                self.bk_t -= np.bincount(ep_idx, weights=prog,
                                         minlength=self.E)
                if self._span is not None:
                    # a finisher settles T -= prog and S -= inv_t in
                    # the tick its final iteration started
                    np.add.at(self._span[3],
                              self._span_bucket(lf, clock0[lf]),
                              ivt_f - prog)
                # finishers that never hit their d_hat cap stop
                # contributing to the per-round T accrual
                uncap = self.decoded[fg] < self.capat[fg]
                if uncap.any():
                    np.subtract.at(self.lane_ivv, lf,
                                   self.inv_d[fg] * ivt_f * uncap)
        if self._any_cache:
            # completion-time full-chain insert (prompt + reply KV
            # stays cached).  SimInstance inserts in residents
            # (admission) order; np.nonzero yields column order, so
            # same-round finishers are replayed by admit_seq -- a
            # global stable sort preserves each lane's relative order.
            order = (np.argsort(self.admit_seq[fg], kind="stable")
                     if lf.size > 1 else range(lf.size))
            for k in order:
                pc = self.lane_cache[int(lf[k])]
                if pc is None:
                    continue
                r = self.objs[int(fg[k])]
                if r is not None and r.full_hashes:
                    pc.insert(r.full_hashes)
        for lane, gid in zip(lf, fg):
            self._sync_done(int(gid))
            done[int(self.lane_ep[lane])].append(int(gid))

    def _sched_pick(self, lanes: np.ndarray,
                    budget: np.ndarray) -> np.ndarray:
        """Per-lane queue position to admit (or -1), replicating the
        serving.scheduler picks.  FCFS (the default everywhere) is a
        fused head check; the scanning schedulers fall back to a
        per-lane vector scan."""
        if self._all_fcfs:
            head = self.q_gid[lanes, self.qhead[lanes]]
            # queue invariant: queued requests carry zero progress, so
            # the admission cost is exactly the prompt
            fits = self.prompt[head] <= budget
            return fits.astype(np.int64) - 1       # True -> 0, False -> -1
        out = np.full(lanes.size, -1, np.int64)
        fcfs = self.sched[lanes] == SCHED_FCFS
        if fcfs.any():
            lf = lanes[fcfs]
            head = self.q_gid[lf, self.qhead[lf]]
            fits = (self.prompt[head] + self.decoded[head]
                    <= budget[fcfs])
            out[fcfs] = np.where(fits, 0, -1)
        if not fcfs.all():
            for i in np.flatnonzero(~fcfs):
                lane = int(lanes[i])
                gq = self.queue_gids(lane)
                adm = self.prompt[gq] + self.decoded[gq]
                fit = adm <= budget[i]
                if not fit.any():
                    continue
                if self.sched[lane] == SCHED_BIN:
                    size = np.where(
                        fit, self.prompt[gq] + self.dtotal[gq], -1)
                    out[i] = int(np.argmax(size))   # first max: FCFS tie
                else:                                # least_work_left
                    key = np.where(fit, self.dtotal[gq], _BIG)
                    out[i] = int(np.argmin(key))     # first min: FCFS tie
        return out

    def _queue_remove(self, lanes: np.ndarray,
                      pos: np.ndarray) -> np.ndarray:
        gids = np.empty(lanes.size, np.int64)
        h = pos == 0
        if h.all():
            heads = self.qhead[lanes]
            gids = self.q_gid[lanes, heads]
            self.qhead[lanes] = (heads + 1) % self._Q
            self.qcnt[lanes] -= 1
            self._tot_q -= lanes.size
            return gids
        if h.any():
            lh = lanes[h]
            heads = self.qhead[lh]
            gids[h] = self.q_gid[lh, heads]
            self.qhead[lh] = (heads + 1) % self._Q
            self.qcnt[lh] -= 1
            self._tot_q -= int(h.sum())
        for i in np.flatnonzero(~h):
            gids[i] = self._qpop_at(int(lanes[i]), int(pos[i]))
        return gids

    def _res_insert(self, lanes: np.ndarray, gids: np.ndarray,
                    seq: np.ndarray):
        """Load admitted requests from the arena into free slots
        (first-fit column, which keeps occupancy dense under the
        ``_hw`` high-water mark)."""
        while (self.res_cnt[lanes] >= self._S).any():
            self._grow_res()
        if lanes.size == 1:
            lane, gid = int(lanes[0]), int(gids[0])
            col = int((self.res_gid[lane] == -1).argmax())
            self.res_gid[lane, col] = gid
            self.s_state[lane, col] = SS_PREFILL
            self.s_prompt[lane, col] = self.prompt[gid]
            self.s_dtotal[lane, col] = self.dtotal[gid]
            self.s_prefilled[lane, col] = self.prefilled[gid]
            self.s_decoded[lane, col] = self.decoded[gid]
            self.s_admit[lane, col] = seq[0]
            self.s_first[lane, col] = self.first_tok[gid]
            self.s_pfdone[lane, col] = self.prefill_done[gid]
            self.s_invd[lane, col] = self.inv_d[gid]
            self.s_invt[lane, col] = self.inv_t[gid]
            self.s_capat[lane, col] = self.capat[gid]
            self.res_cnt[lane] += 1
            self.pref_cnt[lane] += 1
            self._tot_pref += 1
            self._hw = max(self._hw, col + 1)
            return
        free = (self.res_gid[lanes] == -1).argmax(1)
        self.res_gid[lanes, free] = gids
        self.s_state[lanes, free] = SS_PREFILL
        self.s_prompt[lanes, free] = self.prompt[gids]
        self.s_dtotal[lanes, free] = self.dtotal[gids]
        self.s_prefilled[lanes, free] = self.prefilled[gids]
        self.s_decoded[lanes, free] = self.decoded[gids]
        self.s_admit[lanes, free] = seq
        self.s_first[lanes, free] = self.first_tok[gids]
        self.s_pfdone[lanes, free] = self.prefill_done[gids]
        self.s_invd[lanes, free] = self.inv_d[gids]
        self.s_invt[lanes, free] = self.inv_t[gids]
        self.s_capat[lanes, free] = self.capat[gids]
        self.res_cnt[lanes] += 1
        self.pref_cnt[lanes] += 1
        self._tot_pref += lanes.size
        self._hw = max(self._hw, int(free.max()) + 1)

    def _evict_slot(self, lane: int, col: int) -> int:
        """Remove a resident slot, writing progress back to the arena
        (shared by preemption and fail); returns the gid."""
        gid = int(self.res_gid[lane, col])
        self.prefilled[gid] = self.s_prefilled[lane, col]
        self.decoded[gid] = self.s_decoded[lane, col]
        self.first_tok[gid] = self.s_first[lane, col]
        self.nemit[gid] += self.s_decoded[lane, col]
        self.prefill_done[gid] = self.s_pfdone[lane, col]
        if self.s_state[lane, col] == SS_PREFILL:
            self.pref_cnt[lane] -= 1
            self._tot_pref -= 1
        else:
            self._tot_dec -= 1
            if self.track and self.s_invt[lane, col] \
                    and self.s_decoded[lane, col] < self.s_capat[lane,
                                                                 col]:
                self.lane_ivv[lane] -= (self.s_invd[lane, col]
                                        * self.s_invt[lane, col])
        self.res_gid[lane, col] = -1
        self.s_state[lane, col] = SS_EMPTY
        self.res_cnt[lane] -= 1
        return gid

    def _preempt_lane(self, lane: int, t0: float = 0.0):
        """Newest-admitted eviction until within budget; the oldest
        resident is never evicted (liveness grace).  ``t0`` is the
        containing iteration's start clock (span reward bucketing)."""
        cap = self.cap[lane]
        while self.rts[lane] > cap and self.res_cnt[lane] > 1:
            row = self.res_gid[lane]
            occ = np.flatnonzero(row >= 0)
            col = int(occ[np.argmax(self.s_admit[lane, occ])])
            gid = self._evict_slot(lane, col)
            progress = float(self.prefilled[gid] + self.decoded[gid])
            if self.trace.enabled:
                # SimInstance stamps preemptions at the post-advance
                # clock (the eviction loop runs after the clock write)
                self._trbuf.append(("pre", float(self.clock[lane]),
                                    lane, gid, progress))
            self.rts[lane] -= progress
            self.outst[lane] += progress   # requeued at full size again
            self._reset_progress(gid, t0)
            self._qpush_left(lane, gid)
            self.qps[lane] += self.prompt[gid]

    def _reset_progress(self, gid: int, t0: float = 0.0):
        """Preemption: work is lost (Request.reset_progress parity),
        including the env's backlog T debit."""
        if self.decoded[gid] and self.inv_t[gid]:
            lane = int(self.lane[gid])
            debit = min(self.decoded[gid] * self.inv_d[gid],
                        1.0) * self.inv_t[gid]
            self.bk_t[int(self.lane_ep[lane])] -= debit
            if self._span is not None:
                lanes = np.array([lane])
                idx = self._span_bucket(lanes, np.array([t0]))
                self._span[3][idx[0]] -= debit
        self.prefilled[gid] = 0
        self.decoded[gid] = 0
        self.cachedp[gid] = 0
        self.phase[gid] = PH_PREEMPTED
        self.preempts[gid] += 1

    # -- fault injection -------------------------------------------------
    def fail_lane(self, lane: int) -> List[int]:
        """Node failure: orphaned gids in residents-then-queue order
        (SimInstance.fail parity); lane state cleared."""
        if self.trace.enabled:
            self._trbuf.append(("fail", float(self.clock[lane]), lane))
        orphans = [self._evict_slot(lane, int(c))
                   for c in self.resident_cols(lane)]
        orphans += [int(x) for x in self.queue_gids(lane)]
        self.failed[lane] = True
        self.q_gid[lane] = -1
        self._tot_q -= int(self.qcnt[lane])
        self.qcnt[lane] = 0
        self.qhead[lane] = 0
        self.rts[lane] = 0.0
        self.qps[lane] = 0.0
        self.outst[lane] = 0.0
        self.pref_cnt[lane] = 0
        if self.lane_cache[lane] is not None:
            # the KV pool dies with the node (SimInstance.fail parity)
            self.lane_cache[lane].clear()
        for gid in orphans:
            self._reset_progress(gid)
            self.phase[gid] = PH_QUEUED
            self.lane[gid] = -1
            # the attempt died: clear timing stamps (SimInstance.fail
            # parity) so TTFT/TBT/E2E measure the serving attempt
            self.first_tok[gid] = np.nan
            self.nemit[gid] = 0
            self.prefill_done[gid] = np.nan
            r = self.objs[gid]
            r.prefilled = 0
            r.decoded = 0
            r.cached_prefix = 0
            r.preemptions = int(self.preempts[gid])
            r.phase = Phase.QUEUED
            r.instance = None
            r.first_token = None
            r.token_times = []
            r.prefill_done = None
        if self._trbuf:
            self.drain_trace()   # called between advances
        return orphans

    def recover_lane(self, lane: int, t: Optional[float] = None):
        """Undo fail_lane: the lane comes back *empty* at its clock
        (SimInstance.recover parity).  ``t`` lower-bounds the clock for
        callers recovering between advances (the round loop has already
        fast-forwarded failed lanes, so this is usually a no-op)."""
        if t is not None:
            self.clock[lane] = max(float(self.clock[lane]), float(t))
        self.failed[lane] = False
        if self.trace.enabled:
            self._trbuf.append(("recover", float(self.clock[lane]),
                                lane))
            self.drain_trace()

    def steal_request(self, gid: int) -> bool:
        """Withdraw a routed request for hedged re-dispatch
        (SimInstance.steal parity): remove it from its lane's queue or
        resident slots with the same sum fixups, reset progress and
        timing stamps.  Returns False if the request is no longer on an
        instance (completed this tick)."""
        lane = int(self.lane[gid])
        if lane < 0:
            return False
        if self.phase[gid] in (PH_PREFILL, PH_DECODE):
            cols = np.flatnonzero(self.res_gid[lane] == gid)
            if not cols.size:
                return False
            self._evict_slot(lane, int(cols[0]))
            self.rts[lane] -= self.prefilled[gid] + self.decoded[gid]
            self.outst[lane] -= (
                (self.prompt[gid] - self.prefilled[gid])
                + (self.dtotal[gid] - self.decoded[gid]))
        elif self.phase[gid] == PH_IQUEUE:
            ks = np.flatnonzero(self.queue_gids(lane) == gid)
            if not ks.size:
                return False
            self._qpop_at(lane, int(ks[0]))
            self.qps[lane] -= self.prompt[gid]
            self.outst[lane] -= self.prompt[gid] + self.dtotal[gid]
        else:
            return False
        self._reset_progress(gid)
        self.phase[gid] = PH_QUEUED
        self.lane[gid] = -1
        self.first_tok[gid] = np.nan
        self.nemit[gid] = 0
        self.prefill_done[gid] = np.nan
        r = self.objs[gid]
        if r is not None:
            r.prefilled = 0
            r.decoded = 0
            r.cached_prefix = 0
            r.preemptions = int(self.preempts[gid])
            r.phase = Phase.QUEUED
            r.instance = None
            r.first_token = None
            r.token_times = []
            r.prefill_done = None
        return True

    # -- trace drain -----------------------------------------------------
    def drain_trace(self):
        """Unpack the round loop's packed event buffers into recorder
        events.  Runs once per advance/advance_span call (and after a
        fail_lane), so the per-event Python cost is paid outside the
        fused rounds; head-sampling is applied here by the recorder's
        own rid filter, identical to the Python stepper's inline
        emission."""
        buf = self._trbuf
        self._trbuf = []
        tr = self.trace
        objs = self.objs
        loc = self.lane_local
        for rec in buf:
            kind = rec[0]
            if kind == "fail":
                tr.emit(rec[1], _trace.EV_FAIL, -1, int(loc[rec[2]]))
                continue
            if kind == "recover":
                tr.emit(rec[1], _trace.EV_RECOVER, -1,
                        int(loc[rec[2]]))
                continue
            if kind == "pre":
                _, t, lane, gid, lost = rec
                r = objs[gid]
                if r is not None:
                    tr.emit(t, _trace.EV_PREEMPT, r.rid,
                            int(loc[lane]), r.tenant,
                            {"lost": int(lost)})
                continue
            if kind == "adm":
                _, ts, lanes, gids, cached = rec
                for t, ln, g, c in zip(ts, lanes, gids, cached):
                    r = objs[int(g)]
                    if r is not None:
                        tr.emit(float(t), _trace.EV_INST_ADMIT, r.rid,
                                int(loc[ln]), r.tenant,
                                {"cached": int(c)})
            elif kind == "chunk":
                _, ts, lanes, gids, toks = rec
                for t, ln, g, k in zip(ts, lanes, gids, toks):
                    r = objs[int(g)]
                    if r is not None:
                        tr.emit(float(t), _trace.EV_PREFILL_CHUNK,
                                r.rid, int(loc[ln]), r.tenant,
                                {"tokens": int(k)})
            else:
                etype = (_trace.EV_PREFILL_DONE if kind == "pfd"
                         else _trace.EV_FIRST_TOKEN if kind == "ft"
                         else _trace.EV_COMPLETE)
                _, ts, lanes, gids = rec
                for t, ln, g in zip(ts, lanes, gids):
                    r = objs[int(g)]
                    if r is not None:
                        tr.emit(float(t), etype, r.rid,
                                int(loc[ln]), r.tenant)

    # -- object sync -----------------------------------------------------
    def _sync_done(self, gid: int):
        r = self.objs[gid]
        r.phase = Phase.DONE
        r.prefilled = int(self.prefilled[gid])
        r.decoded = int(self.decoded[gid])
        r.cached_prefix = int(self.cachedp[gid])
        r.preemptions = int(self.preempts[gid])
        r.admitted_idx = int(self.admit_seq[gid])
        lane = int(self.lane[gid])
        r.instance = int(self.lane_local[lane])
        r.routed_at = float(self.routed_at[gid])
        r.prefill_done = float(self.prefill_done[gid])
        first = float(self.first_tok[gid])
        r.first_token = None if np.isnan(first) else first
        r.finished = float(self.finished[gid])
        ne = int(self.nemit[gid])
        # evenly-spaced synthesis between the true first and last
        # emission: Request.tbt sums these spans as floats, so it is
        # (last-first)/(n-1) to within an ulp or so of py's uneven
        # spans, not bit for bit (the synthesized last time,
        # first + step * (n-1), need not round to the finish time
        # either); per-token jitter (bench_table3's gap variance) is
        # lost.
        if ne >= 2:
            step = (r.finished - first) / (ne - 1)
            r.token_times = (first + step * np.arange(ne)).tolist()
        elif ne == 1:
            r.token_times = [first]

    def sync_request(self, gid: int):
        """Write live (possibly in-flight) arena state back to the
        Python Request object.  Residents are synced through their
        slot-matrix state (the arena is stale while resident)."""
        if self.phase[gid] == PH_DONE:
            self._sync_done(gid)
            return
        r = self.objs[gid]
        lane = int(self.lane[gid])
        if self.phase[gid] in (PH_PREFILL, PH_DECODE) and lane >= 0:
            row = self.res_gid[lane]
            cols = np.flatnonzero(row == gid)
            if cols.size:
                c = int(cols[0])
                r.prefilled = int(self.s_prefilled[lane, c])
                r.decoded = int(self.s_decoded[lane, c])
                # cachedp never changes while resident, so the arena
                # lane is current even though slot state is live
                r.cached_prefix = int(self.cachedp[gid])
                r.phase = (Phase.PREFILL
                           if self.s_state[lane, c] == SS_PREFILL
                           else Phase.DECODE)
                first = float(self.s_first[lane, c])
                r.first_token = None if np.isnan(first) else first
                pfd = float(self.s_pfdone[lane, c])
                if not np.isnan(pfd):
                    r.prefill_done = pfd
                r.admitted_idx = int(self.s_admit[lane, c])
                r.preemptions = int(self.preempts[gid])
                r.instance = int(self.lane_local[lane])
                r.routed_at = float(self.routed_at[gid])
                return
        r.phase = _PH_TO_ENUM[self.phase[gid]]
        r.prefilled = int(self.prefilled[gid])
        r.decoded = int(self.decoded[gid])
        r.cached_prefix = int(self.cachedp[gid])
        r.preemptions = int(self.preempts[gid])
        r.instance = int(self.lane_local[lane]) if lane >= 0 else None
        if lane >= 0:
            r.routed_at = float(self.routed_at[gid])
        if not np.isnan(self.first_tok[gid]):
            r.first_token = float(self.first_tok[gid])
        if not np.isnan(self.prefill_done[gid]):
            r.prefill_done = float(self.prefill_done[gid])


class VecInstanceView:
    """Read surface of one lane, SimInstance-compatible: O(1) token
    sums for the routing policies and the featurizer, materialized
    (and synced) Request lists only when legacy code actually scans
    ``residents`` / ``queue``."""

    def __init__(self, pool: VecSimPool, lane: int, instance_id: int):
        self.pool = pool
        self.lane = lane
        self.instance_id = instance_id
        # SimInstance hook-surface compatibility (unused on vec: the
        # pool maintains the backlog accumulators itself)
        self.on_token = None
        self.on_preempt = None

    # -- identity / profile ---------------------------------------------
    @property
    def profile(self) -> HardwareProfile:
        return self.pool.lane_profile[self.lane]

    @property
    def failed(self) -> bool:
        return bool(self.pool.failed[self.lane])

    @property
    def n_slots(self) -> int:
        return int(self.pool.nslots[self.lane])

    @property
    def clock(self) -> float:
        return float(self.pool.clock[self.lane])

    @clock.setter
    def clock(self, t: float):
        self.pool.clock[self.lane] = t

    @property
    def spikes(self) -> List[float]:
        return self.pool.spikes[self.lane]

    @property
    def prefix_cache(self):
        """The lane's PrefixCache (None when the cache model is off);
        the SAME object the stepping code mutates, so policy/featurizer
        hit-fraction queries are bit-identical to the py backend."""
        return self.pool.lane_cache[self.lane]

    # -- router-visible state -------------------------------------------
    def resident_token_sum(self) -> float:
        return float(self.pool.rts[self.lane])

    def queued_prompt_sum(self) -> float:
        return float(self.pool.qps[self.lane])

    def outstanding_tokens(self) -> float:
        return float(self.pool.outst[self.lane])

    def free_tokens(self) -> float:
        p = self.pool
        return float(p.cap[self.lane] - p.rts[self.lane]
                     - p.qps[self.lane])

    def earliest_completion(self) -> float:
        p = self.pool
        row = p.res_gid[self.lane]
        occ = row >= 0
        if not occ.any():
            return 0.0
        left = int((p.s_dtotal[self.lane][occ]
                    - p.s_decoded[self.lane][occ]).min())
        return max(left, 0) * p.tdec[self.lane]

    @property
    def residents(self) -> List[Request]:
        p = self.pool
        out = []
        for c in p.resident_cols(self.lane):
            gid = int(p.res_gid[self.lane, c])
            p.sync_request(gid)
            out.append(p.objs[gid])
        return out

    @property
    def queue(self) -> List[Request]:
        p = self.pool
        out = []
        for gid in p.queue_gids(self.lane):
            p.sync_request(int(gid))
            out.append(p.objs[int(gid)])
        return out

    def load_summary(self) -> Dict:
        res = self.residents
        return {
            "n_resident": len(res),
            "n_queued": int(self.pool.qcnt[self.lane]),
            "p_tokens": [r.prompt_tokens for r in res],
            "d_tokens": [r.decoded for r in res],
            "resident_tokens": self.resident_token_sum(),
            "free_tokens": self.free_tokens(),
            "earliest_completion": self.earliest_completion(),
            "clock": self.clock,
        }

    @property
    def speed_factor(self) -> float:
        return float(self.pool.speed[self.lane])

    @speed_factor.setter
    def speed_factor(self, f: float):
        self.pool.speed[self.lane] = f

    def recover(self):
        self.pool.recover_lane(self.lane)

    def restore(self):
        self.pool.failed[self.lane] = False


class VecCluster:
    """Cluster-protocol view over (one episode of) a VecSimPool.

    Constructed directly (``Cluster(..., backend="vec")`` routes here)
    it owns a private single-episode pool; the batched RL trainer
    instead passes a shared ``pool`` + ``ep`` so all its episodes'
    instances advance in the same fused rounds."""

    is_vec = True

    def __init__(self, profile, n_instances: int,
                 scheduler: str = "fcfs", dt: float = 0.02,
                 chunked_prefill: int = 0,
                 n_slots: Optional[int] = None,
                 pool: Optional[VecSimPool] = None, ep: int = 0,
                 prefix_cache_tokens: int = 0, prefix_block: int = 32,
                 trace=None):
        if isinstance(profile, HardwareProfile):
            profiles = [profile] * n_instances
        else:
            profiles = list(profile)
            if len(profiles) != n_instances:
                raise ValueError(
                    f"{len(profiles)} profiles for {n_instances} "
                    "instances")
        self.pool = pool or VecSimPool(1)
        if trace is not None:
            # pool-level: a shared-pool trainer would trace ALL its
            # episodes' lanes; the gateway/cluster path owns a private
            # single-episode pool, so lane set == this cluster
            self.pool.trace = trace
        self.ep = ep
        self.dt = dt
        self._prefix_cache_tokens = prefix_cache_tokens
        self._prefix_block = prefix_block
        self.lane_ids = self.pool.configure_episode(
            ep, profiles, scheduler, dt, chunked_prefill, n_slots,
            prefix_cache_tokens=prefix_cache_tokens,
            prefix_block=prefix_block)
        self.profile = profiles[0]
        self.profiles = tuple(profiles)
        self.instances = [VecInstanceView(self.pool, int(lane), i)
                          for i, lane in enumerate(self.lane_ids)]
        self.central: deque = deque()
        self.completed: List[Request] = []
        self.queue_len_trace: List[int] = []
        self._gid: Dict[int, int] = {}        # rid -> arena gid

    @property
    def m(self) -> int:
        return len(self.instances)

    @property
    def t(self) -> float:
        return float(self.pool.ep_t[self.ep])

    def gid_of(self, req: Request) -> int:
        return self._gid[req.rid]

    def alive(self) -> List[int]:
        failed = self.pool.failed[self.lane_ids]
        return [i for i in range(self.m) if not failed[i]]

    def enqueue(self, req: Request):
        req.phase = Phase.QUEUED
        if req.rid not in self._gid:
            self._gid[req.rid] = self.pool.register(req, self.ep)
        self.central.append(req)

    def route(self, idx: int) -> Request:
        req = self.central.popleft()
        gid = self._gid[req.rid]
        self.pool.submit(gid, int(self.lane_ids[idx]))
        # keep the object's routing fields live (policies may read them)
        req.phase = Phase.INSTANCE_QUEUE
        req.instance = idx
        req.routed_at = float(self.pool.routed_at[gid])
        return req

    def advance(self) -> List[Request]:
        """Advance the episode clock by dt; returns completions."""
        done_map = self.pool.advance([self.ep])
        return self.collect(done_map[self.ep])

    def collect(self, gids: List[int]) -> List[Request]:
        """Turn completed gids into (already-synced) Request objects
        and fold them into the episode bookkeeping -- shared by
        advance() and the batched trainer's fused advance."""
        done = [self.pool.objs[g] for g in gids]
        self.completed.extend(done)
        self.queue_len_trace.append(len(self.central))
        return done

    def collect_span(self, gids: List[int], n_ticks: int
                     ) -> List[Request]:
        """collect() for a multi-tick span advance (the central queue
        cannot change inside a span, so the trace entries repeat)."""
        done = [self.pool.objs[g] for g in gids]
        self.completed.extend(done)
        self.queue_len_trace.extend([len(self.central)] * n_ticks)
        return done

    def add_instance(self, scheduler: str = "fcfs",
                     chunked_prefill: int = 0,
                     profile: Optional[HardwareProfile] = None) -> int:
        lane = self.pool.extend_episode(
            self.ep, profile or self.profile, scheduler,
            chunked_prefill, None,
            prefix_cache_tokens=self._prefix_cache_tokens,
            prefix_block=self._prefix_block)
        idx = len(self.instances)
        self.instances.append(VecInstanceView(self.pool, lane, idx))
        self.lane_ids = self.pool.ep_lanes[self.ep]
        self.profiles = self.profiles + (profile or self.profile,)
        return idx

    def fail_instance(self, idx: int, requeue: bool = True
                      ) -> List[Request]:
        orphans = [self.pool.objs[gid]
                   for gid in self.pool.fail_lane(
                       int(self.lane_ids[idx]))]
        if requeue:
            for r in orphans:
                self.central.appendleft(r)
        return orphans

    def recover_instance(self, idx: int):
        self.pool.recover_lane(int(self.lane_ids[idx]), self.t)

    def set_speed_factor(self, idx: int, factor: float):
        self.pool.speed[int(self.lane_ids[idx])] = float(factor)

    def steal(self, req: Request) -> bool:
        gid = self._gid.get(req.rid)
        if gid is None:
            return False
        return self.pool.steal_request(gid)

    def set_trace(self, trace):
        """Attach a TraceRecorder after construction (Cluster parity)."""
        self.pool.trace = trace

    def sync_all(self):
        """Write every registered request's arena state back to its
        Python object (episode-end reporting)."""
        for gid in self._gid.values():
            self.pool.sync_request(gid)


# -- the pooled drive of benchmarks/bench_jaxsim.py -----------------------------

def span_ticks(cluster, pending: Sequence[Request], i: int,
               span_cap: int) -> int:
    """The drive's span length: 1 tick while the central queue holds a
    decision, ``span_cap`` once every arrival is in (the drain window),
    else up to the next arrival (``pending[i]``)."""
    if cluster.central:
        return 1
    if i >= len(pending):
        return span_cap
    return max(1, min(span_cap, int(np.ceil(
        (pending[i].arrival - cluster.t) / cluster.dt))))


def drive_pooled(pool: VecSimPool, all_reqs: Sequence[Sequence[Request]],
                 policy, profile, n_instances: int, span_cap: int = 256,
                 max_t: float = 36_000.0) -> List[VecCluster]:
    """One episode a pool slot (``all_reqs[e]`` over ``n_instances``
    instances of ``profile``), every live episode's span advanced in
    one shared ``pool.advance_span`` call: route while the central
    queue has work (``policy.act``, at most 64 a tick), then advance
    ``span_ticks``; an episode ends when every request completed or
    its clock reached ``max_t``.  Returns the clusters, synced."""
    clusters = [VecCluster(profile, n_instances, pool=pool, ep=e)
                for e in range(len(all_reqs))]
    pend = [sorted(rs, key=lambda r: r.arrival) for rs in all_reqs]
    idx = [0] * len(clusters)
    live = set(range(len(clusters)))
    while live:
        spans = []
        for e in sorted(live):
            c, rs = clusters[e], pend[e]
            while idx[e] < len(rs) and rs[idx[e]].arrival <= c.t:
                c.enqueue(rs[idx[e]])
                idx[e] += 1
            for _ in range(64):
                if not c.central:
                    break
                act = policy.act(c)
                if act is None or act >= c.m:
                    break
                c.route(act)
            if len(c.completed) >= len(rs) or c.t >= max_t:
                live.discard(e)
                continue
            t, bounds = c.t, []
            for _ in range(span_ticks(c, rs, idx[e], span_cap)):
                t += c.dt
                bounds.append(t)
            spans.append((e, bounds))
        if spans:
            out = pool.advance_span(spans)
            for e, bounds in spans:
                clusters[e].collect_span(out[e][0], len(bounds))
    for c in clusters:
        c.sync_all()
    return clusters
