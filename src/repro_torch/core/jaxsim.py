"""Device-resident simulator pool (``backend="jax"``): the port of
``repro.core.jaxsim``, with the round loop as one hand-written CUDA kernel.

``JaxSimPool`` subclasses :class:`repro_torch.core.vecsim.VecSimPool` and
overrides exactly one method, ``_run_rounds``: the choke point that both
per-tick ``advance`` and the batched trainer's ``advance_span`` flow
through.  Everything else (episode and lane management, the request
arena, queue rings, fail/recover/steal, ``VecCluster`` views, trace
draining) is inherited, so every host-side read between spans
(featurize, policy scores, masks) sees the same synced numpy arrays, and
decisions equal the numpy pool's by construction.

The override stages the pool's live state once per ``_run_rounds`` call
-- packed into one float64 and one int64 block
(:class:`repro_torch.kernels.sim_rounds.ops.Layout`), pinned on the host,
one copy each way -- runs the WHOLE round sequence in one launch of
``kernels/sim_rounds`` (``device="cpu"`` runs its plain PyTorch version
instead), and syncs the results back.

Parity contract (as the reference's, ``jaxsim.py:21-37``):

  * decisions, clocks, TTFT, preemptions, per-request token counts:
    bit-equal to the numpy pool (itself bit-equal to the Python
    stepper);
  * rewards (the backlog S/T accumulators and the span buckets): equal
    up to float summation order, 1e-9 relative;
  * spike VALUES are not materialized (counts are; every consumer counts
    ``len(spikes)``): the host lists get a ``nan`` per detected spike.

Eligibility is the reference's (``jaxsim.py:407-422``): lifecycle
tracing, a prefix cache, a span of ``SPAN_BUCKETS`` ticks or more, or a
span shorter than ``min_span_ticks`` runs the inherited numpy rounds,
with identical results.  Nothing else sends a call to the host: without
a card the pool raises at construction unless ``device="cpu"``, and a
kernel that fails to build or launch raises.

Arena compaction: only queued and resident requests can be touched by a
round, so each call gathers those rows into a compact ``[C_pad]`` block
(a grow-only power of two), remaps gids, and scatters the results back.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.vecsim import SS_DECODE, VecSimPool
from repro_torch.kernels.sim_rounds import ops as sim_ops

# d_lane reward-bucket columns: col 0 is the discard bucket (lanes
# outside any span clip there), cols 1..SPAN_BUCKETS-1 are span ticks.
# Matches RoutingEnv._span_bounds(cap=256); longer spans run on the
# numpy path.  A call stages only the columns its longest span reaches.
SPAN_BUCKETS = 257


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


class JaxSimPool(VecSimPool):
    """VecSimPool whose round loop runs as one kernel launch per call.

    Drop-in: ``make_backend("jax")`` (``Cluster(..., backend="jax")``,
    ``BatchedRLConfig(backend="jax")``) builds it through the
    ``core.backends`` registry.  ``min_span_ticks`` is the hybrid
    threshold: spans estimated shorter than this many ticks run on the
    inherited numpy path; results are identical either way.  ``device``
    is the card unless the caller asks for the CPU (the kernel's plain
    version)."""

    def __init__(self, n_episodes: int = 1, arena_cap: int = 1024,
                 min_span_ticks: int = 8, device="cuda"):
        super().__init__(n_episodes, arena_cap)
        self.device = resolve_device(device)
        self.min_span_ticks = min_span_ticks
        # dispatch counters (chip_smoke.py and the tests report these)
        self.n_jax_calls = 0
        self.n_numpy_calls = 0
        # grow-only compact-arena padding (the reference's retrace guard;
        # here it keeps the blocks' sizes steady across calls)
        self._c_pad = 64
        self._layouts: Dict[tuple, sim_ops.Layout] = {}
        self._host = (torch.empty(0, dtype=torch.float64),
                      torch.empty(0, dtype=torch.int64))
        self._dev = self._host
        self._host_np = tuple(t.numpy() for t in self._host)

    # -- the single override ------------------------------------------
    def _run_rounds(self, target: np.ndarray,
                    done: Dict[int, List[int]]):
        if not self._jax_eligible(target):
            self.n_numpy_calls += 1
            return super()._run_rounds(target, done)
        behind = self.clock < target
        if not behind.any():
            return
        runnable = ((self.res_cnt > 0) | (self.qcnt > 0)) & ~self.failed
        jump = behind & ~runnable
        if jump.any():
            self.clock[jump] = target[jump]
        active = behind & runnable
        if not active.any():
            return
        self.n_jax_calls += 1
        self._dispatch(active, target, done)

    def _jax_eligible(self, target) -> bool:
        if self.trace.enabled or self._any_cache or self._L == 0:
            return False
        if self._span is not None:
            lane_k = self._span[2]
            k_max = int(lane_k.max()) if lane_k.size else 0
            if k_max >= SPAN_BUCKETS:
                return False
            return k_max >= self.min_span_ticks
        # per-tick advance: estimate the span length in ticks
        gap = target - self.clock
        behind = gap > 0
        if not behind.any():
            return True            # nothing to do; either path returns
        ticks = gap[behind] / self.ep_dt[self.lane_ep[behind]]
        return float(ticks.max()) >= self.min_span_ticks

    # -- staging / writeback ------------------------------------------
    def _blocks(self, layout: sim_ops.Layout):
        """The host blocks (pinned for the card) and the device blocks,
        grown to the layout (doubling, never shrinking)."""
        pin = self.device.type == "cuda"
        host = list(self._host)
        dev = list(self._dev)
        for k, (n, dtype) in enumerate(((layout.n_f, torch.float64),
                                        (layout.n_i, torch.int64))):
            if host[k].numel() < n:
                size = max(n, 2 * host[k].numel())
                host[k] = torch.empty(size, dtype=dtype, pin_memory=pin)
                dev[k] = (torch.empty(size, dtype=dtype, device=self.device)
                          if pin else host[k])
        if host[0] is not self._host[0] or host[1] is not self._host[1]:
            self._host_np = tuple(t.numpy() for t in host)
            # the cached layouts keep views of the old blocks
            self._layouts.clear()
        self._host, self._dev = tuple(host), tuple(dev)
        return self._host, self._dev

    def _dispatch(self, active: np.ndarray, target: np.ndarray,
                  done: Dict[int, List[int]]):
        L = self._L
        # precondition widths so the kernel never needs to grow:
        # residents are bounded by min(nslots, res_cnt+qcnt) (no new
        # submissions inside a span), queues by res_cnt+qcnt (preempt
        # requeues at most res_cnt-1)
        need_s = int(np.minimum(self.nslots,
                                self.res_cnt + self.qcnt).max())
        while self._S < need_s:
            self._grow_res()
        need_q = int((self.res_cnt + self.qcnt).max())
        while self._Q < need_q:
            self._grow_queue()
        S, Q = self._S, self._Q
        # candidate rows: every queued or resident gid, all lanes (the
        # carry holds full-width matrices, so even inactive lanes' gids
        # must survive the remap round trip)
        pos = (self.qhead[:, None] + np.arange(Q)) % Q
        gq = self.q_gid[np.arange(L)[:, None], pos]     # logical order
        qvalid = np.arange(Q) < self.qcnt[:, None]
        cand = np.unique(np.concatenate(
            [self.res_gid[self.res_gid >= 0], gq[qvalid]]))
        C = cand.size
        need = _next_pow2(max(C, 1))
        if need > self._c_pad:
            self._c_pad = need
        C_pad = self._c_pad
        gmap = np.full(self._cap_g, -1, np.int64)
        gmap[cand] = np.arange(C)
        res_gid_c = np.where(self.res_gid >= 0,
                             gmap[np.maximum(self.res_gid, 0)], -1)
        q_c = np.where(qvalid, gmap[np.maximum(gq, 0)], -1)

        def _pad(col):
            out = np.zeros(C_pad, col.dtype)
            out[:C] = col[cand]
            return out

        if self._span is not None:
            span_t0, _, lane_k, _ = self._span
            width = int(lane_k.max()) + 1
        else:
            span_t0 = np.zeros(L)
            lane_k = np.zeros(L, np.int64)
            width = 1
        ro = dict(
            target=target, cap=self.cap, nslots=self.nslots,
            grad1=self.grad1, grad2=self.grad2, tdec=self.tdec,
            tpre=self.tpre, speed=self.speed, chunk=self.chunk,
            sched=self.sched, lane_ep=self.lane_ep,
            ep_dt_lane=self.ep_dt[self.lane_ep], span_t0=span_t0,
            lane_k=lane_k, prompt=_pad(self.prompt),
            dtotal=_pad(self.dtotal), inv_d=_pad(self.inv_d),
            inv_t=_pad(self.inv_t), capat=_pad(self.capat))
        carry = dict(
            active=active, clock=self.clock, rts=self.rts,
            qps=self.qps, outst=self.outst, admit_ctr=self.admit_ctr,
            res_cnt=self.res_cnt, pref_cnt=self.pref_cnt,
            qcnt=self.qcnt, q=q_c, res_gid=res_gid_c,
            s_state=self.s_state, s_prompt=self.s_prompt,
            s_dtotal=self.s_dtotal, s_prefilled=self.s_prefilled,
            s_decoded=self.s_decoded, s_admit=self.s_admit,
            s_first=self.s_first, s_pfdone=self.s_pfdone,
            s_invd=self.s_invd, s_invt=self.s_invt, s_capat=self.s_capat,
            lane_ivv=self.lane_ivv, spike_cnt=0, bk_s=self.bk_s,
            bk_t=self.bk_t, a_prefilled=_pad(self.prefilled),
            a_decoded=_pad(self.decoded),
            a_admit_seq=_pad(self.admit_seq), a_phase=_pad(self.phase),
            a_preempts=_pad(self.preempts),
            a_first_tok=_pad(self.first_tok),
            a_prefill_done=_pad(self.prefill_done),
            a_finished=_pad(self.finished), a_nemit=_pad(self.nemit),
            done_round=-1, done_col=0, round_no=0)
        key = (L, S, Q, C_pad, self.E, width)
        layout = self._layouts.get(key)
        if layout is None:
            layout = self._layouts[key] = sim_ops.Layout(*key)
        (hf, hi), (df, di) = self._blocks(layout)
        hf_np, hi_np = self._host_np
        layout.pack(ro, carry, hf_np, hi_np)
        if df is not hf:
            # one copy in (read-only + carry), one launch, one copy out
            # (carry + span buckets)
            df[:layout.f_in].copy_(hf[:layout.f_in], non_blocking=True)
            di[:layout.i_in].copy_(hi[:layout.i_in], non_blocking=True)
            sim_ops.sim_rounds(layout, df, di)
            hf[layout.f_back:layout.n_f].copy_(
                df[layout.f_back:layout.n_f], non_blocking=True)
            hi[layout.i_back:layout.n_i].copy_(
                di[layout.i_back:layout.n_i], non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        else:
            sim_ops.sim_rounds(layout, hf, hi)
        self._writeback(layout.carry_out(hf_np, hi_np), cand, C, done)

    def _writeback(self, out, cand, C, done):
        Q = self._Q
        for name in ("clock", "rts", "qps", "outst", "admit_ctr",
                     "res_cnt", "pref_cnt", "qcnt", "lane_ivv",
                     "bk_s", "bk_t", "s_prompt", "s_dtotal",
                     "s_prefilled", "s_decoded", "s_admit", "s_first",
                     "s_pfdone", "s_invd", "s_invt", "s_capat"):
            getattr(self, name)[...] = out[name]
        self.s_state[...] = out["s_state"]
        # un-remap compact gids; queues come back logically ordered
        rc = out["res_gid"]
        self.res_gid[...] = np.where(rc >= 0, cand[np.maximum(rc, 0)],
                                     -1)
        qc = out["q"]
        qvalid = np.arange(Q) < out["qcnt"][:, None]
        self.q_gid[...] = np.where(qvalid & (qc >= 0),
                                   cand[np.maximum(qc, 0)], -1)
        self.qhead[:] = 0
        for src, dst in (("a_prefilled", "prefilled"),
                         ("a_decoded", "decoded"),
                         ("a_admit_seq", "admit_seq"),
                         ("a_preempts", "preempts"),
                         ("a_first_tok", "first_tok"),
                         ("a_prefill_done", "prefill_done"),
                         ("a_finished", "finished"),
                         ("a_nemit", "nemit")):
            getattr(self, dst)[cand] = out[src][:C]
        self.phase[cand] = out["a_phase"][:C]
        # python-int gates for the (possibly interleaved) numpy path
        self._tot_q = int(out["qcnt"].sum())
        self._tot_pref = int(out["pref_cnt"].sum())
        self._tot_dec = int((self.s_state == SS_DECODE).sum())
        self._next_fin = 0
        occ = (self.res_gid >= 0).any(0)
        self._hw = (int(np.flatnonzero(occ).max()) + 1 if occ.any()
                    else 0)
        # spikes: counts only (placeholder values; see module doc)
        for lane in np.flatnonzero(out["spike_cnt"]):
            self.spikes[int(lane)].extend(
                [float("nan")] * int(out["spike_cnt"][lane]))
        # span reward buckets: fold per-lane rows into the flat
        # per-episode tick vector (col 0 is the discard bucket)
        if self._span is not None:
            _, lane_off, lane_k, d_flat = self._span
            d_lane = out["d_lane"]
            cols = np.arange(1, d_lane.shape[1])
            mask = cols[None, :] <= lane_k[:, None]
            idx = lane_off[:, None] + cols[None, :]
            np.add.at(d_flat, idx[mask], d_lane[:, 1:][mask])
        # completions, replayed in the vec backend's order: round-
        # major, then lane, then slot column within a lane
        new = np.flatnonzero(out["done_round"][:C] >= 0)
        if new.size:
            gids = cand[new]
            order = np.lexsort((out["done_col"][new],
                                self.lane[gids],
                                out["done_round"][new]))
            for j in order:
                gid = int(gids[j])
                self._sync_done(gid)
                done[int(self.lane_ep[self.lane[gid]])].append(gid)
