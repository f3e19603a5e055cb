"""The device-resident simulator's round loop: the CUDA kernel's wrapper,
its plain PyTorch version, and the packed layout both read.

The reference runs every round of one ``_run_rounds`` call as one jitted
``lax.while_loop`` over ``_round_body`` (``repro/core/jaxsim.py:78-356``):
admission with the scheduler's pick, prefill progress, the iteration time
and its spike, gang decode with the backlog accrual, completions, the
newest-first preemption and the dry-lane jump, on every active lane, until
none is active.  Here:

* :func:`rounds_plain` transliterates ``_round_body`` into PyTorch on
  ``[L, S]`` / ``[L, Q]`` / ``[C_pad]`` tensors in float64 / int64 with a
  Python ``while`` loop, on dicts named as the reference's ``ro`` and
  ``carry``.  Every product and sum is its own op (no ``addcmul``, no
  ``alpha=``), so nothing contracts into an FMA.
* :class:`Layout` packs ``ro`` and ``carry`` into ONE float64 and ONE
  int64 block: the read-only fields first, then the carry, then what the
  kernel only writes (the span buckets ``d_lane`` and per-lane scratch).
  A call copies the first two parts in and the last two out, one copy
  each way.
* :func:`sim_rounds` runs a packed call in place: CPU blocks through the
  plain version, CUDA blocks through the hand-written kernel in
  ``csrc/sim_rounds.cu`` (built on first use), anything else raises.
  There is no fallback from the kernel to the plain version.

The kernel runs one thread per lane, each its own ``while (active)`` loop
over the round body; it replaces an XLA program of the reference (no
Pallas kernel), and is bound by the latency of its dependent loads, not
by bytes or operations.  The backlog sums per episode (``bk_s``,
``bk_t``) are per-lane accumulators summed per episode in ascending lane
order by a second launch, so they equal the reference's ``segment_sum``
up to summation order (1e-9 relative, ``jaxsim.py:28-34``); every
decision, clock and per-request time is bit-equal.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import build

#: kernel launches since the last reset (the plain version never counts);
#: one a packed call (the rounds and the per-episode sums)
launches = 0

# codes shared with core.vecsim (kept here so the kernel module stands
# alone; tests hold them equal)
SS_EMPTY, SS_PREFILL, SS_DECODE = 0, 1, 2
PH_PREFILL, PH_PREEMPTED, PH_DONE = 2, 4, 5
SCHED_FCFS, SCHED_BIN = 0, 1
BIG = 1 << 62

#: threads a block of the round kernel (one lane a thread)
THREADS = 32

# the blocks' fields in order, (name, shape) with shape letters L lanes,
# S slot columns, Q queue width, C compacted arena rows, E episodes, W
# span-bucket columns; the C source's F_* / I_* enums follow this order
F64_FIELDS = (
    # read-only
    ("target", "L"), ("cap", "L"), ("grad1", "L"), ("grad2", "L"),
    ("tdec", "L"), ("tpre", "L"), ("speed", "L"), ("ep_dt_lane", "L"),
    ("span_t0", "L"), ("inv_d", "C"), ("inv_t", "C"),
    # carry
    ("clock", "L"), ("rts", "L"), ("qps", "L"), ("outst", "L"),
    ("lane_ivv", "L"), ("bk_s", "E"), ("bk_t", "E"), ("s_first", "LS"),
    ("s_pfdone", "LS"), ("s_invd", "LS"), ("s_invt", "LS"),
    ("a_first_tok", "C"), ("a_prefill_done", "C"), ("a_finished", "C"),
    # written by the kernel only
    ("d_lane", "LW"), ("acc_s", "L"), ("acc_t", "L"),
)
I64_FIELDS = (
    ("nslots", "L"), ("chunk", "L"), ("sched", "L"), ("lane_ep", "L"),
    ("lane_k", "L"), ("prompt", "C"), ("dtotal", "C"), ("capat", "C"),
    ("ep_ptr", "E1"), ("ep_lanes", "L"),
    ("active", "L"), ("admit_ctr", "L"), ("res_cnt", "L"),
    ("pref_cnt", "L"), ("qcnt", "L"), ("spike_cnt", "L"), ("q", "LQ"),
    ("res_gid", "LS"), ("s_state", "LS"), ("s_prompt", "LS"),
    ("s_dtotal", "LS"), ("s_prefilled", "LS"), ("s_decoded", "LS"),
    ("s_admit", "LS"), ("s_capat", "LS"), ("a_prefilled", "C"),
    ("a_decoded", "C"), ("a_admit_seq", "C"), ("a_phase", "C"),
    ("a_preempts", "C"), ("a_nemit", "C"), ("done_round", "C"),
    ("done_col", "C"), ("round_no", "1"),
    ("lane_rounds", "L"),
)
# the first carry field and the first kernel-only field of each block
F64_CARRY, F64_OUT = 11, 25
I64_CARRY, I64_OUT = 10, 34
# the reference's ro keys (the rest of the read-only part is the
# kernel's episode index) and the scratch the reference has not
RO_KEYS = tuple(n for n, _ in F64_FIELDS[:F64_CARRY]) + tuple(
    n for n, _ in I64_FIELDS[:8])
SCRATCH = ("acc_s", "acc_t", "ep_ptr", "ep_lanes", "lane_rounds")


class Layout:
    """Offsets of every field in the two blocks for one call's shapes."""

    def __init__(self, L: int, S: int, Q: int, C: int, E: int, W: int):
        self.L, self.S, self.Q, self.C, self.E, self.W = L, S, Q, C, E, W
        dims = {"L": (L,), "C": (C,), "E": (E,), "E1": (E + 1,),
                "LS": (L, S), "LQ": (L, Q), "LW": (L, W), "1": ()}
        # (name, in the float64 block, start, stop, shape) a field
        self._spans = []
        start, sizes = {}, []
        for is_f, fields in ((True, F64_FIELDS), (False, I64_FIELDS)):
            off = 0
            for name, kind in fields:
                shape = dims[kind]
                n = max(math.prod(shape), 1)
                self._spans.append((name, is_f, off, off + n, shape))
                start[name] = off
                off += n
            sizes.append(off)
        #: the blocks' lengths (elements), and the offsets table the C
        #: entry reads (float fields first)
        self.n_f, self.n_i = sizes
        self.table = np.asarray([sp[2] for sp in self._spans], np.int64)
        #: the elements copied in (read-only + carry) and where the copy
        #: out starts (carry + kernel-only), per block
        self.f_in = start[F64_FIELDS[F64_OUT][0]]
        self.i_in = start[I64_FIELDS[I64_OUT][0]]
        self.f_back = start[F64_FIELDS[F64_CARRY][0]]
        self.i_back = start[I64_FIELDS[I64_CARRY][0]]
        self._views: Dict[tuple, tuple] = {}

    def views(self, fblock, iblock) -> Dict:
        """name -> a view of its field in the blocks (numpy arrays or
        torch tensors alike; the views of the last few pairs are
        kept)."""
        key = (id(fblock), id(iblock))
        hit = self._views.get(key)
        if hit is not None and hit[0] is fblock and hit[1] is iblock:
            return hit[2]
        out = {name: (fblock if is_f else iblock)[a:z].reshape(shape)
               for name, is_f, a, z, shape in self._spans}
        if len(self._views) >= 4:
            self._views.clear()
        self._views[key] = (fblock, iblock, out)
        return out

    def pack(self, ro: Dict, carry: Dict, fblock: np.ndarray,
             iblock: np.ndarray):
        """Write the reference-shaped ``ro`` and ``carry`` (numpy) into
        host blocks, with the kernel's episode index (lanes of each
        episode in ascending order)."""
        v = self.views(fblock, iblock)
        for src in (ro, carry):
            for name, val in src.items():
                if name in v:
                    v[name][...] = val
        order = np.argsort(ro["lane_ep"], kind="stable")
        v["ep_lanes"][...] = order
        v["ep_ptr"][...] = np.searchsorted(ro["lane_ep"][order],
                                           np.arange(self.E + 1))

    def carry_out(self, fblock, iblock) -> Dict:
        """The reference's ``_run_kernel`` output keys, viewed in the
        blocks after a call (``active`` as int64)."""
        v = self.views(fblock, iblock)
        return {n: v[n] for n in v if n not in RO_KEYS
                and n not in SCRATCH}


def _take(a, idx):
    return torch.gather(a, 1, idx)


def rounds_plain(ro: Dict, carry: Dict) -> Dict:
    """Every round of one ``_run_rounds`` call: ``_run_kernel(ro, carry)``
    of ``repro/core/jaxsim.py:352-356`` on torch tensors (float64 /
    int64, ``active`` bool or 0/1), returning a new carry (the inputs are
    not written)."""
    c = {k: v.clone() for k, v in carry.items()}
    c["active"] = c["active"].bool()
    while bool(c["active"].any()):
        _round_body(ro, c)
    return c


def _round_body(ro, c):
    """One engine iteration on every active lane, in place on ``c``: the
    phases and association order of ``_round_body`` (``jaxsim.py:78-349``);
    the reference's drop-sink writes are masked writes here."""
    L, S = c["res_gid"].shape
    Q = c["q"].shape[1]
    dev = c["res_gid"].device
    iota_l = torch.arange(L, device=dev)
    iota_s = torch.arange(S, device=dev)
    iota_q = torch.arange(Q, device=dev)
    active = c["active"]
    clock0 = c["clock"].clone()
    rts0 = c["rts"].clone()
    res_gid, st, q = c["res_gid"], c["s_state"], c["q"]
    prompt, dtotal = ro["prompt"], ro["dtotal"]
    pref_c, dec_c = c["a_prefilled"], c["a_decoded"]

    # -- admission: one request per lane if a slot is free --------------
    can = active & (c["res_cnt"] < ro["nslots"]) & (c["qcnt"] > 0)
    budget = ro["cap"] - rts0
    valid = iota_q[None, :] < c["qcnt"][:, None]
    gq = torch.where(valid, q, 0)
    adm_cost = prompt[gq] + dec_c[gq]
    fit = valid & (adm_cost <= budget[:, None])
    any_fit = fit.any(1)
    pick_fcfs = torch.where(fit[:, 0], 0, -1)
    size = torch.where(fit, prompt[gq] + dtotal[gq], -1)
    pick_bin = torch.where(any_fit, torch.argmax(size, 1), -1)
    work = torch.where(fit, dtotal[gq], BIG)
    pick_lwl = torch.where(any_fit, torch.argmin(work, 1), -1)
    sched = ro["sched"]
    pick = torch.where(sched == SCHED_FCFS, pick_fcfs,
                       torch.where(sched == SCHED_BIN, pick_bin, pick_lwl))
    admit = can & (pick >= 0)
    pick_s = torch.clamp(pick, min=0)
    gid_adm = _take(q, pick_s[:, None])[:, 0]
    gid_safe = torch.where(admit, gid_adm, 0)
    keep = torch.clamp(iota_q[None, :] + (iota_q[None, :] >= pick_s[:, None]),
                       max=Q - 1)
    c["q"] = q = torch.where(admit[:, None], _take(q, keep), q)
    c["qcnt"] = c["qcnt"] - admit.long()
    c["qps"] = c["qps"] - prompt[gid_safe] * admit
    seq = c["admit_ctr"].clone()
    g_adm = gid_adm[admit]
    c["a_admit_seq"][g_adm] = seq[admit]
    c["admit_ctr"] = c["admit_ctr"] + admit.long()
    c["a_phase"][g_adm] = PH_PREFILL
    col = torch.argmax((res_gid == -1).long(), 1)
    rows, cols = iota_l[admit], col[admit]
    for name, val in (("res_gid", gid_adm), ("s_state", SS_PREFILL),
                      ("s_prompt", prompt[gid_safe]),
                      ("s_dtotal", dtotal[gid_safe]),
                      ("s_prefilled", pref_c[gid_safe]),
                      ("s_decoded", dec_c[gid_safe]), ("s_admit", seq),
                      ("s_first", c["a_first_tok"][gid_safe]),
                      ("s_pfdone", c["a_prefill_done"][gid_safe]),
                      ("s_invd", ro["inv_d"][gid_safe]),
                      ("s_invt", ro["inv_t"][gid_safe]),
                      ("s_capat", ro["capat"][gid_safe])):
        c[name][rows, cols] = (val[admit] if torch.is_tensor(val)
                               else val)
    c["res_cnt"] = c["res_cnt"] + admit.long()
    c["pref_cnt"] = c["pref_cnt"] + admit.long()

    act2 = active[:, None]
    s_prompt, s_dtotal = c["s_prompt"], c["s_dtotal"]
    s_invd, s_invt, s_capat = c["s_invd"], c["s_invt"], c["s_capat"]
    # -- prefill progress (full, or one chunk per iteration) ------------
    pref = (st == SS_PREFILL) & act2
    rem = (s_prompt - c["s_prefilled"]) * pref
    step = torch.minimum(ro["chunk"][:, None], rem) * pref
    aseq = c["s_admit"] + (~pref).long() * BIG
    firstc = torch.argmin(aseq, 1)
    ustep = torch.zeros_like(step)
    ustep[iota_l, firstc] = torch.where(pref.any(1), rem[iota_l, firstc], 0)
    step = torch.where((ro["chunk"] == 0)[:, None], ustep, step)
    c["s_prefilled"] = s_prefilled = c["s_prefilled"] + step
    prefill_tokens = step.sum(1)
    fin_pref = pref & (s_prefilled >= s_prompt)
    st[fin_pref] = SS_DECODE
    c["s_pfdone"] = torch.where(fin_pref, clock0[:, None], c["s_pfdone"])
    c["pref_cnt"] = c["pref_cnt"] - fin_pref.sum(1)
    c["lane_ivv"] = c["lane_ivv"] + (s_invd * s_invt * fin_pref).sum(1)
    c["outst"] = c["outst"] - prefill_tokens

    # -- iteration time + spikes (the numpy stepper's association order:
    # every product and sum a separate op) ------------------------------
    it_time = ((ro["tdec"] + ro["grad1"] * prefill_tokens)
               + ro["grad2"] * rts0
               + ro["tpre"] * (prefill_tokens > 0)) * ro["speed"]
    spike = active & (it_time > 2.0 * ro["tdec"] * ro["speed"])
    c["spike_cnt"] = c["spike_cnt"] + spike.long()
    clock1 = clock0 + it_time
    c["clock"] = torch.where(active, clock1, clock0)
    rts1 = rts0 + prefill_tokens

    # -- gang decode + backlog T accrual --------------------------------
    dec = (st == SS_DECODE) & act2
    per_lane = dec.sum(1)
    c["s_decoded"] = s_decoded = c["s_decoded"] + dec.long()
    fresh = dec & torch.isnan(c["s_first"])
    c["s_first"] = s_first = torch.where(fresh, clock1[:, None],
                                         c["s_first"])
    rts2 = rts1 + per_lane
    c["outst"] = c["outst"] - per_lane
    lane_ep = ro["lane_ep"]
    E = c["bk_t"].shape[0]

    def seg(x):
        return torch.zeros(E, dtype=x.dtype, device=dev).index_add_(
            0, lane_ep, x)

    delta = c["lane_ivv"] * active
    bk_t = c["bk_t"] + seg(delta)
    b_all = torch.floor((clock0 - ro["span_t0"])
                        / ro["ep_dt_lane"]).long() + 1
    b_all = torch.minimum(torch.clamp(b_all, min=1), ro["lane_k"])
    d_lane = c["d_lane"]
    d_lane[iota_l, b_all] += delta
    crossed = dec & (s_decoded == s_capat)
    full_tok = s_invd * s_invt
    part = (1.0 - (s_capat - 1) * s_invd) * s_invt
    corr_lane = ((part - full_tok) * crossed).sum(1)
    bk_t = bk_t + seg(corr_lane)
    lane_ivv = c["lane_ivv"] - (full_tok * crossed).sum(1)
    d_lane[iota_l, b_all] += corr_lane

    # -- completions ----------------------------------------------------
    fin = dec & (s_decoded >= s_dtotal)
    g_fin = res_gid[fin]
    c["a_phase"][g_fin] = PH_DONE
    c["a_finished"][g_fin] = clock1[:, None].expand(L, S)[fin]
    pref_c[g_fin] = s_prefilled[fin]
    dec_c[g_fin] = s_decoded[fin]
    c["a_first_tok"][g_fin] = s_first[fin]
    c["a_nemit"][g_fin] += s_decoded[fin]
    c["a_prefill_done"][g_fin] = c["s_pfdone"][fin]
    c["done_round"][g_fin] = c["round_no"]
    c["done_col"][g_fin] = iota_s[None, :].expand(L, S)[fin]
    drop_sum = ((s_prefilled + s_decoded) * fin).sum(1)
    rts = torch.where(active, rts2 - drop_sum, rts0)
    res_cnt = c["res_cnt"] - fin.sum(1)
    prog = torch.clamp(s_decoded * s_invd, max=1.0) * s_invt
    c["bk_s"] = c["bk_s"] - seg((s_invt * fin).sum(1))
    bk_t = bk_t - seg((prog * fin).sum(1))
    d_lane[iota_l, b_all] += ((s_invt - prog) * fin).sum(1)
    uncap = fin & (s_decoded < s_capat)
    lane_ivv = lane_ivv - (s_invd * s_invt * uncap).sum(1)
    res_gid[fin] = -1
    st[fin] = SS_EMPTY

    # -- capacity enforcement: evict newest-admitted (the reference's
    # closed form: the smallest newest-first prefix that brings rts
    # within cap, at most res_cnt - 1) ---------------------------------
    cap = ro["cap"]
    over = (rts > cap) & active & (res_cnt > 1)
    occ = res_gid >= 0
    keys = torch.where(occ, c["s_admit"], -1)
    order = torch.argsort(-keys, dim=1, stable=True)
    g_sorted = _take(res_gid, order)
    prog_mat = s_prefilled + s_decoded
    prog_sorted = _take(prog_mat, order) * (g_sorted >= 0)
    csum = torch.cumsum(prog_sorted, 1)
    ok = (rts[:, None] - csum) <= cap[:, None]
    k_fit = torch.where(ok.any(1), torch.argmax(ok.long(), 1) + 1, S)
    k = torch.where(over, torch.minimum(k_fit, res_cnt - 1), 0)
    evict_sorted = iota_s[None, :] < k[:, None]
    evict = torch.zeros((L, S), dtype=torch.bool,
                        device=dev).scatter(1, order, evict_sorted)
    g_ev = res_gid[evict]
    pref_c[g_ev] = 0
    dec_c[g_ev] = 0
    c["a_first_tok"][g_ev] = s_first[evict]
    c["a_nemit"][g_ev] += s_decoded[evict]
    c["a_prefill_done"][g_ev] = c["s_pfdone"][evict]
    c["a_phase"][g_ev] = PH_PREEMPTED
    c["a_preempts"][g_ev] += 1
    debit_lane = (torch.clamp(s_decoded * s_invd, max=1.0) * s_invt
                  * (evict & (s_decoded > 0))).sum(1)
    c["bk_t"] = bk_t - seg(debit_lane)
    d_lane[iota_l, b_all] += -debit_lane
    c["lane_ivv"] = lane_ivv - (s_invd * s_invt
                                * (evict & (st == SS_DECODE)
                                   & (s_decoded < s_capat))).sum(1)
    c["pref_cnt"] = c["pref_cnt"] - (evict & (st == SS_PREFILL)).sum(1)
    prog_ev = (prog_mat * evict).sum(1)
    c["rts"] = rts - prog_ev
    c["qps"] = c["qps"] + (s_prompt * evict).sum(1)
    c["outst"] = c["outst"] + prog_ev
    c["res_cnt"] = res_cnt - k
    res_gid[evict] = -1
    st[evict] = SS_EMPTY
    # requeue in ascending admit order at the queue front
    idx_rev = torch.clamp(k[:, None] - 1 - iota_s[None, :], 0, S - 1)
    ev_asc = _take(g_sorted, idx_rev)
    evq = _take(ev_asc, torch.clamp(iota_q, max=S - 1)[None, :].expand(L, Q))
    tail = _take(q, torch.clamp(iota_q[None, :] - k[:, None], 0, Q - 1))
    c["q"] = torch.where((k > 0)[:, None],
                         torch.where(iota_q[None, :] < k[:, None], evq,
                                     tail), q)
    c["qcnt"] = c["qcnt"] + k

    # -- loop bookkeeping -----------------------------------------------
    active = active & (c["clock"] < ro["target"])
    dry = active & ~((c["res_cnt"] > 0) | (c["qcnt"] > 0))
    c["clock"] = torch.where(dry, ro["target"], c["clock"])
    c["active"] = active & ~dry
    c["round_no"] = c["round_no"] + 1


def sim_rounds_plain(layout: Layout, fblock: torch.Tensor,
                     iblock: torch.Tensor):
    """:func:`rounds_plain` on a packed call, in place on the blocks, on
    whatever device they lie (the kernel's yardstick on the card)."""
    v = layout.views(fblock, iblock)
    v["d_lane"].zero_()                  # the kernel zeroes its own rows
    out = rounds_plain({k: v[k] for k in RO_KEYS},
                       layout.carry_out(fblock, iblock))
    for name, val in out.items():
        v[name].copy_(val)


def sim_rounds(layout: Layout, fblock: torch.Tensor, iblock: torch.Tensor):
    """Run one packed ``_run_rounds`` call in place on the blocks (float64
    and int64, contiguous, on one device): the carry fields take the
    result, ``d_lane`` the span buckets.  CPU blocks go through
    :func:`rounds_plain`; CUDA blocks launch the kernel."""
    if fblock.device != iblock.device:
        raise ValueError(f"sim_rounds: blocks on {fblock.device} and "
                         f"{iblock.device}")
    if (fblock.dtype != torch.float64 or iblock.dtype != torch.int64
            or not fblock.is_contiguous() or not iblock.is_contiguous()
            or fblock.dim() != 1 or iblock.dim() != 1):
        raise ValueError("sim_rounds: blocks must be contiguous 1-d "
                         "float64 and int64 tensors")
    if fblock.numel() < layout.n_f or iblock.numel() < layout.n_i:
        raise ValueError(f"sim_rounds: blocks of {fblock.numel()} / "
                         f"{iblock.numel()} elements, the layout needs "
                         f"{layout.n_f} / {layout.n_i}")
    if fblock.device.type == "cpu":
        sim_rounds_plain(layout, fblock, iblock)
        return
    if fblock.device.type != "cuda":
        raise ValueError(f"sim_rounds: no kernel for device "
                         f"{fblock.device}")
    L, S, Q, C, E, W = (layout.L, layout.S, layout.Q, layout.C, layout.E,
                        layout.W)
    if min(L, S, Q, C, E, W) <= 0:
        raise ValueError(f"sim_rounds: shapes L={L} S={S} Q={Q} C={C} "
                         f"E={E} W={W}")
    stream = torch.cuda.current_stream(fblock.device).cuda_stream
    err = build.library().repro_sim_rounds(
        fblock.data_ptr(), iblock.data_ptr(),
        layout.table.ctypes.data_as(ctypes.c_void_p), L, S, Q, E, W,
        THREADS, stream)
    build.check(err, "sim_rounds")
    global launches
    launches += 1


def staged_bytes(layout: Layout) -> int:
    """The bytes a call reads once and writes once: both blocks in
    (read-only + carry) and out (carry + kernel-only)."""
    return 8 * (layout.f_in + layout.i_in + (layout.n_f - layout.f_back)
                + (layout.n_i - layout.i_back))
