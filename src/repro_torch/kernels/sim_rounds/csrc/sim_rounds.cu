// The device-resident simulator's round loop on Hopper (sm_90a).
//
// Replaces no Pallas kernel: it stands for the XLA program of the
// reference's jitted ``lax.while_loop`` (``src/repro/core/jaxsim.py``,
// ``_run_kernel`` at :352-356 over ``_round_body`` at :78-349), which runs
// every round of one ``_run_rounds`` call on the accelerator.  One thread
// a lane runs its own ``while (active)`` loop over the round body in the
// reference's phase order: admission with the scheduler's pick, prefill
// progress (chunked, or the first by admission), the iteration time and
// its spike, gang decode with the backlog accrual, completions, the
// newest-first preemption in closed form with the requeue at the queue's
// front, and the dry-lane jump.  Lanes share nothing inside a round but
// the per-episode backlog sums, so a lane's rounds never wait on another
// lane's: a lane that goes inactive stays so, and its own round count is
// the reference's global ``round_no``.  Arena rows are touched only by the
// thread of the lane that owns the request (queued or resident), so there
// are no races.  The backlog sums are per-lane accumulators here, summed
// per episode in ascending lane order by a second launch: no atomics, and
// a repeat is bit-equal.
//
// State lives in global memory, packed by the wrapper into one float64
// and one int64 block (``ops.py``'s ``F64_FIELDS`` / ``I64_FIELDS``; the
// enums below follow that order), with a host table of each field's
// offset.  Every float product and sum is written with ``__dmul_rn`` /
// ``__dadd_rn`` / ``__dsub_rn`` / ``__ddiv_rn`` in the reference's
// association order: nvcc contracts ``a * b + c`` into an FMA by default,
// which would round once where numpy rounds twice and drift the clock by
// an ulp.
//
// Bound: the latency of each round's dependent loads and branches, one
// thread a lane (the work is a few hundred operations a lane a round; the
// bytes are the staged blocks, read and written once).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum F64Field {
  F_TARGET, F_CAP, F_GRAD1, F_GRAD2, F_TDEC, F_TPRE, F_SPEED, F_EP_DT,
  F_SPAN_T0, F_INV_D, F_INV_T,
  F_CLOCK, F_RTS, F_QPS, F_OUTST, F_LANE_IVV, F_BK_S, F_BK_T, F_S_FIRST,
  F_S_PFDONE, F_S_INVD, F_S_INVT, F_A_FIRST_TOK, F_A_PREFILL_DONE,
  F_A_FINISHED,
  F_D_LANE, F_ACC_S, F_ACC_T,
  F_COUNT
};

enum I64Field {
  I_NSLOTS, I_CHUNK, I_SCHED, I_LANE_EP, I_LANE_K, I_PROMPT, I_DTOTAL,
  I_CAPAT, I_EP_PTR, I_EP_LANES,
  I_ACTIVE, I_ADMIT_CTR, I_RES_CNT, I_PREF_CNT, I_QCNT, I_SPIKE_CNT, I_Q,
  I_RES_GID, I_S_STATE, I_S_PROMPT, I_S_DTOTAL, I_S_PREFILLED, I_S_DECODED,
  I_S_ADMIT, I_S_CAPAT, I_A_PREFILLED, I_A_DECODED, I_A_ADMIT_SEQ,
  I_A_PHASE, I_A_PREEMPTS, I_A_NEMIT, I_DONE_ROUND, I_DONE_COL, I_ROUND_NO,
  I_LANE_ROUNDS,
  I_COUNT
};

// slot states, arena phases and scheduler codes (core/vecsim.py)
constexpr int64_t kEmpty = 0, kPrefill = 1, kDecode = 2;
constexpr int64_t kPhPrefill = 2, kPhPreempted = 4, kPhDone = 5;
constexpr int64_t kFcfs = 0, kBin = 1;
constexpr int64_t kBig = int64_t(1) << 62;
// an evicted slot's state while its lane settles the eviction
constexpr int64_t kEvicted = 8;

struct Blocks {
  double* f[F_COUNT];
  int64_t* i[I_COUNT];
  int L, S, Q, E, W;
};

__device__ __forceinline__ double i2d(int64_t x) { return (double)x; }

__global__ void __launch_bounds__(32) sim_rounds_kernel(Blocks b) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= b.L) return;
  const int S = b.S, Q = b.Q, W = b.W;
  double* dl = b.f[F_D_LANE] + (size_t)l * W;
  for (int j = 0; j < W; ++j) dl[j] = 0.0;
  double acc_s = 0.0, acc_t = 0.0;
  int64_t rounds = 0;
  bool active = b.i[I_ACTIVE][l] != 0;
  if (active) {
    // lane constants
    const double target = b.f[F_TARGET][l], cap = b.f[F_CAP][l];
    const double grad1 = b.f[F_GRAD1][l], grad2 = b.f[F_GRAD2][l];
    const double tdec = b.f[F_TDEC][l], tpre = b.f[F_TPRE][l];
    const double speed = b.f[F_SPEED][l], ep_dt = b.f[F_EP_DT][l];
    const double span_t0 = b.f[F_SPAN_T0][l];
    const int64_t nslots = b.i[I_NSLOTS][l], chunk = b.i[I_CHUNK][l];
    const int64_t sched = b.i[I_SCHED][l], lane_k = b.i[I_LANE_K][l];
    const double spike_at = __dmul_rn(__dmul_rn(2.0, tdec), speed);
    // the arena (compacted candidate rows) and this lane's rows
    const int64_t* prompt = b.i[I_PROMPT];
    const int64_t* dtotal = b.i[I_DTOTAL];
    const int64_t* capat = b.i[I_CAPAT];
    const double* inv_d = b.f[F_INV_D];
    const double* inv_t = b.f[F_INV_T];
    double* a_first = b.f[F_A_FIRST_TOK];
    double* a_pfd = b.f[F_A_PREFILL_DONE];
    double* a_fin = b.f[F_A_FINISHED];
    int64_t* a_pref = b.i[I_A_PREFILLED];
    int64_t* a_dec = b.i[I_A_DECODED];
    int64_t* a_seq = b.i[I_A_ADMIT_SEQ];
    int64_t* a_phase = b.i[I_A_PHASE];
    int64_t* a_preempts = b.i[I_A_PREEMPTS];
    int64_t* a_nemit = b.i[I_A_NEMIT];
    int64_t* done_round = b.i[I_DONE_ROUND];
    int64_t* done_col = b.i[I_DONE_COL];
    const size_t rs = (size_t)l * S;
    int64_t* q = b.i[I_Q] + (size_t)l * Q;
    int64_t* res_gid = b.i[I_RES_GID] + rs;
    int64_t* st = b.i[I_S_STATE] + rs;
    int64_t* s_prompt = b.i[I_S_PROMPT] + rs;
    int64_t* s_dtotal = b.i[I_S_DTOTAL] + rs;
    int64_t* s_pref = b.i[I_S_PREFILLED] + rs;
    int64_t* s_dec = b.i[I_S_DECODED] + rs;
    int64_t* s_admit = b.i[I_S_ADMIT] + rs;
    int64_t* s_capat = b.i[I_S_CAPAT] + rs;
    double* s_first = b.f[F_S_FIRST] + rs;
    double* s_pfdone = b.f[F_S_PFDONE] + rs;
    double* s_invd = b.f[F_S_INVD] + rs;
    double* s_invt = b.f[F_S_INVT] + rs;
    // lane carry
    double clock = b.f[F_CLOCK][l], rts = b.f[F_RTS][l];
    double qps = b.f[F_QPS][l], outst = b.f[F_OUTST][l];
    double lane_ivv = b.f[F_LANE_IVV][l];
    int64_t admit_ctr = b.i[I_ADMIT_CTR][l], res_cnt = b.i[I_RES_CNT][l];
    int64_t pref_cnt = b.i[I_PREF_CNT][l], qcnt = b.i[I_QCNT][l];
    int64_t spike_cnt = b.i[I_SPIKE_CNT][l];
    const int64_t round0 = b.i[I_ROUND_NO][0];

    while (active) {
      const double clock0 = clock, rts0 = rts;
      // -- admission: one request a lane if a slot is free ------------
      int pick = -1;
      if (res_cnt < nslots && qcnt > 0) {
        const double budget = __dsub_rn(cap, rts0);
        int64_t best = 0;
        for (int j = 0; j < qcnt; ++j) {
          const int64_t g = q[j];
          const bool fit = i2d(prompt[g] + a_dec[g]) <= budget;
          if (sched == kFcfs) {         // the head, or nothing
            pick = fit ? 0 : -1;
            break;
          }
          if (!fit) continue;
          if (sched == kBin) {          // the first largest
            const int64_t size = prompt[g] + dtotal[g];
            if (pick < 0 || size > best) { pick = j; best = size; }
          } else {                      // the first least work left
            if (pick < 0 || dtotal[g] < best) { pick = j; best = dtotal[g]; }
          }
        }
      }
      const bool admit = pick >= 0;
      const int64_t gid = admit ? q[pick] : 0;
      if (admit) {
        // logical-order removal; the last position keeps its value
        for (int j = pick; j < Q - 1; ++j) q[j] = q[j + 1];
        qcnt -= 1;
      }
      qps = __dsub_rn(qps, i2d(admit ? prompt[gid] : 0));
      if (admit) {
        const int64_t seq = admit_ctr;
        a_seq[gid] = seq;
        admit_ctr += 1;
        a_phase[gid] = kPhPrefill;
        int col = 0;                    // first-fit slot insert
        for (int j = 0; j < S; ++j) {
          if (res_gid[j] == -1) { col = j; break; }
        }
        res_gid[col] = gid;
        st[col] = kPrefill;
        s_prompt[col] = prompt[gid];
        s_dtotal[col] = dtotal[gid];
        s_pref[col] = a_pref[gid];
        s_dec[col] = a_dec[gid];
        s_admit[col] = seq;
        s_first[col] = a_first[gid];
        s_pfdone[col] = a_pfd[gid];
        s_invd[col] = inv_d[gid];
        s_invt[col] = inv_t[gid];
        s_capat[col] = capat[gid];
        res_cnt += 1;
        pref_cnt += 1;
      }

      // -- prefill progress (full, or one chunk an iteration) ---------
      int64_t prefill_tokens = 0;
      if (chunk != 0) {
        for (int j = 0; j < S; ++j) {
          if (st[j] != kPrefill) continue;
          const int64_t rem = s_prompt[j] - s_pref[j];
          const int64_t step = chunk < rem ? chunk : rem;
          s_pref[j] += step;
          prefill_tokens += step;
        }
      } else {
        // only the first (by admission) prefilling resident runs, for
        // its whole remaining prompt
        int first = 0;
        int64_t key = 0;
        bool any = false;
        for (int j = 0; j < S; ++j) {
          const bool p = st[j] == kPrefill;
          const int64_t k = s_admit[j] + (p ? 0 : kBig);
          if (j == 0 || k < key) { key = k; first = j; }
          any = any || p;
        }
        if (any) {
          const int64_t rem = s_prompt[first] - s_pref[first];
          s_pref[first] += rem;
          prefill_tokens = rem;
        }
      }
      double ivv_add = 0.0;
      for (int j = 0; j < S; ++j) {
        if (st[j] == kPrefill && s_pref[j] >= s_prompt[j]) {
          st[j] = kDecode;
          s_pfdone[j] = clock0;
          pref_cnt -= 1;
          ivv_add = __dadd_rn(ivv_add, __dmul_rn(s_invd[j], s_invt[j]));
        }
      }
      lane_ivv = __dadd_rn(lane_ivv, ivv_add);
      outst = __dsub_rn(outst, i2d(prefill_tokens));

      // -- iteration time + spikes, in the numpy stepper's order ------
      const double pt = i2d(prefill_tokens);
      double it = __dadd_rn(tdec, __dmul_rn(grad1, pt));
      it = __dadd_rn(it, __dmul_rn(grad2, rts0));
      it = __dadd_rn(it, __dmul_rn(tpre, prefill_tokens > 0 ? 1.0 : 0.0));
      const double it_time = __dmul_rn(it, speed);
      if (it_time > spike_at) spike_cnt += 1;
      const double clock1 = __dadd_rn(clock0, it_time);
      clock = clock1;
      const double rts1 = __dadd_rn(rts0, pt);

      // -- gang decode + backlog T accrual ----------------------------
      int64_t per_lane = 0;
      for (int j = 0; j < S; ++j) {
        if (st[j] != kDecode) continue;
        s_dec[j] += 1;
        per_lane += 1;
        if (isnan(s_first[j])) s_first[j] = clock1;
      }
      const double rts2 = __dadd_rn(rts1, i2d(per_lane));
      outst = __dsub_rn(outst, i2d(per_lane));
      const double delta = lane_ivv;
      acc_t = __dadd_rn(acc_t, delta);
      // the span bucket of this iteration's start, min(max(b, 1), lane_k)
      int64_t bk = (int64_t)floor(__ddiv_rn(__dsub_rn(clock0, span_t0),
                                            ep_dt)) + 1;
      bk = bk < 1 ? 1 : bk;
      bk = bk < lane_k ? bk : lane_k;
      dl[bk] = __dadd_rn(dl[bk], delta);
      double corr = 0.0, cross_tok = 0.0;
      for (int j = 0; j < S; ++j) {
        if (st[j] != kDecode || s_dec[j] != s_capat[j]) continue;
        const double full = __dmul_rn(s_invd[j], s_invt[j]);
        const double part = __dmul_rn(
            __dsub_rn(1.0, __dmul_rn(i2d(s_capat[j] - 1), s_invd[j])),
            s_invt[j]);
        corr = __dadd_rn(corr, __dsub_rn(part, full));
        cross_tok = __dadd_rn(cross_tok, full);
      }
      acc_t = __dadd_rn(acc_t, corr);
      lane_ivv = __dsub_rn(lane_ivv, cross_tok);
      dl[bk] = __dadd_rn(dl[bk], corr);

      // -- completions ------------------------------------------------
      int64_t drop_sum = 0, nfin = 0;
      double fin_s = 0.0, fin_prog = 0.0, fin_rest = 0.0, fin_unc = 0.0;
      for (int j = 0; j < S; ++j) {
        if (st[j] != kDecode || s_dec[j] < s_dtotal[j]) continue;
        const int64_t g = res_gid[j];
        a_phase[g] = kPhDone;
        a_fin[g] = clock1;
        a_pref[g] = s_pref[j];
        a_dec[g] = s_dec[j];
        a_first[g] = s_first[j];
        a_nemit[g] += s_dec[j];
        a_pfd[g] = s_pfdone[j];
        done_round[g] = round0 + rounds;
        done_col[g] = j;
        drop_sum += s_pref[j] + s_dec[j];
        nfin += 1;
        const double prog = __dmul_rn(
            fmin(__dmul_rn(i2d(s_dec[j]), s_invd[j]), 1.0), s_invt[j]);
        fin_s = __dadd_rn(fin_s, s_invt[j]);
        fin_prog = __dadd_rn(fin_prog, prog);
        fin_rest = __dadd_rn(fin_rest, __dsub_rn(s_invt[j], prog));
        if (s_dec[j] < s_capat[j]) {
          fin_unc = __dadd_rn(fin_unc, __dmul_rn(s_invd[j], s_invt[j]));
        }
        res_gid[j] = -1;
        st[j] = kEmpty;
      }
      rts = __dsub_rn(rts2, i2d(drop_sum));
      res_cnt -= nfin;
      acc_s = __dsub_rn(acc_s, fin_s);
      acc_t = __dsub_rn(acc_t, fin_prog);
      dl[bk] = __dadd_rn(dl[bk], fin_rest);
      lane_ivv = __dsub_rn(lane_ivv, fin_unc);

      // -- capacity enforcement: evict newest-admitted ----------------
      // the smallest newest-first prefix whose progress brings rts within
      // cap, at most res_cnt - 1 (the oldest resident is never evicted);
      // integer-valued sums, so they equal the sequential loop's
      int64_t k = 0, prog_ev = 0, prompt_ev = 0;
      double debit = 0.0, ev_unc = 0.0;
      if (rts > cap && res_cnt > 1) {
        int64_t csum = 0, last = INT64_MAX;
        while (k < res_cnt - 1) {
          int c = -1;
          for (int j = 0; j < S; ++j) {  // the next newest resident
            if (res_gid[j] >= 0 && st[j] < kEvicted && s_admit[j] < last &&
                (c < 0 || s_admit[j] > s_admit[c])) {
              c = j;
            }
          }
          if (c < 0) break;             // res_cnt counts the residents
          last = s_admit[c];
          csum += s_pref[c] + s_dec[c];
          st[c] += kEvicted;
          k += 1;
          if (__dsub_rn(rts, i2d(csum)) <= cap) break;
        }
        // settle the evictions in slot order (the reference's sums run
        // over columns), requeue in ascending admit order at the front
        for (int j = Q - 1; j >= k; --j) q[j] = q[j - k];
        for (int j = 0; j < S; ++j) {
          if (st[j] < kEvicted) continue;
          const int64_t orig = st[j] - kEvicted;
          const int64_t g = res_gid[j];
          a_pref[g] = 0;
          a_dec[g] = 0;
          a_first[g] = s_first[j];
          a_nemit[g] += s_dec[j];
          a_pfd[g] = s_pfdone[j];
          a_phase[g] = kPhPreempted;
          a_preempts[g] += 1;
          if (s_dec[j] > 0) {
            debit = __dadd_rn(debit, __dmul_rn(
                fmin(__dmul_rn(i2d(s_dec[j]), s_invd[j]), 1.0), s_invt[j]));
          }
          if (orig == kDecode && s_dec[j] < s_capat[j]) {
            ev_unc = __dadd_rn(ev_unc, __dmul_rn(s_invd[j], s_invt[j]));
          }
          if (orig == kPrefill) pref_cnt -= 1;
          prog_ev += s_pref[j] + s_dec[j];
          prompt_ev += s_prompt[j];
          int rank = 0;                 // older evicted residents
          for (int i = 0; i < S; ++i) {
            rank += st[i] >= kEvicted && s_admit[i] < s_admit[j];
          }
          q[rank] = g;
        }
        for (int j = 0; j < S; ++j) {
          if (st[j] >= kEvicted) {
            res_gid[j] = -1;
            st[j] = kEmpty;
          }
        }
      }
      acc_t = __dsub_rn(acc_t, debit);
      dl[bk] = __dadd_rn(dl[bk], -debit);
      lane_ivv = __dsub_rn(lane_ivv, ev_unc);
      rts = __dsub_rn(rts, i2d(prog_ev));
      qps = __dadd_rn(qps, i2d(prompt_ev));
      outst = __dadd_rn(outst, i2d(prog_ev));
      res_cnt -= k;
      qcnt += k;

      // -- loop bookkeeping -------------------------------------------
      rounds += 1;
      active = clock < target;
      if (active && !(res_cnt > 0 || qcnt > 0)) {
        clock = target;
        active = false;
      }
    }
    b.f[F_CLOCK][l] = clock;
    b.f[F_RTS][l] = rts;
    b.f[F_QPS][l] = qps;
    b.f[F_OUTST][l] = outst;
    b.f[F_LANE_IVV][l] = lane_ivv;
    b.i[I_ADMIT_CTR][l] = admit_ctr;
    b.i[I_RES_CNT][l] = res_cnt;
    b.i[I_PREF_CNT][l] = pref_cnt;
    b.i[I_QCNT][l] = qcnt;
    b.i[I_SPIKE_CNT][l] = spike_cnt;
  }
  b.i[I_ACTIVE][l] = 0;
  b.f[F_ACC_S][l] = acc_s;
  b.f[F_ACC_T][l] = acc_t;
  b.i[I_LANE_ROUNDS][l] = rounds;
}

// The per-episode backlog sums, each episode's lanes in ascending order,
// and the rounds the call ran (the most any lane ran).
__global__ void sim_episode_sums_kernel(Blocks b) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < b.E) {
    const int64_t* ptr = b.i[I_EP_PTR];
    const int64_t* lanes = b.i[I_EP_LANES];
    double s = b.f[F_BK_S][e], t = b.f[F_BK_T][e];
    for (int64_t p = ptr[e]; p < ptr[e + 1]; ++p) {
      const int64_t l = lanes[p];
      s = __dadd_rn(s, b.f[F_ACC_S][l]);
      t = __dadd_rn(t, b.f[F_ACC_T][l]);
    }
    b.f[F_BK_S][e] = s;
    b.f[F_BK_T][e] = t;
  }
  if (e == 0) {
    int64_t most = 0;
    for (int l = 0; l < b.L; ++l) {
      const int64_t r = b.i[I_LANE_ROUNDS][l];
      most = r > most ? r : most;
    }
    b.i[I_ROUND_NO][0] += most;
  }
}

}  // namespace

// f: the float64 block, i: the int64 block (device); offsets: a HOST
// array of F_COUNT + I_COUNT element offsets, the float fields' first;
// threads: lanes a block of the round kernel (32).  Two launches on one
// stream: the rounds, then the per-episode sums.
extern "C" int repro_sim_rounds(void* f, void* i, const void* offsets,
                                int L, int S, int Q, int E, int W,
                                int threads, void* stream) {
  if (L <= 0 || S <= 0 || Q <= 0 || E <= 0 || W <= 0 || threads != 32) {
    return cudaErrorInvalidValue;
  }
  const int64_t* off = static_cast<const int64_t*>(offsets);
  Blocks b;
  for (int k = 0; k < F_COUNT; ++k) {
    b.f[k] = static_cast<double*>(f) + off[k];
  }
  for (int k = 0; k < I_COUNT; ++k) {
    b.i[k] = static_cast<int64_t*>(i) + off[F_COUNT + k];
  }
  b.L = L;
  b.S = S;
  b.Q = Q;
  b.E = E;
  b.W = W;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sim_rounds_kernel<<<(L + threads - 1) / threads, threads, 0, st>>>(b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int et = 128;
  sim_episode_sums_kernel<<<(E + et - 1) / et, et, 0, st>>>(b);
  return (int)cudaGetLastError();
}
