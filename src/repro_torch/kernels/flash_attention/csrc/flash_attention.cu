// Causal GQA FlashAttention-2 forward for Hopper (sm_90a), plain C ABI.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py
//   flash_attention_kernel (body _fa_kernel), the Pallas TPU kernel; and,
//   for training, its gradient (the backward section below).
//
// What it computes: q [B,Sq,H,hd], k/v [B,Skv,KV,hd] (row-major,
// contiguous) -> o [B,Sq,H,hd] in q's dtype.  q-head h reads kv-head
// h / (H/KV); query row i sits at absolute position i + q_offset and sees
// keys j <= i + q_offset when causal.  f32 online softmax, f32
// accumulation, -1e30 as the mask value and max(l, 1e-20) as the
// denominator floor, as in the reference.
//
// Unlike the Pallas kernel, which asserts Sq % block_q == 0 and
// Skv % block_k == 0, both kernels here mask ragged tails themselves
// (query rows >= Sq are computed on zeros and never stored; keys >= Skv
// are loaded as zeros and masked), so the engine's batch-1 prefill takes
// any prompt length.
//
// What bounds it on this card: at the serving prefill shapes (qwen3-0.6b
// H=16, KV=8; llama-2-7b H=KV=32; hd=128, Sq of a few hundred to 1500)
// the causal work is about 2*Sq^2*H*hd FLOPs against a few MB of q/k/v,
// so the bound is the tensor cores' bf16 rate (989 TFLOP/s).
//
// fa_fwd_tc (bf16, every serving path), the FlashAttention-2 structure:
//  - one block of 4 warps per (b, q-head, 64-row q tile), 16 rows a warp;
//    the heaviest causal q tiles are launched first, so the last wave is
//    short;
//  - Q is copied once with cp.async into shared memory, then into mma
//    A-fragments with ldmatrix, and stays in registers for the sweep;
//  - K/V tiles of 64 keys go through a 2-stage cp.async (16-byte, .cg)
//    ring in dynamic shared memory: tile t+1 is in flight while tile t is
//    computed; keys >= Skv are zero-filled (src-size 0); rows of every
//    tile are XOR-swizzled in 16-byte chunks, so ldmatrix reads 8 rows
//    from 32 distinct banks;
//  - S = Q K^T with mma.sync m16n8k16 bf16 -> f32 (K fragments by
//    ldmatrix); the online softmax runs on the accumulator fragments in
//    registers (row max and sum over the 4 lanes of a quad), in base 2;
//  - O += P V: P is packed to bf16 A-fragments in registers, V comes
//    through ldmatrix.trans;
//  - only the diagonal tile and the ragged tail are masked; tiles wholly
//    past the causal limit are not loaded;
//  - the epilogue divides by max(l, 1e-20) and stores rows < Sq in bf16.
// P is rounded to bf16 before P V, where the Pallas kernel keeps it in
// f32 (its output is bf16 all the same).  wgmma, TMA and warp
// specialisation are the next redesign.
//
// With kLse (training) both forwards also write the row log-sum-exp of the
// scaled scores, lse [B, H, Sq] f32, which the backward recomputes P from;
// the serving instantiations (kLse false) are the code they were.
//
// fa_fwd (f32 only): an f32 product on the tensor cores would be TF32
// (about 3 digits), so f32 stays on the CUDA cores: one block per (b,
// q-head, 16-row q tile); K/V tiles of 32 keys are staged once in shared
// memory in f32 and shared by the 16 rows; the K tile is padded to hd+1
// floats a row so that lane j reading key j hits 32 distinct banks; the
// KV sweep stops at the causal limit of the tile's last row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kRows = 4;                 // query rows per warp
constexpr int kBlockQ = kWarps * kRows;  // 16 query rows per block
constexpr int kBlockK = 32;              // keys per tile: one per lane
constexpr unsigned kFull = 0xffffffffu;


__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int HD, bool kLse>
__global__ void __launch_bounds__(kWarps * 32)
    fa_fwd(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, int sq, int skv,
           int h, int kvh, int causal, int q_offset, float sm_scale,
           float* __restrict__ lse) {
  constexpr int E = HD / 32;  // output columns per lane: d = lane + 32*i
  __shared__ float qs[kBlockQ][HD];
  __shared__ float ks[kBlockK][HD + 1];
  __shared__ float vs[kBlockK][HD];

  const int n_qt = (sq + kBlockQ - 1) / kBlockQ;
  int bid = blockIdx.x;
  const int qt = bid % n_qt;
  bid /= n_qt;
  const int hi = bid % h;
  const int b = bid / h;
  const int kh = hi / (h / kvh);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = qt * kBlockQ;

  const long q_stride = (long)h * HD;    // between sequence positions
  const long kv_stride = (long)kvh * HD;
  const float* qb = q + (long)b * sq * q_stride + (long)hi * HD;
  const float* kb = k + (long)b * skv * kv_stride + (long)kh * HD;
  const float* vb = v + (long)b * skv * kv_stride + (long)kh * HD;

  for (int e = tid; e < kBlockQ * HD; e += kWarps * 32) {
    const int r = e / HD, d = e % HD, qp = q0 + r;
    qs[r][d] = qp < sq ? qb[qp * q_stride + d] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[r][i] = 0.f;
  }

  // last key any row of this tile may see
  const int last_q = min(q0 + kBlockQ, sq) - 1;
  const int kv_end = causal ? min(skv, last_q + q_offset + 1) : skv;

  for (int t0 = 0; t0 < kv_end; t0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int e = tid; e < kBlockK * HD; e += kWarps * 32) {
      const int j = e / HD, d = e % HD, key = t0 + j;
      const bool ok = key < skv;
      ks[j][d] = ok ? kb[key * kv_stride + d] : 0.f;
      vs[j][d] = ok ? vb[key * kv_stride + d] : 0.f;
    }
    __syncthreads();

    // scores: lane j owns key t0 + j for each of the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = ks[lane][d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] += qs[warp * kRows + r][d] * kd;
    }
    const int key = t0 + lane;
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r + q_offset;
      const bool ok = key < skv && (!causal || key <= qpos);
      const float sc = ok ? s[r] * sm_scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float alpha = expf(m[r] - m_new);
      p[r] = expf(sc - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[r][i] *= alpha;
    }
    // acc += p @ V: p[j] comes from lane j, V columns lane + 32*i
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vj[E];
#pragma unroll
      for (int i = 0; i < E; ++i) vj[i] = vs[j][lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < E; ++i) acc[r][i] += pj * vj[i];
      }
    }
  }

  float* ob = o + (long)b * sq * q_stride + (long)hi * HD;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    if (qp >= sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int i = 0; i < E; ++i)
      ob[qp * q_stride + lane + 32 * i] = acc[r][i] * inv;
    if constexpr (kLse) {
      if (lane == 0) lse[((long)b * h + hi) * sq + qp] = m[r] + logf(l[r]);
    }
  }
}

// -- fa_fwd_tc: bf16 on the tensor cores ------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcBlockQ = 16 * kTcWarps;  // 64 query rows, 16 per warp
constexpr int kTcBlockK = 64;             // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// element offset of 16-byte chunk `chunk` of row `row` in a [rows][HD]
// bf16 tile, XOR-swizzled so that one chunk of 8 consecutive rows (what
// ldmatrix reads at once) lies in 8 distinct groups of 4 banks
template <int HD>
__device__ __forceinline__ int tile_off(int row, int chunk) {
  if constexpr (HD >= 64) return row * HD + ((chunk ^ (row & 7)) << 3);
  return row * HD + ((chunk ^ ((row >> 1) & 3)) << 3);  // 4 chunks a row
}

// 16 bytes global -> shared; src-size 0 (ok false) writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c[16x8] += a[16x16] * b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Fragment layouts of mma m16n8k16 (g = lane / 4, t = lane % 4): A holds
// rows g and g+8, columns 2t, 2t+1 and 2t+8, 2t+9; B columns n = g, rows
// (k) 2t, 2t+1 and 2t+8, 2t+9; C rows g and g+8, columns 2t, 2t+1.
template <int HD, bool kLse>
__global__ void __launch_bounds__(kTcWarps * 32)
    fa_fwd_tc(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int sq, int skv, int h, int kvh,
              int causal, int q_offset, float scale_log2,
              float* __restrict__ lse) {
  constexpr int CPR = HD / 8;              // 16-byte chunks a row
  constexpr int KSTEPS = HD / 16;          // k-steps of Q K^T
  constexpr int NT = kTcBlockK / 8;        // 8-key column tiles of S
  constexpr int DT = HD / 8;               // 8-column tiles of O
  constexpr int TILE = kTcBlockK * HD;     // elements of a K or V tile
  extern __shared__ __align__(128) unsigned char fa_tc_smem[];
  __nv_bfloat16* sq_tile = reinterpret_cast<__nv_bfloat16*>(fa_tc_smem);
  __nv_bfloat16* sk = sq_tile + kTcBlockQ * HD;  // [2 stages][64][HD]
  __nv_bfloat16* sv = sk + 2 * TILE;             // [2 stages][64][HD]

  // heaviest q tiles (the last ones, under a causal mask) first
  const int n_qt = (sq + kTcBlockQ - 1) / kTcBlockQ;
  const int n_bh = gridDim.x / n_qt;  // B * H
  const int qt = n_qt - 1 - (int)blockIdx.x / n_bh;
  const int bh = (int)blockIdx.x % n_bh;
  const int hi = bh % h, b = bh / h;
  const int kh = hi / (h / kvh);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qt * kTcBlockQ;

  const long q_stride = (long)h * HD;  // between sequence positions
  const long kv_stride = (long)kvh * HD;
  const __nv_bfloat16* qb = q + (long)b * sq * q_stride + (long)hi * HD;
  const __nv_bfloat16* kb = k + (long)b * skv * kv_stride + (long)kh * HD;
  const __nv_bfloat16* vb = v + (long)b * skv * kv_stride + (long)kh * HD;

  // last key any row of this tile may see
  const int last_q = min(q0 + kTcBlockQ, sq) - 1;
  const int kv_end = causal ? min(skv, last_q + q_offset + 1) : skv;
  const int n_tiles = (kv_end + kTcBlockK - 1) / kTcBlockK;

  for (int c = tid; c < kTcBlockQ * CPR; c += kTcWarps * 32) {
    const int r = c / CPR, ch = c % CPR;
    const bool ok = q0 + r < sq;
    cp_async16(smem_u32(sq_tile + tile_off<HD>(r, ch)),
               ok ? qb + (long)(q0 + r) * q_stride + ch * 8 : qb, ok);
  }
  auto load_kv = [&](int t, int stage) {
    for (int c = tid; c < kTcBlockK * CPR; c += kTcWarps * 32) {
      const int r = c / CPR, ch = c % CPR, key = t * kTcBlockK + r;
      const bool ok = key < skv;
      const long off = ok ? (long)key * kv_stride + ch * 8 : 0;
      const int so = stage * TILE + tile_off<HD>(r, ch);
      cp_async16(smem_u32(sk + so), kb + off, ok);
      cp_async16(smem_u32(sv + so), vb + off, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();  // group 0: Q and tile 0

  uint32_t qf[KSTEPS][4];
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g, g+8

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile t (and Q) have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldsm_x4(smem_u32(sq_tile + tile_off<HD>(
                    warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                    2 * kk + (lane >> 4))),
                qf[kk]);
    }
    const __nv_bfloat16* tk = sk + stage * TILE;
    const __nv_bfloat16* tv = sv + stage * TILE;

    // S = Q K^T: column tiles 2jj and 2jj+1 from one ldmatrix.x4
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t bf[4];
        ldsm_x4(smem_u32(tk + tile_off<HD>(
                    16 * jj + (lane & 7) + (lane >> 4) * 8,
                    2 * kk + ((lane >> 3) & 1))),
                bf);
        mma_bf16(s[2 * jj], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * jj + 1], qf[kk], bf[2], bf[3]);
      }

    // scores in base 2; mask only the ragged tail and the diagonal tile
    const int k0 = t * kTcBlockK;
    const bool need_mask = k0 + kTcBlockK > skv ||
                           (causal && k0 + kTcBlockK - 1 > q0 + q_offset);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qpos = q0 + warp * 16 + g + (e >> 1) * 8 + q_offset;
          if (key >= skv || (causal && key > qpos)) x = kNegInf;
        }
        s[j][e] = x;
      }

    // online softmax per row (hr 0: row g, hr 1: row g+8); the row's 64
    // scores sit on the 4 lanes of a quad
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float alpha = exp2f(m[hr] - m_new);
      m[hr] = m_new;
      float ps = 0.f;  // this lane's part of the row sum
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - m_new);
          ps += s[j][e];
        }
      l[hr] = l[hr] * alpha + ps;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][2 * hr] *= alpha;
        acc[d][2 * hr + 1] *= alpha;
      }
    }

    // O += P V: P's accumulator fragments are the A fragments of P V
#pragma unroll
    for (int kk = 0; kk < kTcBlockK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int p = 0; p < DT / 2; ++p) {
        uint32_t bf[4];
        ldsm_x4_trans(smem_u32(tv + tile_off<HD>(
                          16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                          2 * p + (lane >> 4))),
                      bf);
        mma_bf16(acc[2 * p], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * p + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  __nv_bfloat16* ob = o + (long)b * sq * q_stride + (long)hi * HD;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-20f);
    const int qp = q0 + warp * 16 + g + hr * 8;
    if (qp >= sq) continue;
    if constexpr (kLse) {
      // natural log: the scores here are in base 2 (scaled by log2 e)
      if (t4 == 0)
        lse[((long)b * h + hi) * sq + qp] = (m[hr] + log2f(lt)) * kLn2;
    }
    __nv_bfloat16* orow = ob + (long)qp * q_stride + 2 * t4;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
          __floats2bfloat162_rn(acc[d][2 * hr] * inv,
                                acc[d][2 * hr + 1] * inv);
  }
}

// -- backward (training): FlashAttention-2's split, on wgmma ------------------
//
// Replaces the gradient of src/repro/models/attention.py's causal attention
// (gqa_core, or gqa_blocked above 1024 rows), which the reference takes by
// jax.grad of plain jnp: its Pallas kernel has no VJP.  Training calls
// attention with causal = 1, q_offset = 0 and Sq = Skv = S only, so these
// kernels take exactly that.  With P = softmax(scale * Q K^T) (causal) and
// lse the forward's row log-sum-exp of the scaled scores (fa_fwd_tc / fa_fwd
// with kLse), dO the output's gradient:
//   D  = rowsum(dO * O)                 f32 [B, H, S]
//   dS = P * (dO V^T - D)
//   dQ = scale * dS K                   fa_bwd_dq*:  a block a (b, q-head,
//                                       q tile), keys up to the diagonal
//   dK = scale * dS^T Q, dV = P^T dO    fa_bwd_dkv*: a block a (b, kv-head,
//                                       key tile), summing the G q-heads of
//                                       its group and every q tile from the
//                                       diagonal on inside the block
// No atomics: each output element is written by one thread, its sums taken
// in a fixed order, so a step's gradients are bit-equal from run to run.
// P is recomputed from lse (exp2 of the base-2 scores), never stored.
//
// What bounds it on this card: the five S x S products (S, dP, dQ, dK, dV)
// are about 5 * S^2 * H * hd * B FLOPs under the causal mask (2 FLOPs a
// multiply-add, half of the square), so the bf16 tensor-core rate.
//
// bf16 (fa_bwd_dq_wg, then fa_bwd_dkv_wg), on Hopper's warpgroup products:
//  - every product is a wgmma of a 64-row tile, f32 accumulators in
//    registers.  A block is 3 warpgroups: two consumers, each owning 64 rows
//    of the block's 128 (queries for dQ, keys for dK/dV), and a producer
//    whose one thread issues every TMA copy: the block's own 128 rows (Q
//    and dO, or K and V), resident for the whole block, and the other
//    side's 64-row tiles through a ring of kBwdStages stages, each stage's
//    bytes counted on its "full" mbarrier (positions >= S zero-filled by the
//    copy); the consumers release a stage through its "empty" mbarrier once
//    their products on it are done.  setmaxnreg moves registers from the
//    producer (40) to the consumers (232): dK and dV take 2 x hd/2 f32 a
//    thread.
//  - tiles are stored as the TMA copies them and wgmma's swizzled modes read
//    them (SwTile below), so one copy of a [64][hd] tile is read K-major (hd
//    the reduction, as in Q K^T) or MN-major (the rows the reduction, as in
//    dS K) by the descriptor alone.
//  - dK/dV: S^T = K Q^T and dP^T = V dO^T (m64n64k16, K and V in shared
//    memory for the whole block), then P^T and dS^T are rounded to bf16 in
//    registers and fed as wgmma's register A operand to dV += P^T dO and
//    dK += dS^T Q (m64n{hd}k16, dO and Q read MN-major).  The stage also
//    carries its rows' lse and D (cp.async by the producer's warp).
//  - dQ: Q and dO of a warpgroup's rows go to registers once (ldmatrix), so
//    S = Q K^T and dP = dO V^T read only K and V from shared memory; P is
//    taken while dP is computed; dQ += dS K with dS in registers and K read
//    MN-major.  The dQ blocks also compute D (two threads a row, O from
//    device memory, dO from the resident tile) and write it for the dK/dV
//    kernel: no pass of its own.
//  - dQ stays its own kernel, so S and dP are computed twice (7 products, 5
//    needed): adding dQ from the dK/dV blocks, as FlashAttention-2 and -3
//    do, needs atomics or FlashAttention-3's semaphore-ordered accumulation,
//    and the two extra products cost about 0.035 ms at the tensor cores'
//    rate at qwen3-0.6b's training shape (B=8, S=1024, H=16, hd=128).
//  - the heaviest blocks under the causal mask start first (the last q
//    tiles for dQ, key tile 0 for dK/dV); only tiles across the diagonal
//    or the ragged end are masked, and a warpgroup skips a tile wholly past
//    the causal limit (it still waits and releases, to keep the ring).
//  - P and dS are rounded to bf16 before their products, f32 accumulation,
//    as in FlashAttention-2; exp2 on the special-function unit.
// What holds it back (measured, PERF.md): at qwen3-0.6b's training shape
// the 7 products run at about 40% of the tensor cores' peak rate: the
// consumers' elementwise work and the waits on their own products do not
// overlap the other warpgroup's products, and S^T, dP^T read both operands
// from shared memory.
// f32 (fa_bwd_dot, then fa_bwd_dq, fa_bwd_dkv): fa_fwd's layout on the CUDA
// cores, full f32.

// the sum of the products of the 16 bytes a and b hold (8 bf16 or 4 f32)
template <typename T>
__device__ __forceinline__ float dot16(uint4 a, uint4 b);
template <>
__device__ __forceinline__ float dot16<float>(uint4 a, uint4 b) {
  return __uint_as_float(a.x) * __uint_as_float(b.x) +
         __uint_as_float(a.y) * __uint_as_float(b.y) +
         __uint_as_float(a.z) * __uint_as_float(b.z) +
         __uint_as_float(a.w) * __uint_as_float(b.w);
}
template <>
__device__ __forceinline__ float dot16<__nv_bfloat16>(uint4 a, uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc += __uint_as_float(x[i] << 16) * __uint_as_float(y[i] << 16);
    acc += __uint_as_float(x[i] & 0xffff0000u) *
           __uint_as_float(y[i] & 0xffff0000u);
  }
  return acc;
}

// D[b, hi, i] = sum_d dO[b, i, hi, d] * O[b, i, hi, d] for the f32
// backward: a row is hd / 4 threads (8 to 32), each one 16-byte load of O
// and of dO, summed by shuffles in a fixed order
__global__ void __launch_bounds__(256)
    fa_bwd_dot(const float* __restrict__ o, const float* __restrict__ dout,
               float* __restrict__ dsum, int s, int h, int hd, long rows) {
  const int per_row = hd / 4;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long row = t / per_row;
  const int part = (int)(t % per_row);
  float acc = 0.f;
  if (row < rows) {
    const long at = row * hd + part * 4;
    acc = dot16<float>(*reinterpret_cast<const uint4*>(o + at),
                       *reinterpret_cast<const uint4*>(dout + at));
  }
  for (int off = per_row / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (row < rows && part == 0) {
    const int hi = (int)(row % h);  // row = (b * s + i) * h + hi
    const long bi = row / h;
    const int i = (int)(bi % s);
    const long b = bi / s;
    dsum[(b * h + hi) * s + i] = acc;
  }
}

// -- the bf16 backward's own primitives (the shared ones: hopper.cuh) --------

constexpr int kWg = 128;                          // threads of a warpgroup
constexpr int kBwdWgs = 2;                        // consumer warpgroups
constexpr int kBwdThreads = (kBwdWgs + 1) * kWg;  // and the producer's
constexpr int kBwdRows = 64;                      // rows of a wgmma tile
constexpr int kBwdStages = 3;                     // the ring's stages
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// 4 bytes global -> shared; src-size 0 (ok false) writes zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// one arrival on the barrier once every cp.async this thread has issued
// has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// 2^x on the special-function unit (P's exponent is <= 0: flushing a
// denormal result to 0 drops probabilities below 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A 64-row tile of a [*, HD] bf16 array is stored the way wgmma's swizzled
// modes read it: for HD >= 64 as HD / 64 column atoms [64 rows][64], each
// row 128 bytes with its 16-byte chunk c at chunk c ^ (row % 8) (the
// 128-byte swizzle); for HD = 32 as [64 rows][32], each row 64 bytes with
// chunk c at c ^ (row / 2 % 4) (the 64-byte swizzle).  A tile starts on a
// 1024-byte boundary.  The same tile is read K-major (HD the reduction, as
// in Q K^T) or MN-major (the rows the reduction, as in dS K) by the
// descriptor alone.
template <int HD>
struct SwTile {
  static constexpr int kRowBytes = HD >= 64 ? 128 : 64;
  static constexpr int kAtomBytes = kBwdRows * kRowBytes;  // 64 columns
  static constexpr int kBytes = kBwdRows * HD * 2;
  static constexpr uint64_t kMode = HD >= 64 ? 1 : 2;  // 128B / 64B swizzle
};

// byte offset of 16-byte chunk c of row r (< 64) in a tile
template <int HD>
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
  if constexpr (HD >= 64)
    return (c >> 3) * SwTile<HD>::kAtomBytes + r * 128 +
           (((c & 7) ^ (r & 7)) << 4);
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// K-major: 8-row groups SBO apart (LBO unused); k-step kk starts 32 bytes
// further along a row, and at the next column atom after four
template <int HD>
__device__ __forceinline__ uint64_t desc_kmaj(const void* tile) {
  return gmma_desc(smem_u32(tile), 16, 8 * SwTile<HD>::kRowBytes,
                   SwTile<HD>::kMode);
}
template <int HD>
__device__ __forceinline__ uint64_t kstep_k(int kk) {
  return (uint64_t)(((kk >> 2) * SwTile<HD>::kAtomBytes + (kk & 3) * 32) >>
                    4);
}
// MN-major: column atoms LBO apart, 8-row groups SBO apart; k-step kk
// starts 16 rows further
template <int HD>
__device__ __forceinline__ uint64_t desc_mnmaj(const void* tile) {
  return gmma_desc(smem_u32(tile), SwTile<HD>::kAtomBytes,
                   8 * SwTile<HD>::kRowBytes, SwTile<HD>::kMode);
}
template <int HD>
__device__ __forceinline__ uint64_t kstep_mn(int kk) {
  return (uint64_t)((kk * 16 * SwTile<HD>::kRowBytes) >> 4);
}

// a 64-row tile of a [B, S, heads, HD] bf16 array (its rows the sequence
// positions s0 .. s0 + 63 of head hn, batch b) by TMA: one box a 64-column
// atom, positions >= S zero-filled by the hardware, the swizzle of SwTile
// applied by the tensor map
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int hn, int s0, int b,
                                         uint32_t bar) {
#pragma unroll
  for (int a = 0; a < HD / 64 + (HD < 64); ++a)
    tma_load4(dst + a * SwTile<HD>::kAtomBytes, map, a * 64, hn, s0, b, bar);
}

// the wgmma products the backward issues (one specialisation a width)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);

// d[32] (+)= A[64x16] B[16x64], A and B K-major in shared memory
// (descriptors da, db); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[16] += A[64x16] B[16x32], A in registers (a: the m16n8k16 A
// fragment of the warp's 16 rows), B MN-major in shared memory (db)
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A[64x16] B[16x64], A in registers (a: the m16n8k16 A
// fragment of the warp's 16 rows), B MN-major in shared memory (db)
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A[64x16] B[16x128], A in registers (a: the m16n8k16 A
// fragment of the warp's 16 rows), B MN-major in shared memory (db)
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
      "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] (+)= A[64x16] B[16x64], A in registers (a: the m16n8k16 A fragment
// of the warp's 16 rows), B K-major in shared memory (db); scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// the register A fragments of k-step kk of a product whose A is an
// m64n64 accumulator (its columns are the product's reduction), rounded
// to bf16
__device__ __forceinline__ void acc_to_a(const float (&x)[32], int kk,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

// Accumulator layout of an m64nN product (g = lane / 4, t = lane % 4): warp
// w of the warpgroup holds rows 16 w + g (x[4 j], x[4 j + 1]) and 16 w + g +
// 8 (x[4 j + 2], x[4 j + 3]), columns 8 j + 2 t and 8 j + 2 t + 1.
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
    fa_bwd_dq_wg(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __nv_bfloat16* __restrict__ o,
                 const float* __restrict__ lse, float* __restrict__ dsum,
                 __nv_bfloat16* __restrict__ dq, int s, int h, int kvh,
                 float scale_log2, float scale) {
  constexpr int TILE = kBwdRows * HD;  // elements of a 64-row tile
  constexpr int KSTEPS = HD / 16;
  constexpr int ROWS = kBwdWgs * kBwdRows;  // the block's query rows
  extern __shared__ __align__(1024) unsigned char fa_dq_smem[];
  // tiles on 1024-byte boundaries (the launch adds 1024 bytes)
  unsigned char* smem =
      fa_dq_smem + ((1024 - (smem_u32(fa_dq_smem) & 1023)) & 1023);
  __nv_bfloat16* sq_t = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdo = sq_t + kBwdWgs * TILE;  // resident Q, dO
  __nv_bfloat16* sk = sdo + kBwdWgs * TILE;    // the ring: K, V tiles
  __nv_bfloat16* sv = sk + kBwdStages * TILE;
  float* sdsum = reinterpret_cast<float*>(sv + kBwdStages * TILE);  // [ROWS]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sdsum + ROWS);
  // the ring's full and empty barriers, then the resident tiles'
  const uint32_t full = smem_u32(bars), empty = full + 8 * kBwdStages;
  const uint32_t res = empty + 8 * kBwdStages;

  const int n_qt = (s + ROWS - 1) / ROWS;
  const int n_bh = gridDim.x / n_qt;  // B * H
  const int qt = n_qt - 1 - (int)blockIdx.x / n_bh;  // heaviest first
  const int bh = (int)blockIdx.x % n_bh;
  const int hi = bh % h, b = bh / h;
  const int kh = hi / (h / kvh);
  const int tid = threadIdx.x;
  const int q0 = qt * ROWS;
  const long q_stride = (long)h * HD;
  const long q_base = (long)b * s * q_stride + (long)hi * HD;
  // key tiles up to the block's last row
  const int n_kt = (min(q0 + ROWS, s) - 1) / kBwdRows + 1;

  if (tid == 0) {
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(full + 8 * st, 1);              // the producer's expect_tx
      mbar_init(empty + 8 * st, kBwdWgs * kWg);  // every consumer thread
    }
    mbar_init(res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / kWg;
  if (wg == kBwdWgs) {  // the producer
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kBwdWgs * kWg) {  // one thread issues every copy
      mbar_expect_tx(res, 2 * kBwdWgs * SwTile<HD>::kBytes);
#pragma unroll
      for (int w = 0; w < kBwdWgs; ++w) {
        tma_tile<HD>(smem_u32(sq_t + w * TILE), &tm_q, hi, q0 + w * kBwdRows,
                     b, res);
        tma_tile<HD>(smem_u32(sdo + w * TILE), &tm_do, hi,
                     q0 + w * kBwdRows, b, res);
      }
      for (int t = 0; t < n_kt; ++t) {
        const int st = t % kBwdStages;
        mbar_wait(empty + 8 * st, ((t / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * SwTile<HD>::kBytes);
        tma_tile<HD>(smem_u32(sk + st * TILE), &tm_k, kh, t * kBwdRows, b,
                     full + 8 * st);
        tma_tile<HD>(smem_u32(sv + st * TILE), &tm_v, kh, t * kBwdRows, b,
                     full + 8 * st);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int qw = q0 + wg * kBwdRows;              // the warpgroup's rows
  const int row_lo = qw + ((tid & (kWg - 1)) >> 5) * 16 + g;  // and + 8
  // D = rowsum(dO * O) of the warpgroup's rows, here rather than in a pass
  // of its own: two threads a row, O from device memory (loaded while the
  // resident tiles land), dO from the resident tile, summed in a fixed
  // order; written for the dK/dV kernel, and passed to the warpgroup's
  // threads through sdsum
  {
    constexpr int CPR = HD / 8;
    const int r = (tid & (kWg - 1)) >> 1, half = tid & 1, qp = qw + r;
    uint4 orow[CPR / 2];
#pragma unroll
    for (int i = 0; i < CPR / 2; ++i)
      orow[i] = qp < s ? *reinterpret_cast<const uint4*>(
                             o + q_base + (long)qp * q_stride +
                             (half * (CPR / 2) + i) * 8)
                       : make_uint4(0, 0, 0, 0);
    mbar_wait(res, 0);
    const unsigned char* dtile =
        reinterpret_cast<const unsigned char*>(sdo + wg * TILE);
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < CPR / 2; ++i)
      d += dot16<__nv_bfloat16>(
          orow[i], *reinterpret_cast<const uint4*>(
                       dtile + sw_off<HD>(r, half * (CPR / 2) + i)));
    d += __shfl_xor_sync(kFull, d, 1);
    if (half == 0) {
      sdsum[wg * kBwdRows + r] = d;
      if (qp < s) dsum[((long)b * h + hi) * s + qp] = d;
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWg) : "memory");
  }
  float lse2[2], dr[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = row_lo + hr * 8;
    const long at = ((long)b * h + hi) * s + qp;
    lse2[hr] = qp < s ? lse[at] * kLog2e : 0.f;
    dr[hr] = sdsum[qp - q0];
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  // Q and dO of the warpgroup's rows as register A fragments, read once
  uint32_t qf[KSTEPS][4], df[KSTEPS][4];
  {
    const int row = ((tid & (kWg - 1)) >> 5) * 16 + (lane & 7) +
                    ((lane >> 3) & 1) * 8;
    const uint32_t qs = smem_u32(sq_t + wg * TILE);
    const uint32_t ds = smem_u32(sdo + wg * TILE);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t off = sw_off<HD>(row, 2 * kk + (lane >> 4));
      ldsm_x4(qs + off, qf[kk]);
      ldsm_x4(ds + off, df[kk]);
    }
  }
  // key tiles that the warpgroup's rows see
  const int wg_kt = qw < s ? qw / kBwdRows + 1 : 0;

  for (int t = 0; t < n_kt; ++t) {
    const int st = t % kBwdStages;
    mbar_wait(full + 8 * st, (t / kBwdStages) & 1);
    if (t < wg_kt) {
      const uint64_t kd = desc_kmaj<HD>(sk + st * TILE);
      const uint64_t vd = desc_kmaj<HD>(sv + st * TILE);
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_rs_n64_k(sc, qf[kk], kd + kstep_k<HD>(kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_rs_n64_k(dp, df[kk], vd + kstep_k<HD>(kk), kk);
      wgmma_commit();
      // P in place of S while dP = dO V^T is computed
      wgmma_wait<1>();
      fence_regs(sc);
      const int k0 = t * kBwdRows;
      const bool need_mask = k0 + kBwdRows - 1 > qw || qw + kBwdRows > s;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hr = (i >> 1) & 1;
        float p = ex2(fmaf(sc[i], scale_log2, -lse2[hr]));
        if (need_mask) {
          const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          const int qp = row_lo + hr * 8;
          if (key > qp || qp >= s) p = 0.f;
        }
        sc[i] = p;
      }
      // dS = P * (dP - D)
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - dr[(i >> 1) & 1];
      // dQ += dS K: dS in registers, K read MN-major
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(sc, kk, a[kk]);
      const uint64_t kt_d = desc_mnmaj<HD>(sk + st * TILE);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<HD>(acc, a[kk], kt_d + kstep_mn<HD>(kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    mbar_arrive(empty + 8 * st);
  }

  __nv_bfloat16* dqb = dq + q_base;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = row_lo + hr * 8;
    if (qp >= s) continue;
    __nv_bfloat16* row = dqb + (long)qp * q_stride + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hr] * scale,
                                acc[4 * j + 2 * hr + 1] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
    fa_bwd_dkv_wg(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int s, int h, int kvh,
                  float scale_log2, float scale) {
  constexpr int TILE = kBwdRows * HD;
  constexpr int KSTEPS = HD / 16;
  constexpr int ROWS = kBwdWgs * kBwdRows;  // the block's keys
  extern __shared__ __align__(1024) unsigned char fa_dkv_smem[];
  // tiles on 1024-byte boundaries (the launch adds 1024 bytes)
  unsigned char* smem =
      fa_dkv_smem + ((1024 - (smem_u32(fa_dkv_smem) & 1023)) & 1023);
  __nv_bfloat16* sk_t = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sv_t = sk_t + kBwdWgs * TILE;  // resident K, V
  __nv_bfloat16* sq = sv_t + kBwdWgs * TILE;    // the ring: Q, dO tiles,
  __nv_bfloat16* sdo = sq + kBwdStages * TILE;  // lse and D of their rows
  float* sl = reinterpret_cast<float*>(sdo + kBwdStages * TILE);
  float* sd = sl + kBwdStages * kBwdRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sd + kBwdStages * kBwdRows);
  // the ring's full and empty barriers, then the resident tiles'
  const uint32_t full = smem_u32(bars), empty = full + 8 * kBwdStages;
  const uint32_t res = empty + 8 * kBwdStages;

  const int n_kt = (s + ROWS - 1) / ROWS;
  const int n_bk = gridDim.x / n_kt;         // B * KV
  const int kt = (int)blockIdx.x / n_bk;     // the first key tiles see most
  const int bk = (int)blockIdx.x % n_bk;
  const int kh = bk % kvh, b = bk / kvh;
  const int grp = h / kvh;
  const int tid = threadIdx.x;
  const int k0 = kt * ROWS;
  const long kv_stride = (long)kvh * HD;
  const long kv_base = (long)b * s * kv_stride + (long)kh * HD;
  // q tiles are 64 rows: the ones before k0 are masked
  const int qt0 = k0 / kBwdRows;
  const int nq = (s + kBwdRows - 1) / kBwdRows - qt0;
  const int n_it = grp * nq;

  if (tid == 0) {
    for (int st = 0; st < kBwdStages; ++st) {
      // the expect_tx of lane 0 and the cp.async of lse, D by all 32 lanes
      mbar_init(full + 8 * st, 1 + 32);
      mbar_init(empty + 8 * st, kBwdWgs * kWg);
    }
    mbar_init(res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / kWg;
  if (wg == kBwdWgs) {  // the producer
    setmaxnreg_dec<kProducerRegs>();
    if (tid - kBwdWgs * kWg < 32) {
      const int lane = tid & 31;
      if (lane == 0) {
        mbar_expect_tx(res, 2 * kBwdWgs * SwTile<HD>::kBytes);
#pragma unroll
        for (int w = 0; w < kBwdWgs; ++w) {
          tma_tile<HD>(smem_u32(sk_t + w * TILE), &tm_k, kh,
                       k0 + w * kBwdRows, b, res);
          tma_tile<HD>(smem_u32(sv_t + w * TILE), &tm_v, kh,
                       k0 + w * kBwdRows, b, res);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kBwdStages;
        const int hi = kh * grp + it / nq;
        const int q0 = (qt0 + it % nq) * kBwdRows;
        const long row_base = ((long)b * h + hi) * s;
        mbar_wait(empty + 8 * st, ((it / kBwdStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + 8 * st, 2 * SwTile<HD>::kBytes);
          tma_tile<HD>(smem_u32(sq + st * TILE), &tm_q, hi, q0, b,
                       full + 8 * st);
          tma_tile<HD>(smem_u32(sdo + st * TILE), &tm_do, hi, q0, b,
                       full + 8 * st);
        }
        for (int i = lane; i < kBwdRows; i += 32) {
          const bool ok = q0 + i < s;
          const long at = ok ? row_base + q0 + i : 0;
          cp_async4(smem_u32(sl + st * kBwdRows + i), lse + at, ok);
          cp_async4(smem_u32(sd + st * kBwdRows + i), dsum + at, ok);
        }
        cp_async_arrive(full + 8 * st);
      }
      cp_async_commit();  // the last copies land before the warp exits
      cp_async_wait<0>();
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int kw = k0 + wg * kBwdRows;          // the warpgroup's keys
  const int key_lo = kw + ((tid & (kWg - 1)) >> 5) * 16 + g;  // and + 8
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
  const uint64_t ka = desc_kmaj<HD>(sk_t + wg * TILE);
  const uint64_t va = desc_kmaj<HD>(sv_t + wg * TILE);
  mbar_wait(res, 0);

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kBwdStages;
    const int q0 = (qt0 + it % nq) * kBwdRows;
    mbar_wait(full + 8 * st, (it / kBwdStages) & 1);
    if (kw <= q0 + kBwdRows - 1 && kw < s) {
      const uint64_t qd = desc_kmaj<HD>(sq + st * TILE);
      const uint64_t dd = desc_kmaj<HD>(sdo + st * TILE);
      // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_ss_n64(sc, ka + kstep_k<HD>(kk), qd + kstep_k<HD>(kk), kk);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_ss_n64(dp, va + kstep_k<HD>(kk), dd + kstep_k<HD>(kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // P^T in sc, dS^T in dp
      const bool need_mask = kw + kBwdRows - 1 > q0 || q0 + kBwdRows > s;
      const float* lrow = sl + st * kBwdRows;
      const float* drow = sd + st * kBwdRows;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lrow + 8 * j +
                                                           2 * t4);
        const float2 d2 = *reinterpret_cast<const float2*>(drow + 8 * j +
                                                           2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float p = ex2(fmaf(sc[i], scale_log2,
                               -((e & 1) ? l2.y : l2.x) * kLog2e));
          if (need_mask) {
            const int key = key_lo + (e >> 1) * 8;
            const int qp = q0 + 8 * j + 2 * t4 + (e & 1);
            if (key > qp || qp >= s) p = 0.f;
          }
          sc[i] = p;
          dp[i] = p * (dp[i] - ((e & 1) ? d2.y : d2.x));
        }
      }
      // dV += P^T dO and dK += dS^T Q: P^T and dS^T in registers, dO and Q
      // read MN-major
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(sc, kk, pa[kk]);
        acc_to_a(dp, kk, sa[kk]);
      }
      const uint64_t do_t = desc_mnmaj<HD>(sdo + st * TILE);
      const uint64_t q_t = desc_mnmaj<HD>(sq + st * TILE);
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<HD>(dva, pa[kk], do_t + kstep_mn<HD>(kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<HD>(dka, sa[kk], q_t + kstep_mn<HD>(kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
    }
    mbar_arrive(empty + 8 * st);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = key_lo + hr * 8;
    if (key >= s) continue;
    const long at = kv_base + (long)key * kv_stride + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2 * hr] * scale,
                                dka[4 * j + 2 * hr + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2 * hr], dva[4 * j + 2 * hr + 1]);
    }
  }
}

// f32 dQ on the CUDA cores: fa_fwd's blocks (b, q-head, 16-row q tile), 4
// rows a warp, lane j on key t0 + j of a 32-key tile
template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    fa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              float* __restrict__ dq, int s, int h, int kvh, float scale) {
  constexpr int E = HD / 32;
  constexpr int KP = HD + 1;  // padded rows: lane j reads row j
  extern __shared__ float fa_dq_f32_smem[];
  float* qs = fa_dq_f32_smem;          // [16][HD]
  float* dos = qs + kBlockQ * HD;      // [16][HD]
  float* ks = dos + kBlockQ * HD;      // [32][HD + 1]
  float* vs = ks + kBlockK * KP;       // [32][HD + 1]

  const int n_qt = (s + kBlockQ - 1) / kBlockQ;
  int bid = blockIdx.x;
  const int qt = bid % n_qt;
  bid /= n_qt;
  const int hi = bid % h;
  const int b = bid / h;
  const int kh = hi / (h / kvh);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = qt * kBlockQ;
  const long q_stride = (long)h * HD;
  const long kv_stride = (long)kvh * HD;
  const long q_base = (long)b * s * q_stride + (long)hi * HD;
  const float* kb = k + (long)b * s * kv_stride + (long)kh * HD;
  const float* vb = v + (long)b * s * kv_stride + (long)kh * HD;

  for (int e = tid; e < kBlockQ * HD; e += kWarps * 32) {
    const int r = e / HD, d = e % HD, qp = q0 + r;
    const bool ok = qp < s;
    qs[e] = ok ? q[q_base + qp * q_stride + d] : 0.f;
    dos[e] = ok ? dout[q_base + qp * q_stride + d] : 0.f;
  }
  float lr[kRows], dr[kRows], acc[kRows][E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    const long at = ((long)b * h + hi) * s + qp;
    lr[r] = qp < s ? lse[at] : 0.f;
    dr[r] = qp < s ? dsum[at] : 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[r][i] = 0.f;
  }
  const int kv_end = min(q0 + kBlockQ, s);  // keys <= the tile's last row
  for (int t0 = 0; t0 < kv_end; t0 += kBlockK) {
    __syncthreads();
    for (int e = tid; e < kBlockK * HD; e += kWarps * 32) {
      const int j = e / HD, d = e % HD, key = t0 + j;
      const bool ok = key < s;
      ks[j * KP + d] = ok ? kb[key * kv_stride + d] : 0.f;
      vs[j * KP + d] = ok ? vb[key * kv_stride + d] : 0.f;
    }
    __syncthreads();
    float sc[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = dp[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = ks[lane * KP + d], vd = vs[lane * KP + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        sc[r] += qs[(warp * kRows + r) * HD + d] * kd;
        dp[r] += dos[(warp * kRows + r) * HD + d] * vd;
      }
    }
    const int key = t0 + lane;
    float ds[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + warp * kRows + r;
      const float p =
          (key <= qp && qp < s) ? expf(sc[r] * scale - lr[r]) : 0.f;
      ds[r] = p * (dp[r] - dr[r]);
    }
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float kj[E];
#pragma unroll
      for (int i = 0; i < E; ++i) kj[i] = ks[j * KP + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dsj = __shfl_sync(kFull, ds[r], j);
#pragma unroll
        for (int i = 0; i < E; ++i) acc[r][i] += dsj * kj[i];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    if (qp >= s) continue;
#pragma unroll
    for (int i = 0; i < E; ++i)
      dq[q_base + qp * q_stride + lane + 32 * i] = acc[r][i] * scale;
  }
}

// f32 dK/dV on the CUDA cores: a block a (b, kv-head, 16-key tile), 4 keys
// a warp, lane j on query q0 + j of a 32-query tile, the group's q-heads
// summed inside the block
template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    fa_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               float* __restrict__ dk, float* __restrict__ dv, int s, int h,
               int kvh, float scale) {
  constexpr int E = HD / 32;
  constexpr int QP = HD + 1;
  constexpr int kKeys = kWarps * kRows;  // 16 keys a block
  extern __shared__ float fa_dkv_f32_smem[];
  float* ks = fa_dkv_f32_smem;      // [16][HD]
  float* vs = ks + kKeys * HD;      // [16][HD]
  float* qs = vs + kKeys * HD;      // [32][HD + 1]
  float* dos = qs + kBlockK * QP;   // [32][HD + 1]

  const int n_kt = (s + kKeys - 1) / kKeys;
  const int n_bk = gridDim.x / n_kt;
  const int kt = (int)blockIdx.x / n_bk;
  const int bk = (int)blockIdx.x % n_bk;
  const int kh = bk % kvh, b = bk / kvh;
  const int grp = h / kvh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = kt * kKeys;
  const long q_stride = (long)h * HD;
  const long kv_stride = (long)kvh * HD;
  const long kv_base = (long)b * s * kv_stride + (long)kh * HD;

  for (int e = tid; e < kKeys * HD; e += kWarps * 32) {
    const int r = e / HD, d = e % HD, key = k0 + r;
    const bool ok = key < s;
    ks[e] = ok ? k[kv_base + key * kv_stride + d] : 0.f;
    vs[e] = ok ? v[kv_base + key * kv_stride + d] : 0.f;
  }
  float ak[kRows][E], av[kRows][E];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < E; ++i) ak[r][i] = av[r][i] = 0.f;

  for (int gi = 0; gi < grp; ++gi) {
    const int hi = kh * grp + gi;
    const long q_base = (long)b * s * q_stride + (long)hi * HD;
    const long row_base = ((long)b * h + hi) * s;
    for (int q0 = (k0 / kBlockK) * kBlockK; q0 < s; q0 += kBlockK) {
      __syncthreads();
      for (int e = tid; e < kBlockK * HD; e += kWarps * 32) {
        const int j = e / HD, d = e % HD, qp = q0 + j;
        const bool ok = qp < s;
        qs[j * QP + d] = ok ? q[q_base + qp * q_stride + d] : 0.f;
        dos[j * QP + d] = ok ? dout[q_base + qp * q_stride + d] : 0.f;
      }
      __syncthreads();
      const int qp = q0 + lane;
      const float lj = qp < s ? lse[row_base + qp] : 0.f;
      const float dj = qp < s ? dsum[row_base + qp] : 0.f;
      float sc[kRows], dp[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) sc[r] = dp[r] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float qd = qs[lane * QP + d], dd = dos[lane * QP + d];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          sc[r] += ks[(warp * kRows + r) * HD + d] * qd;
          dp[r] += vs[(warp * kRows + r) * HD + d] * dd;
        }
      }
      float p[kRows], ds[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int key = k0 + warp * kRows + r;
        p[r] = (key <= qp && qp < s) ? expf(sc[r] * scale - lj) : 0.f;
        ds[r] = p[r] * (dp[r] - dj);
      }
#pragma unroll 4
      for (int j = 0; j < kBlockK; ++j) {
        float qj[E], doj[E];
#pragma unroll
        for (int i = 0; i < E; ++i) {
          qj[i] = qs[j * QP + lane + 32 * i];
          doj[i] = dos[j * QP + lane + 32 * i];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pj = __shfl_sync(kFull, p[r], j);
          const float dsj = __shfl_sync(kFull, ds[r], j);
#pragma unroll
          for (int i = 0; i < E; ++i) {
            av[r][i] += pj * doj[i];
            ak[r][i] += dsj * qj[i];
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = k0 + warp * kRows + r;
    if (key >= s) continue;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const long at = kv_base + key * kv_stride + lane + 32 * i;
      dk[at] = ak[r][i] * scale;
      dv[at] = av[r][i];
    }
  }
}

// -- launchers ----------------------------------------------------------------

template <int HD, bool kLse>
cudaError_t launch_tc_hd(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* o, int b,
                         int sq, int skv, int h, int kvh, int causal,
                         int q_offset, float* lse, cudaStream_t stream) {
  constexpr int smem = (kTcBlockQ + 4 * kTcBlockK) * HD * 2;  // Q + 2x K,V
  // per launch: the limit is per device, and a failure is not cached
  const cudaError_t attr = cudaFuncSetAttribute(
      fa_fwd_tc<HD, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  const int n_qt = (sq + kTcBlockQ - 1) / kTcBlockQ;
  const dim3 grid((unsigned)((long)b * h * n_qt)), block(kTcWarps * 32);
  fa_fwd_tc<HD, kLse><<<grid, block, smem, stream>>>(
      q, k, v, o, sq, skv, h, kvh, causal, q_offset,
      kLog2e / sqrtf((float)HD), lse);
  return cudaGetLastError();
}

template <bool kLse>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int b, int sq, int skv, int h, int kvh, int hd,
                      int causal, int q_offset, float* lse,
                      cudaStream_t stream) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  switch (hd) {
    case 32:
      return launch_tc_hd<32, kLse>(qp, kp, vp, op, b, sq, skv, h, kvh,
                                    causal, q_offset, lse, stream);
    case 64:
      return launch_tc_hd<64, kLse>(qp, kp, vp, op, b, sq, skv, h, kvh,
                                    causal, q_offset, lse, stream);
    case 128:
      return launch_tc_hd<128, kLse>(qp, kp, vp, op, b, sq, skv, h, kvh,
                                     causal, q_offset, lse, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// f32 on the CUDA cores
template <bool kLse>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int b, int sq, int skv, int h, int kvh, int hd,
                       int causal, int q_offset, float* lse,
                       cudaStream_t stream) {
  const int n_qt = (sq + kBlockQ - 1) / kBlockQ;
  const dim3 grid((unsigned)((long)b * h * n_qt));
  const dim3 block(kWarps * 32);
  const float scale = 1.f / sqrtf((float)hd);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  switch (hd) {
    case 32:
      fa_fwd<32, kLse><<<grid, block, 0, stream>>>(
          qp, kp, vp, op, sq, skv, h, kvh, causal, q_offset, scale, lse);
      break;
    case 64:
      fa_fwd<64, kLse><<<grid, block, 0, stream>>>(
          qp, kp, vp, op, sq, skv, h, kvh, causal, q_offset, scale, lse);
      break;
    case 128:
      fa_fwd<128, kLse><<<grid, block, 0, stream>>>(
          qp, kp, vp, op, sq, skv, h, kvh, causal, q_offset, scale, lse);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the tensor map of a [B, S, heads, HD] bf16 array whose boxes are
// tma_tile's: 64 (HD = 32: 32) columns x one head x 64 positions, swizzled
// as SwTile reads them
template <int HD>
bool tile_map(CUtensorMap* map, const void* x, int b, int s, int heads) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)heads * HD * 2,
                                 (cuuint64_t)s * heads * HD * 2};
  const cuuint32_t box[4] = {HD < 64 ? HD : 64, 1, kBwdRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                HD >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_bwd_tc_hd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* dsum, void* dq,
                             void* dk, void* dv, int b, int s, int h, int kvh,
                             cudaStream_t stream) {
  using bf = __nv_bfloat16;
  // resident rows (Q and dO, or K and V) and the ring's tiles, then the
  // ring's lse and D (dK/dV only) and its 2 x kBwdStages mbarriers, and
  // room to start the tiles on a 1024-byte boundary
  constexpr int tiles = (2 * kBwdWgs + 2 * kBwdStages) * SwTile<HD>::kBytes;
  constexpr int bars = (2 * kBwdStages + 1) * 8;
  constexpr int smem_dq = tiles + kBwdWgs * kBwdRows * 4 + bars + 1024;
  constexpr int smem_dkv =
      tiles + 2 * kBwdStages * kBwdRows * 4 + bars + 1024;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if (!tile_map<HD>(&tm_q, q, b, s, h) ||
      !tile_map<HD>(&tm_do, dout, b, s, h) ||
      !tile_map<HD>(&tm_k, k, b, s, kvh) ||
      !tile_map<HD>(&tm_v, v, b, s, kvh))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_wg<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dkv_wg<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf((float)HD);
  const int n_blk = (s + kBwdWgs * kBwdRows - 1) / (kBwdWgs * kBwdRows);
  fa_bwd_dq_wg<HD><<<(unsigned)((long)b * h * n_blk), kBwdThreads, smem_dq,
                     stream>>>(
      tm_q, tm_do, tm_k, tm_v, static_cast<const bf*>(o), lse, dsum,
      static_cast<bf*>(dq), s, h, kvh, scale * kLog2e, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dkv_wg<HD><<<(unsigned)((long)n_blk * b * kvh), kBwdThreads,
                      smem_dkv, stream>>>(
      tm_q, tm_do, tm_k, tm_v, lse, dsum, static_cast<bf*>(dk),
      static_cast<bf*>(dv), s, h, kvh, scale * kLog2e, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_f32_hd(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* dsum, void* dq, void* dk, void* dv,
                              int b, int s, int h, int kvh,
                              cudaStream_t stream) {
  constexpr int smem_dq = (2 * kBlockQ * HD + 2 * kBlockK * (HD + 1)) * 4;
  constexpr int smem_dkv =
      (2 * kWarps * kRows * HD + 2 * kBlockK * (HD + 1)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dkv<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf((float)HD);
  const int n_qt = (s + kBlockQ - 1) / kBlockQ;
  const int n_kt = (s + kWarps * kRows - 1) / (kWarps * kRows);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  fa_bwd_dq<HD><<<(unsigned)((long)b * h * n_qt), kWarps * 32, smem_dq,
                  stream>>>(qp, kp, vp, dop, lse, dsum,
                            static_cast<float*>(dq), s, h, kvh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dkv<HD><<<(unsigned)((long)n_kt * b * kvh), kWarps * 32, smem_dkv,
                   stream>>>(qp, kp, vp, dop, lse, dsum,
                             static_cast<float*>(dk),
                             static_cast<float*>(dv), s, h, kvh, scale);
  return cudaGetLastError();
}

cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const float* lse,
                          float* dsum, void* dq, void* dk, void* dv, int b,
                          int s, int h, int kvh, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_bwd_tc_hd<32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b,
                                  s, h, kvh, stream);
    case 64:
      return launch_bwd_tc_hd<64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b,
                                  s, h, kvh, stream);
    case 128:
      return launch_bwd_tc_hd<128>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                                   b, s, h, kvh, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// f32: D in a pass of its own, then dQ and dK/dV on the CUDA cores
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* dsum, void* dq, void* dk, void* dv, int b,
                           int s, int h, int kvh, int hd,
                           cudaStream_t stream) {
  const long rows = (long)b * s * h;
  const int per_row = hd / 4;  // fa_bwd_dot's threads a row
  fa_bwd_dot<<<(unsigned)((rows * per_row + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), dsum, s,
      h, hd, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (hd) {
    case 32:
      return launch_bwd_f32_hd<32>(q, k, v, dout, lse, dsum, dq, dk, dv, b,
                                   s, h, kvh, stream);
    case 64:
      return launch_bwd_f32_hd<64>(q, k, v, dout, lse, dsum, dq, dk, dv, b,
                                   s, h, kvh, stream);
    case 128:
      return launch_bwd_f32_hd<128>(q, k, v, dout, lse, dsum, dq, dk, dv, b,
                                    s, h, kvh, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_shape(int b, int sq, int skv, int h, int kvh) {
  return b <= 0 || sq <= 0 || skv <= 0 || kvh <= 0 || h % kvh != 0;
}

}  // namespace

// dtype: 0 = float32 (fa_fwd), 1 = bfloat16 (fa_fwd_tc).  Returns the
// cudaError_t of the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int b, int sq,
                                     int skv, int h, int kvh, int hd,
                                     int dtype, int causal, int q_offset,
                                     void* stream) {
  if (bad_shape(b, sq, skv, h, kvh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_f32<false>(q, k, v, o, b, sq, skv, h, kvh, hd, causal,
                                  q_offset, nullptr, s);
  if (dtype == 1)
    return (int)launch_tc<false>(q, k, v, o, b, sq, skv, h, kvh, hd, causal,
                                 q_offset, nullptr, s);
  return (int)cudaErrorInvalidValue;
}

// The training forward: the same kernels, also writing the row log-sum-exp
// of the scaled scores, lse [B, H, Sq] f32 (natural log).
extern "C" int repro_flash_attention_fwd_lse(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse, int b, int sq,
                                             int skv, int h, int kvh, int hd,
                                             int dtype, int causal,
                                             int q_offset, void* stream) {
  if (bad_shape(b, sq, skv, h, kvh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)launch_f32<true>(q, k, v, o, b, sq, skv, h, kvh, hd, causal,
                                 q_offset, l, s);
  if (dtype == 1)
    return (int)launch_tc<true>(q, k, v, o, b, sq, skv, h, kvh, hd, causal,
                                q_offset, l, s);
  return (int)cudaErrorInvalidValue;
}

// The backward of causal attention with q_offset 0 and Sq = Skv = s: dsum
// is f32 scratch [B, H, s] (D); dq, dk, dv in q's dtype.  bf16: two
// launches (dQ with D, then dK/dV); f32: three (D, dQ, dK/dV), on one
// stream.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* lse, const void* dout,
                                         void* dsum, void* dq, void* dk,
                                         void* dv, int b, int s, int h,
                                         int kvh, int hd, int dtype,
                                         void* stream) {
  if (bad_shape(b, s, s, h, kvh) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ds = static_cast<float*>(dsum);
  const float* l = static_cast<const float*>(lse);
  if (dtype == 1)
    return (int)launch_bwd_tc(q, k, v, o, dout, l, ds, dq, dk, dv, b, s, h,
                              kvh, hd, st);
  return (int)launch_bwd_f32(q, k, v, o, dout, l, ds, dq, dk, dv, b, s, h,
                             kvh, hd, st);
}
