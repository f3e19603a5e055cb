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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// -- backward (training): FlashAttention-2's split ----------------------------
//
// Replaces the gradient of src/repro/models/attention.py's causal attention
// (gqa_core, or gqa_blocked above 1024 rows), which the reference takes by
// jax.grad of plain jnp: its Pallas kernel has no VJP.  Training calls
// attention with causal = 1, q_offset = 0 and Sq = Skv = S only, so these
// kernels take exactly that.  With P = softmax(scale * Q K^T) (causal) and
// lse the forward's row log-sum-exp of the scaled scores (fa_fwd_tc / fa_fwd
// with kLse), dO the output's gradient:
//   D  = rowsum(dO * O)                 fa_bwd_dot, f32 [B, H, S]
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
// bf16 (fa_bwd_dq_tc, fa_bwd_dkv_tc): mma.sync m16n8k16 with f32
// accumulation and fa_fwd_tc's fragments, swizzled tiles and cp.async
// loads.  dQ: a warp holds 16 query rows; S = Q K^T and dP = dO V^T come
// from the same k-steps, dS is packed to bf16 A-fragments and multiplied by
// K through ldmatrix.trans (P V's pattern in the forward).  dK/dV: a warp
// holds 16 key rows; S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
// dK += dS^T Q with P^T and dS^T packed to bf16 (32 queries a pass, so the
// f32 accumulators of dK and dV -- 2 x 64 registers at hd 128 -- leave room
// for the scores).  P and dS are rounded to bf16 before their products, as
// in FlashAttention-2.  f32 (fa_bwd_dq, fa_bwd_dkv): fa_fwd's layout on the
// CUDA cores, full f32.
//
// What bounds it on this card: the five S x S products (S, dP recomputed in
// both kernels, dQ, dK, dV) are about 5 * S^2 * H * hd * B FLOPs under the
// causal mask (2 FLOPs a multiply-add, half of the square), so the bf16
// tensor-core rate.  This first version is simple: one K/V (or Q/dO) stage
// at a time in the dK/dV kernel, S recomputed in both kernels, no wgmma.

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// D[b, hi, i] = sum_d dO[b, i, hi, d] * O[b, i, hi, d]; one warp a row
template <typename T>
__global__ void __launch_bounds__(256)
    fa_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ dsum, int s, int h, int hd, long rows) {
  const long row = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp
  const T* orow = o + row * hd;
  const T* drow = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc += to_f32(orow[d]) * to_f32(drow[d]);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int hi = (int)(row % h);  // row = (b * s + i) * h + hi
    const long bi = row / h;
    const int i = (int)(bi % s);
    const long b = bi / s;
    dsum[(b * h + hi) * s + i] = acc;
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcWarps * 32)
    fa_bwd_dq_tc(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum,
                 __nv_bfloat16* __restrict__ dq, int s, int h, int kvh,
                 float scale_log2, float scale) {
  constexpr int CPR = HD / 8;
  constexpr int KSTEPS = HD / 16;
  constexpr int NT = kTcBlockK / 8;
  constexpr int DT = HD / 8;
  constexpr int TILE = kTcBlockK * HD;
  extern __shared__ __align__(128) unsigned char fa_dq_smem[];
  __nv_bfloat16* sq_tile = reinterpret_cast<__nv_bfloat16*>(fa_dq_smem);
  __nv_bfloat16* sdo = sq_tile + kTcBlockQ * HD;  // [64][HD]
  __nv_bfloat16* sk = sdo + kTcBlockQ * HD;       // [2 stages][64][HD]
  __nv_bfloat16* sv = sk + 2 * TILE;              // [2 stages][64][HD]

  const int n_qt = (s + kTcBlockQ - 1) / kTcBlockQ;
  const int n_bh = gridDim.x / n_qt;
  const int qt = n_qt - 1 - (int)blockIdx.x / n_bh;  // heaviest first
  const int bh = (int)blockIdx.x % n_bh;
  const int hi = bh % h, b = bh / h;
  const int kh = hi / (h / kvh);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qt * kTcBlockQ;

  const long q_stride = (long)h * HD;
  const long kv_stride = (long)kvh * HD;
  const long q_base = (long)b * s * q_stride + (long)hi * HD;
  const __nv_bfloat16* qb = q + q_base;
  const __nv_bfloat16* dob = dout + q_base;
  const __nv_bfloat16* kb = k + (long)b * s * kv_stride + (long)kh * HD;
  const __nv_bfloat16* vb = v + (long)b * s * kv_stride + (long)kh * HD;
  const int last_q = min(q0 + kTcBlockQ, s) - 1;
  const int n_tiles = (last_q + kTcBlockK) / kTcBlockK;  // keys <= last_q

  for (int c = tid; c < kTcBlockQ * CPR; c += kTcWarps * 32) {
    const int r = c / CPR, ch = c % CPR;
    const bool ok = q0 + r < s;
    const long off = ok ? (long)(q0 + r) * q_stride + ch * 8 : 0;
    cp_async16(smem_u32(sq_tile + tile_off<HD>(r, ch)), qb + off, ok);
    cp_async16(smem_u32(sdo + tile_off<HD>(r, ch)), dob + off, ok);
  }
  auto load_kv = [&](int t, int stage) {
    for (int c = tid; c < kTcBlockK * CPR; c += kTcWarps * 32) {
      const int r = c / CPR, ch = c % CPR, key = t * kTcBlockK + r;
      const bool ok = key < s;
      const long off = ok ? (long)key * kv_stride + ch * 8 : 0;
      const int so = stage * TILE + tile_off<HD>(r, ch);
      cp_async16(smem_u32(sk + so), kb + off, ok);
      cp_async16(smem_u32(sv + so), vb + off, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();  // group 0: Q, dO and tile 0

  float lse2[2], dr[2];  // rows g and g+8 of the warp's 16
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = q0 + warp * 16 + g + hr * 8;
    const long at = ((long)b * h + hi) * s + qp;
    lse2[hr] = qp < s ? lse[at] * kLog2e : 0.f;
    dr[hr] = qp < s ? dsum[at] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tk = sk + stage * TILE;
    const __nv_bfloat16* tv = sv + stage * TILE;

    // S = Q K^T and dP = dO V^T over the same k-steps
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4], da[4];
      const int a_off = tile_off<HD>(a_row, 2 * kk + (lane >> 4));
      ldsm_x4(smem_u32(sq_tile + a_off), qa);
      ldsm_x4(smem_u32(sdo + a_off), da);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t bk[4], bv[4];
        const int b_off = tile_off<HD>(16 * jj + (lane & 7) + (lane >> 4) * 8,
                                       2 * kk + ((lane >> 3) & 1));
        ldsm_x4(smem_u32(tk + b_off), bk);
        ldsm_x4(smem_u32(tv + b_off), bv);
        mma_bf16(sc[2 * jj], qa, bk[0], bk[1]);
        mma_bf16(sc[2 * jj + 1], qa, bk[2], bk[3]);
        mma_bf16(dp[2 * jj], da, bv[0], bv[1]);
        mma_bf16(dp[2 * jj + 1], da, bv[2], bv[3]);
      }
    }
    // dS = P * (dP - D) in place of S
    const int k0 = t * kTcBlockK;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const int key = k0 + 8 * j + 2 * t4 + (e & 1);
        const int qp = q0 + warp * 16 + g + hr * 8;
        const float p = (key <= qp && qp < s)
                            ? exp2f(sc[j][e] * scale_log2 - lse2[hr])
                            : 0.f;
        sc[j][e] = p * (dp[j][e] - dr[hr]);
      }
    // dQ += dS K: dS's accumulator fragments are the A fragments
#pragma unroll
    for (int kk = 0; kk < kTcBlockK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int p = 0; p < DT / 2; ++p) {
        uint32_t bf[4];
        ldsm_x4_trans(smem_u32(tk + tile_off<HD>(
                          16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                          2 * p + (lane >> 4))),
                      bf);
        mma_bf16(acc[2 * p], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * p + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  __nv_bfloat16* dqb = dq + q_base;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = q0 + warp * 16 + g + hr * 8;
    if (qp >= s) continue;
    __nv_bfloat16* row = dqb + (long)qp * q_stride + 2 * t4;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * d) =
          __floats2bfloat162_rn(acc[d][2 * hr] * scale,
                                acc[d][2 * hr + 1] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcWarps * 32)
    fa_bwd_dkv_tc(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int s, int h, int kvh,
                  float scale_log2, float scale) {
  constexpr int CPR = HD / 8;
  constexpr int KSTEPS = HD / 16;
  constexpr int DT = HD / 8;
  constexpr int kPass = 32;        // queries a pass of the products
  constexpr int NQ = kPass / 8;    // 8-query column tiles of S^T
  constexpr int TILE = kTcBlockK * HD;
  extern __shared__ __align__(128) unsigned char fa_dkv_smem[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(fa_dkv_smem);
  __nv_bfloat16* sv = sk + TILE;        // [64][HD]
  __nv_bfloat16* sq_tile = sv + TILE;   // [64][HD]
  __nv_bfloat16* sdo = sq_tile + TILE;  // [64][HD]
  float* lse_s = reinterpret_cast<float*>(sdo + TILE);  // [64], base 2
  float* d_s = lse_s + kTcBlockQ;                       // [64]

  const int n_kt = (s + kTcBlockK - 1) / kTcBlockK;
  const int n_bk = gridDim.x / n_kt;  // B * KV
  const int kt = (int)blockIdx.x / n_bk;  // the first key tiles see most
  const int bk = (int)blockIdx.x % n_bk;
  const int kh = bk % kvh, b = bk / kvh;
  const int grp = h / kvh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = kt * kTcBlockK;

  const long q_stride = (long)h * HD;
  const long kv_stride = (long)kvh * HD;
  const long kv_base = (long)b * s * kv_stride + (long)kh * HD;
  for (int c = tid; c < kTcBlockK * CPR; c += kTcWarps * 32) {
    const int r = c / CPR, ch = c % CPR;
    const bool ok = k0 + r < s;
    const long off = ok ? (long)(k0 + r) * kv_stride + ch * 8 : 0;
    cp_async16(smem_u32(sk + tile_off<HD>(r, ch)), k + kv_base + off, ok);
    cp_async16(smem_u32(sv + tile_off<HD>(r, ch)), v + kv_base + off, ok);
  }
  cp_async_commit();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  const int n_qt = (s + kTcBlockQ - 1) / kTcBlockQ;
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  for (int gi = 0; gi < grp; ++gi) {
    const int hi = kh * grp + gi;
    const long q_base = (long)b * s * q_stride + (long)hi * HD;
    const long row_base = ((long)b * h + hi) * s;
    // q tiles are as tall as key tiles: the ones before kt are masked
    for (int qt = kt; qt < n_qt; ++qt) {
      const int q0 = qt * kTcBlockQ;
      __syncthreads();  // the previous Q/dO tile is consumed
      for (int c = tid; c < kTcBlockQ * CPR; c += kTcWarps * 32) {
        const int r = c / CPR, ch = c % CPR;
        const bool ok = q0 + r < s;
        const long off = ok ? (long)(q0 + r) * q_stride + ch * 8 : 0;
        cp_async16(smem_u32(sq_tile + tile_off<HD>(r, ch)),
                   q + q_base + off, ok);
        cp_async16(smem_u32(sdo + tile_off<HD>(r, ch)),
                   dout + q_base + off, ok);
      }
      cp_async_commit();
      if (tid < kTcBlockQ) {
        const bool ok = q0 + tid < s;
        lse_s[tid] = ok ? lse[row_base + q0 + tid] * kLog2e : 0.f;
        d_s[tid] = ok ? dsum[row_base + q0 + tid] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

#pragma unroll 1
      for (int r0 = 0; r0 < kTcBlockQ; r0 += kPass) {
        // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
        float st[NQ][4], dpt[NQ][4];
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t ka[4], va[4];
          const int a_off = tile_off<HD>(a_row, 2 * kk + (lane >> 4));
          ldsm_x4(smem_u32(sk + a_off), ka);
          ldsm_x4(smem_u32(sv + a_off), va);
#pragma unroll
          for (int jj = 0; jj < NQ / 2; ++jj) {
            uint32_t bq[4], bd[4];
            const int b_off =
                tile_off<HD>(r0 + 16 * jj + (lane & 7) + (lane >> 4) * 8,
                             2 * kk + ((lane >> 3) & 1));
            ldsm_x4(smem_u32(sq_tile + b_off), bq);
            ldsm_x4(smem_u32(sdo + b_off), bd);
            mma_bf16(st[2 * jj], ka, bq[0], bq[1]);
            mma_bf16(st[2 * jj + 1], ka, bq[2], bq[3]);
            mma_bf16(dpt[2 * jj], va, bd[0], bd[1]);
            mma_bf16(dpt[2 * jj + 1], va, bd[2], bd[3]);
          }
        }
        // P^T in st, dS^T in dpt
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + warp * 16 + g + (e >> 1) * 8;
            const int ql = r0 + 8 * j + 2 * t4 + (e & 1);
            const int qp = q0 + ql;
            const float p = (key <= qp && qp < s)
                                ? exp2f(st[j][e] * scale_log2 - lse_s[ql])
                                : 0.f;
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - d_s[ql]);
          }
        // dV += P^T dO and dK += dS^T Q over the pass's queries
#pragma unroll
        for (int kq = 0; kq < kPass / 16; ++kq) {
          const uint32_t pa[4] = {
              pack_bf16(st[2 * kq][0], st[2 * kq][1]),
              pack_bf16(st[2 * kq][2], st[2 * kq][3]),
              pack_bf16(st[2 * kq + 1][0], st[2 * kq + 1][1]),
              pack_bf16(st[2 * kq + 1][2], st[2 * kq + 1][3])};
          const uint32_t sa[4] = {
              pack_bf16(dpt[2 * kq][0], dpt[2 * kq][1]),
              pack_bf16(dpt[2 * kq][2], dpt[2 * kq][3]),
              pack_bf16(dpt[2 * kq + 1][0], dpt[2 * kq + 1][1]),
              pack_bf16(dpt[2 * kq + 1][2], dpt[2 * kq + 1][3])};
#pragma unroll
          for (int p = 0; p < DT / 2; ++p) {
            const int t_off = tile_off<HD>(
                r0 + 16 * kq + (lane & 7) + ((lane >> 3) & 1) * 8,
                2 * p + (lane >> 4));
            uint32_t bd[4], bq[4];
            ldsm_x4_trans(smem_u32(sdo + t_off), bd);
            mma_bf16(dva[2 * p], pa, bd[0], bd[1]);
            mma_bf16(dva[2 * p + 1], pa, bd[2], bd[3]);
            ldsm_x4_trans(smem_u32(sq_tile + t_off), bq);
            mma_bf16(dka[2 * p], sa, bq[0], bq[1]);
            mma_bf16(dka[2 * p + 1], sa, bq[2], bq[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + warp * 16 + g + hr * 8;
    if (key >= s) continue;
    const long at = kv_base + (long)key * kv_stride + 2 * t4;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * d) =
          __floats2bfloat162_rn(dka[d][2 * hr] * scale,
                                dka[d][2 * hr + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * d) =
          __floats2bfloat162_rn(dva[d][2 * hr], dva[d][2 * hr + 1]);
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

template <int HD>
cudaError_t launch_bwd_tc_hd(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* dsum, void* dq, void* dk, void* dv,
                             int b, int s, int h, int kvh,
                             cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr int smem_dq = (2 * kTcBlockQ + 4 * kTcBlockK) * HD * 2;
  constexpr int smem_dkv = 4 * kTcBlockK * HD * 2 + 2 * kTcBlockQ * 4;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dkv_tc<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf((float)HD);
  const int n_qt = (s + kTcBlockQ - 1) / kTcBlockQ;
  const int n_kt = (s + kTcBlockK - 1) / kTcBlockK;
  fa_bwd_dq_tc<HD><<<(unsigned)((long)b * h * n_qt), kTcWarps * 32, smem_dq,
                     stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, dsum,
      static_cast<bf*>(dq), s, h, kvh, scale * kLog2e, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dkv_tc<HD><<<(unsigned)((long)n_kt * b * kvh), kTcWarps * 32,
                      smem_dkv, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, dsum,
      static_cast<bf*>(dk), static_cast<bf*>(dv), s, h, kvh, scale * kLog2e,
      scale);
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

template <bool kBf16>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* dsum,
                       void* dq, void* dk, void* dv, int b, int s, int h,
                       int kvh, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return kBf16 ? launch_bwd_tc_hd<32>(q, k, v, dout, lse, dsum, dq, dk,
                                          dv, b, s, h, kvh, stream)
                   : launch_bwd_f32_hd<32>(q, k, v, dout, lse, dsum, dq, dk,
                                           dv, b, s, h, kvh, stream);
    case 64:
      return kBf16 ? launch_bwd_tc_hd<64>(q, k, v, dout, lse, dsum, dq, dk,
                                          dv, b, s, h, kvh, stream)
                   : launch_bwd_f32_hd<64>(q, k, v, dout, lse, dsum, dq, dk,
                                           dv, b, s, h, kvh, stream);
    case 128:
      return kBf16 ? launch_bwd_tc_hd<128>(q, k, v, dout, lse, dsum, dq, dk,
                                           dv, b, s, h, kvh, stream)
                   : launch_bwd_f32_hd<128>(q, k, v, dout, lse, dsum, dq, dk,
                                            dv, b, s, h, kvh, stream);
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
// is f32 scratch [B, H, s]; dq, dk, dv in q's dtype.  Three launches
// (fa_bwd_dot, then dQ, then dK/dV) on one stream.
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
  const long rows = (long)b * s * h;
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  float* ds = static_cast<float*>(dsum);
  const float* l = static_cast<const float*>(lse);
  if (dtype == 1) {
    fa_bwd_dot<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), ds, s, h, hd, rows);
  } else {
    fa_bwd_dot<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), ds,
        s, h, hd, rows);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype == 1)
    return (int)launch_bwd<true>(q, k, v, dout, l, ds, dq, dk, dv, b, s, h,
                                 kvh, hd, st);
  return (int)launch_bwd<false>(q, k, v, dout, l, ds, dq, dk, dv, b, s, h,
                                kvh, hd, st);
}
