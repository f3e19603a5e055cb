// Causal GQA FlashAttention-2 forward for Hopper (sm_90a), plain C ABI.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py
//   flash_attention_kernel (body _fa_kernel), the Pallas TPU kernel.
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

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    fa_fwd(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, int sq, int skv,
           int h, int kvh, int causal, int q_offset, float sm_scale) {
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
  }
}

// -- fa_fwd_tc: bf16 on the tensor cores ------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcBlockQ = 16 * kTcWarps;  // 64 query rows, 16 per warp
constexpr int kTcBlockK = 64;             // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

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
template <int HD>
__global__ void __launch_bounds__(kTcWarps * 32)
    fa_fwd_tc(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int sq, int skv, int h, int kvh,
              int causal, int q_offset, float scale_log2) {
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
    __nv_bfloat16* orow = ob + (long)qp * q_stride + 2 * t4;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
          __floats2bfloat162_rn(acc[d][2 * hr] * inv,
                                acc[d][2 * hr + 1] * inv);
  }
}

template <int HD>
cudaError_t launch_tc_hd(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* o, int b,
                         int sq, int skv, int h, int kvh, int causal,
                         int q_offset, cudaStream_t stream) {
  constexpr int smem = (kTcBlockQ + 4 * kTcBlockK) * HD * 2;  // Q + 2x K,V
  // per launch: the limit is per device, and a failure is not cached
  const cudaError_t attr = cudaFuncSetAttribute(
      fa_fwd_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int n_qt = (sq + kTcBlockQ - 1) / kTcBlockQ;
  const dim3 grid((unsigned)((long)b * h * n_qt)), block(kTcWarps * 32);
  fa_fwd_tc<HD><<<grid, block, smem, stream>>>(
      q, k, v, o, sq, skv, h, kvh, causal, q_offset,
      kLog2e / sqrtf((float)HD));
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int b, int sq, int skv, int h, int kvh, int hd,
                      int causal, int q_offset, cudaStream_t stream) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  switch (hd) {
    case 32:
      return launch_tc_hd<32>(qp, kp, vp, op, b, sq, skv, h, kvh, causal,
                              q_offset, stream);
    case 64:
      return launch_tc_hd<64>(qp, kp, vp, op, b, sq, skv, h, kvh, causal,
                              q_offset, stream);
    case 128:
      return launch_tc_hd<128>(qp, kp, vp, op, b, sq, skv, h, kvh, causal,
                               q_offset, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// f32 on the CUDA cores
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int b, int sq, int skv, int h, int kvh, int hd,
                       int causal, int q_offset, cudaStream_t stream) {
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
      fa_fwd<32><<<grid, block, 0, stream>>>(qp, kp, vp, op, sq, skv, h, kvh,
                                             causal, q_offset, scale);
      break;
    case 64:
      fa_fwd<64><<<grid, block, 0, stream>>>(qp, kp, vp, op, sq, skv, h, kvh,
                                             causal, q_offset, scale);
      break;
    case 128:
      fa_fwd<128><<<grid, block, 0, stream>>>(qp, kp, vp, op, sq, skv, h,
                                              kvh, causal, q_offset, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (fa_fwd), 1 = bfloat16 (fa_fwd_tc).  Returns the
// cudaError_t of the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int b, int sq,
                                     int skv, int h, int kvh, int hd,
                                     int dtype, int causal, int q_offset,
                                     void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || kvh <= 0 || h % kvh != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_f32(q, k, v, o, b, sq, skv, h, kvh, hd, causal,
                           q_offset, s);
  if (dtype == 1)
    return (int)launch_tc(q, k, v, o, b, sq, skv, h, kvh, hd, causal,
                          q_offset, s);
  return (int)cudaErrorInvalidValue;
}
