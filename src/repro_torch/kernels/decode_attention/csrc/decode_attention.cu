// Single-token GQA decode attention for Hopper (sm_90a), plain C ABI.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py
//   decode_attention_kernel (body _dec_kernel), the Pallas TPU kernel, in
//   all its modes: the bfloat16 cache (repro_decode_attention, kernel
//   dec_split), the float32 cache (repro_decode_attention, kernel
//   dec_fwd) and the int8 cache (repro_decode_attention_int8, kernel
//   dec_split; kernel.py:41-43, :98-111).
//
// What it computes: q [B,1,H,hd], k/v [B,S,KV,hd] (row-major, contiguous),
// kv_len [B] int32 -> o [B,1,H,hd] in q's dtype.  Query head h = kh*g + r
// (g = H/KV) attends to the cache positions < kv_len[b] of kv-head kh,
// with f32 online softmax and accumulation, -1e30 as the mask value and
// max(l, 1e-20) as the denominator floor, as in the reference.  A kv_len
// above S counts all S positions as valid, as the reference's mask
// `arange(S) < kv_len` does: the engine's gang decode reaches it when a
// sequence runs past the cache.  A kv_len below 1 masks every position,
// which the reference turns into a uniform average over all S positions;
// so do both kernels.
//
// int8 mode: k/v are int8 [B,S,KV,hd] with per-token-per-head bf16 scales
// k_scale/v_scale [B,S,KV] (the engine's cache layout; the Pallas wrapper
// transposes them to [B,KV,S], this kernel reads them in place with a
// stride of KV between positions).  Each cached row is dequantized in f32
// registers (int8 * scale) right after its load, so the cache crosses the
// memory bus at one byte a value plus two bytes of scale per row.  The
// output is stored in q's dtype: for a bf16 q (the serving path) that is
// the Pallas kernel's bf16 output; for an f32 q the Pallas kernel rounds
// through bf16 first and this kernel does not, matching the JAX model's
// f32 decode instead (that rounding, on top of the f32 dequantization,
// moved a cached int8 scale of the reduced gemma-7b test model by one
// bf16 step against the JAX model).
//
// What bounds it on this card: each (b, kv-head) reads its
// min(kv_len, S) cached keys and values once and does 4*g*hd FLOPs per
// position, about 2 FLOPs a byte (bf16 at g=2, int8 at g=1): bound by
// device-memory bytes.  At the serving shapes the cache is small (19.1
// MB for qwen3-0.6b's 8 slots, 0.0057 ms at 3.35 TB/s; 82.8 MB for
// llama-2-7b's int8 cache), so the other limit is latency: how many bytes
// are in flight at once, and the fixed costs of one launch.
//
// dec_split (bf16 and int8 caches; one kernel, templated over the cache
// element C), built so that many bytes are in flight:
//  - loads: a lane loads 16 bytes of a row -- 8 bf16 or 16 int8 values --
//    so at hd=128 a row is 16 lanes (bf16) or 8 (int8) and one warp load
//    covers 2 or 4 rows; each warp issues 16 rows of K and the same 16
//    rows of V (and, for int8, their scales) before it computes
//    anything, so K's and V's latencies overlap;
//  - conversion, exact and off the slow conversion unit: bf16 -> f32 is
//    a 16-bit shift; int8 -> f32 a byte permute into the mantissa of 2^23
//    and one subtraction;
//  - scores: each lane takes a 16-byte partial dot product, reduced in
//    log2(lanes per row) shuffles over the row's lanes; each group of
//    lanes keeps its own online-softmax state over the rows it loads,
//    merged once after the sweep;
//  - split-S across a thread-block cluster: the grid is (b, kv-head,
//    split) with a cluster of kSplit = 8 blocks along the split; each
//    block takes ceil(len / 8) positions rounded up to its 64 rows per
//    iteration, so short and long rows both spread over 8 SMs (qwen3-0.6b
//    at B=8: 512 blocks instead of 64; llama-2-7b: 2,048 instead of 256).
//    Each block leaves its merged (m, l, acc[g][hd]) in shared memory;
//    after a cluster barrier rank 0 reads the 8 partials through
//    distributed shared memory in rank order and writes o.  One launch
//    per call, no scratch in device memory, no state between calls, and
//    a fixed merge order: repeated calls give identical bits.  A block
//    with no positions contributes l = 0.
//
// dec_fwd (float32 cache; checked on the card, launched on no serving
// path): one block per (b, kv-head), so the g query rows of a group share
// every K/V byte read; the sweep stops at min(kv_len[b], S); each warp
// streams its own 8-key chunks with the 32 lanes on consecutive head_dim
// elements, keeps its own online-softmax state, and the 4 warps merge once
// at the end through shared memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kChunk = 8;  // keys per warp step (dec_fwd)
constexpr unsigned kFull = 0xffffffffu;

// dec_split (tests/test_torch_kernels.py reads kSplit, kWarps and
// kWarpRows from this file to hold the split on the CPU)
constexpr int kSplit = 8;       // blocks (one cluster) per (b, kv-head)
constexpr int kWarpRows = 16;   // cache rows per warp per iteration
constexpr int kBlockRows = kWarps * kWarpRows;  // 64: a split's granule

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// E contiguous elements starting at p, as f32
template <int E>
__device__ __forceinline__ void load_row(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < E; ++i) out[i] = p[i];
}

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
  if constexpr (E % 2 == 0) {
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const float2 f = __bfloat1622float2(p2[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) out[i] = __bfloat162float(p[i]);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD, int G>
__global__ void __launch_bounds__(kWarps * 32)
    dec_fwd(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const int* __restrict__ kv_len,
            float* __restrict__ o, int s, int kvh, float sm_scale) {
  constexpr int E = HD / 32;  // head_dim elements per lane: lane*E + i
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][HD];

  const int b = blockIdx.x / kvh, kh = blockIdx.x % kvh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int len = kv_len[b];
  const bool none = len <= 0;  // every position masked
  len = none ? s : min(len, s);

  const long row = (long)kvh * HD;  // stride between cache positions
  const float* kb = k + (long)b * s * row + (long)kh * HD + lane * E;
  const float* vb = v + (long)b * s * row + (long)kh * HD + lane * E;
  const float* qb = q + ((long)b * kvh * G + (long)kh * G) * HD + lane * E;

  float qr[G][E], m[G], l[G], acc[G][E];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    load_row<E>(qb + r * HD, qr[r]);
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[r][i] = 0.f;
  }

  for (int c0 = warp * kChunk; c0 < len; c0 += kWarps * kChunk) {
    float kf[kChunk][E];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (c0 + j < len) {
        load_row<E>(kb + (c0 + j) * row, kf[j]);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) kf[j][i] = 0.f;
      }
    }
    float sc[G][kChunk];
#pragma unroll
    for (int r = 0; r < G; ++r)
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float acc_d = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) acc_d += qr[r][i] * kf[j][i];
        sc[r][j] = acc_d;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < G; ++r)
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          sc[r][j] += __shfl_xor_sync(kFull, sc[r][j], off);

    float vf[kChunk][E];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (c0 + j < len) {
        load_row<E>(vb + (c0 + j) * row, vf[j]);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) vf[j][i] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float m_tile = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        sc[r][j] = none ? kNegInf : sc[r][j] * sm_scale;
        if (c0 + j < len) m_tile = fmaxf(m_tile, sc[r][j]);
      }
      const float m_new = fmaxf(m[r], m_tile);
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = (c0 + j < len) ? expf(sc[r][j] - m_new) : 0.f;
        psum += p;
#pragma unroll
        for (int i = 0; i < E; ++i) acc[r][i] += p * vf[j][i];
      }
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < E; ++i) sm_acc[warp][r][lane * E + i] = acc[r][i];
  }
  __syncthreads();
  float* ob = o + ((long)b * kvh * G + (long)kh * G) * HD;
  for (int e = threadIdx.x; e < G * HD; e += kWarps * 32) {
    const int r = e / HD, d = e % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][r] - mx);
      den += sm_l[w][r] * c;
      num += sm_acc[w][r][d] * c;
    }
    ob[r * HD + d] = num / fmaxf(den, 1e-20f);
  }
}

// Four int8 values packed in a word -> f32, exactly: each byte, offset
// to unsigned (x + 128), becomes the low mantissa byte of 2^23, and
// 2^23 + 128 is subtracted.  A byte permute and an add per value, where
// the integer-to-float unit converts 16 values a clock per SM.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// Two bf16 values packed in a word (element 0 in the low half) -> f32,
// exactly: a bf16 is the high half of the f32 with the same value.
__device__ __forceinline__ void bf16x2_to_f32(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// One 16-byte lane load of a cached row, by cache element: the values it
// holds, their conversion to f32, and whether rows carry bf16 scales.
template <typename C>
struct CacheSeg;

template <>
struct CacheSeg<int8_t> {
  static constexpr int kVals = 16;
  static constexpr bool kScaled = true;
  static __device__ __forceinline__ void to_f32(int4 w, float* f) {
    i8x4_to_f32((uint32_t)w.x, f);
    i8x4_to_f32((uint32_t)w.y, f + 4);
    i8x4_to_f32((uint32_t)w.z, f + 8);
    i8x4_to_f32((uint32_t)w.w, f + 12);
  }
};

template <>
struct CacheSeg<__nv_bfloat16> {
  static constexpr int kVals = 8;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ void to_f32(int4 w, float* f) {
    bf16x2_to_f32((uint32_t)w.x, f);
    bf16x2_to_f32((uint32_t)w.y, f + 2);
    bf16x2_to_f32((uint32_t)w.z, f + 4);
    bf16x2_to_f32((uint32_t)w.w, f + 6);
  }
};

// T: q/o type (float or bf16); C: cache element (int8_t with bf16 scales,
// or bf16 without; k_scale/v_scale are then not read).  The grid is
// B * KV * kSplit blocks in clusters of kSplit; cluster rank = the
// block's split of S.
template <typename T, typename C, int HD, int G>
__global__ void __launch_bounds__(kWarps * 32)
    dec_split(const T* __restrict__ q, const C* __restrict__ k,
              const C* __restrict__ v,
              const __nv_bfloat16* __restrict__ k_scale,
              const __nv_bfloat16* __restrict__ v_scale,
              const int* __restrict__ kv_len, T* __restrict__ o, int s,
              int kvh, float sm_scale) {
  using Seg = CacheSeg<C>;
  constexpr int SEG = Seg::kVals;     // values per lane load: 16 bytes
  constexpr int LPR = HD / SEG;       // lanes per cached row
  constexpr int RPL = 32 / LPR;       // rows per warp load
  constexpr int U = kWarpRows / RPL;  // loads of K (and of V) per step
  // q in registers for up to 4 query rows a kv-head, else in shared
  // memory (SEG f32 of q and SEG of acc per row and lane)
  constexpr bool kQReg = G <= 4;
  __shared__ float sm_m[kWarps][G], sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][HD];
  __shared__ float part_m[G], part_l[G];  // this block's partial
  __shared__ float part_acc[G][HD];
  __shared__ float sm_q[kQReg ? 1 : G][HD];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bk = blockIdx.x / kSplit;  // (b, kv-head)
  const int b = bk / kvh, kh = bk % kvh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane / LPR, seg = lane % LPR;

  int len = kv_len[b];
  const bool none = len <= 0;  // every position masked
  len = none ? s : min(len, s);
  // this block's positions: ceil(len / kSplit) rounded up to kBlockRows
  const int chunk =
      ((len + kSplit - 1) / kSplit + kBlockRows - 1) / kBlockRows *
      kBlockRows;
  const int start = min(rank * chunk, len);
  const int end = min(start + chunk, len);

  const long row = (long)kvh * HD;  // elements between cache positions
  const C* kb = k + (long)b * s * row + (long)kh * HD + seg * SEG;
  const C* vb = v + (long)b * s * row + (long)kh * HD + seg * SEG;
  // scales of position 0 of this (b, kv-head); position c is c * kvh on
  const long sc0 = (long)b * s * kvh + kh;
  const T* qb = q + ((long)b * kvh * G + (long)kh * G) * HD;

  float qr[kQReg ? G : 1][SEG];
  if constexpr (kQReg) {
#pragma unroll
    for (int r = 0; r < G; ++r)
      load_row<SEG>(qb + r * HD + seg * SEG, qr[r]);
  } else {
    for (int e = threadIdx.x; e < G * HD; e += kWarps * 32)
      sm_q[e / HD][e % HD] = to_f32(qb[e]);
    __syncthreads();
  }

  float m[G], l[G], acc[G][SEG];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < SEG; ++i) acc[r][i] = 0.f;
  }

  // warp w takes rows [base, base + 16) of each 64-row step; load u of
  // a lane covers row base + u * RPL + rg, bytes seg * 16 .. + 15
  for (int base = start + warp * kWarpRows; base < end; base += kBlockRows) {
    int4 kr[U], vr[U];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + u * RPL + rg;
      if (c < end) {
        kr[u] = __ldg(reinterpret_cast<const int4*>(kb + c * row));
        vr[u] = __ldg(reinterpret_cast<const int4*>(vb + c * row));
        if constexpr (Seg::kScaled) {
          ksc[u] = __bfloat162float(k_scale[sc0 + (long)c * kvh]);
          vsc[u] = __bfloat162float(v_scale[sc0 + (long)c * kvh]);
        }
      } else {
        kr[u] = vr[u] = make_int4(0, 0, 0, 0);
        ksc[u] = vsc[u] = 0.f;
      }
    }
    float sc[G][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[SEG];
      Seg::to_f32(kr[u], kf);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
          if constexpr (kQReg) {
            dot += qr[r][i] * kf[i];
          } else {
            dot += sm_q[r][seg * SEG + i] * kf[i];
          }
        }
        sc[r][u] = dot;
      }
    }
    // sum the partial dot products over the row's LPR lanes
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < G; ++r)
#pragma unroll
        for (int u = 0; u < U; ++u)
          sc[r][u] += __shfl_xor_sync(kFull, sc[r][u], off);

    float pw[G][U];  // softmax weight (times the V row's scale)
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float m_tile = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if constexpr (Seg::kScaled) {
          sc[r][u] = none ? kNegInf : sc[r][u] * ksc[u] * sm_scale;
        } else {
          sc[r][u] = none ? kNegInf : sc[r][u] * sm_scale;
        }
        if (base + u * RPL + rg < end) m_tile = fmaxf(m_tile, sc[r][u]);
      }
      const float m_new = fmaxf(m[r], m_tile);
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p =
            (base + u * RPL + rg < end) ? expf(sc[r][u] - m_new) : 0.f;
        psum += p;
        if constexpr (Seg::kScaled) {
          pw[r][u] = p * vsc[u];
        } else {
          pw[r][u] = p;
        }
      }
#pragma unroll
      for (int i = 0; i < SEG; ++i) acc[r][i] *= alpha;
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[SEG];
      Seg::to_f32(vr[u], vf);
#pragma unroll
      for (int r = 0; r < G; ++r)
#pragma unroll
        for (int i = 0; i < SEG; ++i) acc[r][i] += pw[r][u] * vf[i];
    }
  }

  // merge the lane groups of a warp (lanes with the same seg)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float mo = __shfl_xor_sync(kFull, m[r], off);
      const float lo = __shfl_xor_sync(kFull, l[r], off);
      const float mx = fmaxf(m[r], mo);
      const float a = expf(m[r] - mx), c = expf(mo - mx);
      l[r] = l[r] * a + lo * c;
#pragma unroll
      for (int i = 0; i < SEG; ++i)
        acc[r][i] =
            acc[r][i] * a + __shfl_xor_sync(kFull, acc[r][i], off) * c;
      m[r] = mx;
    }
  if (rg == 0) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
#pragma unroll
      for (int i = 0; i < SEG; ++i)
        sm_acc[warp][r][seg * SEG + i] = acc[r][i];
      if (seg == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();
  // merge the warps into this block's partial
  for (int e = threadIdx.x; e < G * HD; e += kWarps * 32) {
    const int r = e / HD, d = e % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][r] - mx);
      den += sm_l[w][r] * c;
      num += sm_acc[w][r][d] * c;
    }
    part_acc[r][d] = num;
    if (d == 0) {
      part_m[r] = mx;
      part_l[r] = den;
    }
  }
  cluster.sync();  // every block's partial is written
  if (rank == 0) {
    T* ob = o + ((long)b * kvh * G + (long)kh * G) * HD;
    for (int e = threadIdx.x; e < G * HD; e += kWarps * 32) {
      const int r = e / HD, d = e % HD;
      float pm[kSplit];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSplit; ++j) {
        pm[j] = *cluster.map_shared_rank(&part_m[r], j);
        mx = fmaxf(mx, pm[j]);
      }
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int j = 0; j < kSplit; ++j) {
        const float c = expf(pm[j] - mx);
        den += *cluster.map_shared_rank(&part_l[r], j) * c;
        num += *cluster.map_shared_rank(&part_acc[r][d], j) * c;
      }
      store(&ob[r * HD + d], num / fmaxf(den, 1e-20f));
    }
  }
  cluster.sync();  // rank 0 has read every partial: shared memory may go
}

template <typename T, typename C, int HD, int G>
cudaError_t launch_split(const T* q, const C* k, const C* v,
                         const __nv_bfloat16* k_scale,
                         const __nv_bfloat16* v_scale, const int* kv_len,
                         T* o, int b, int s, int kvh, float scale,
                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long)b * kvh * kSplit));
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dec_split<T, C, HD, G>, q, k, v, k_scale, v_scale, kv_len, o, s,
      kvh, scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, typename C, int HD>
cudaError_t launch_split_hd(const T* q, const C* k, const C* v,
                            const __nv_bfloat16* ks,
                            const __nv_bfloat16* vs, const int* kv_len,
                            T* o, int b, int s, int kvh, int g, float scale,
                            cudaStream_t stream) {
  switch (g) {
    case 1:
      return launch_split<T, C, HD, 1>(q, k, v, ks, vs, kv_len, o, b, s,
                                       kvh, scale, stream);
    case 2:
      return launch_split<T, C, HD, 2>(q, k, v, ks, vs, kv_len, o, b, s,
                                       kvh, scale, stream);
    case 4:
      return launch_split<T, C, HD, 4>(q, k, v, ks, vs, kv_len, o, b, s,
                                       kvh, scale, stream);
    case 8:
      return launch_split<T, C, HD, 8>(q, k, v, ks, vs, kv_len, o, b, s,
                                       kvh, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// dec_split over a cache of C (k_scale/v_scale only for int8)
template <typename T, typename C>
cudaError_t launch_split_t(const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale,
                           const int* kv_len, void* o, int b, int s, int h,
                           int kvh, int hd, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const C* kp = static_cast<const C*>(k);
  const C* vp = static_cast<const C*>(v);
  const __nv_bfloat16* ks = static_cast<const __nv_bfloat16*>(k_scale);
  const __nv_bfloat16* vs = static_cast<const __nv_bfloat16*>(v_scale);
  T* op = static_cast<T*>(o);
  const int g = h / kvh;
  const float scale = 1.f / sqrtf((float)hd);
  switch (hd) {
    case 32:
      return launch_split_hd<T, C, 32>(qp, kp, vp, ks, vs, kv_len, op, b, s,
                                       kvh, g, scale, stream);
    case 64:
      return launch_split_hd<T, C, 64>(qp, kp, vp, ks, vs, kv_len, op, b, s,
                                       kvh, g, scale, stream);
    case 128:
      return launch_split_hd<T, C, 128>(qp, kp, vp, ks, vs, kv_len, op, b,
                                        s, kvh, g, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int HD>
cudaError_t launch_fwd_hd(const float* q, const float* k, const float* v,
                          const int* kv_len, float* o, int b, int s, int kvh,
                          int g, float scale, cudaStream_t stream) {
  const dim3 grid((unsigned)(b * kvh)), block(kWarps * 32);
  switch (g) {
    case 1:
      dec_fwd<HD, 1><<<grid, block, 0, stream>>>(q, k, v, kv_len, o, s, kvh,
                                                 scale);
      break;
    case 2:
      dec_fwd<HD, 2><<<grid, block, 0, stream>>>(q, k, v, kv_len, o, s, kvh,
                                                 scale);
      break;
    case 4:
      dec_fwd<HD, 4><<<grid, block, 0, stream>>>(q, k, v, kv_len, o, s, kvh,
                                                 scale);
      break;
    case 8:
      dec_fwd<HD, 8><<<grid, block, 0, stream>>>(q, k, v, kv_len, o, s, kvh,
                                                 scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int* kv_len, void* o, int b, int s, int h,
                       int kvh, int hd, cudaStream_t stream) {
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  const int g = h / kvh;
  const float scale = 1.f / sqrtf((float)hd);
  switch (hd) {
    case 32:
      return launch_fwd_hd<32>(qp, kp, vp, kv_len, op, b, s, kvh, g, scale,
                               stream);
    case 64:
      return launch_fwd_hd<64>(qp, kp, vp, kv_len, op, b, s, kvh, g, scale,
                               stream);
    case 128:
      return launch_fwd_hd<128>(qp, kp, vp, kv_len, op, b, s, kvh, g, scale,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (dec_fwd), 1 = bfloat16 (dec_split), of q, k, v and
// o.  Returns the cudaError_t of the launch.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* kv_len,
                                      void* o, int b, int s, int h, int kvh,
                                      int hd, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || kvh <= 0 || h % kvh != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  if (dtype == 0)
    return (int)launch_fwd(q, k, v, lens, o, b, s, h, kvh, hd, st);
  if (dtype == 1)
    return (int)launch_split_t<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, lens, o, b, s, h, kvh, hd, st);
  return (int)cudaErrorInvalidValue;
}

// int8 cache: k/v int8 [B,S,KV,hd], k_scale/v_scale bf16 [B,S,KV].
// dtype (of q and o): 0 = float32, 1 = bfloat16.  Returns the
// cudaError_t of the launch.
extern "C" int repro_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* kv_len, void* o, int b, int s, int h,
    int kvh, int hd, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || kvh <= 0 || h % kvh != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  if (dtype == 0)
    return (int)launch_split_t<float, int8_t>(q, k, v, k_scale, v_scale,
                                              lens, o, b, s, h, kvh, hd, st);
  if (dtype == 1)
    return (int)launch_split_t<__nv_bfloat16, int8_t>(
        q, k, v, k_scale, v_scale, lens, o, b, s, h, kvh, hd, st);
  return (int)cudaErrorInvalidValue;
}
