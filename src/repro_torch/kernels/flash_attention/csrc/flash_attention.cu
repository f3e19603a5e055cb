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
// Skv % block_k == 0, this kernel masks ragged tails itself (query rows
// >= Sq are computed on zeros and never stored; keys >= Skv are loaded as
// zeros and masked), so the engine's batch-1 prefill takes any prompt
// length.
//
// What bounds it on this card: at the prefill shapes of qwen3-0.6b
// (H=16, KV=8, hd=128, Sq of a few hundred) the causal work is about
// 2*Sq^2*H*hd FLOPs against a few MB of q/k/v, so the bound is the
// tensor cores' bf16 rate.  This first kernel does not reach for it: the
// two products run on the CUDA cores in f32 out of shared memory, so it
// is bound by f32 FMA issue and shared-memory bandwidth, far above the
// tensor-core bound.  Its design keeps what matters for being right and
// not wasteful: one block per (b, q-head, 16-row q tile) so a prompt of
// a few hundred tokens already gives ~900 blocks for 132 SMs; K/V tiles
// of 32 keys are staged once in shared memory and shared by the 16 rows;
// the K tile is padded to hd+1 floats a row so that lane j reading key j
// hits 32 distinct banks; the KV sweep stops at the causal limit of the
// tile's last row.  wgmma on bf16 tiles fed by TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kRows = 4;                 // query rows per warp
constexpr int kBlockQ = kWarps * kRows;  // 16 query rows per block
constexpr int kBlockK = 32;              // keys per tile: one per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
    fa_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
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
  const T* qb = q + (long)b * sq * q_stride + (long)hi * HD;
  const T* kb = k + (long)b * skv * kv_stride + (long)kh * HD;
  const T* vb = v + (long)b * skv * kv_stride + (long)kh * HD;

  for (int e = tid; e < kBlockQ * HD; e += kWarps * 32) {
    const int r = e / HD, d = e % HD, qp = q0 + r;
    qs[r][d] = qp < sq ? to_f32(qb[qp * q_stride + d]) : 0.f;
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
      ks[j][d] = ok ? to_f32(kb[key * kv_stride + d]) : 0.f;
      vs[j][d] = ok ? to_f32(vb[key * kv_stride + d]) : 0.f;
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

  T* ob = o + (long)b * sq * q_stride + (long)hi * HD;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    if (qp >= sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int i = 0; i < E; ++i)
      store(&ob[qp * q_stride + lane + 32 * i], acc[r][i] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int skv, int h, int kvh, int hd,
                   int causal, int q_offset, cudaStream_t stream) {
  const int n_qt = (sq + kBlockQ - 1) / kBlockQ;
  const dim3 grid((unsigned)((long)b * h * n_qt));
  const dim3 block(kWarps * 32);
  const float scale = 1.f / sqrtf((float)hd);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (hd) {
    case 32:
      fa_fwd<T, 32><<<grid, block, 0, stream>>>(qp, kp, vp, op, sq, skv, h,
                                                kvh, causal, q_offset, scale);
      break;
    case 64:
      fa_fwd<T, 64><<<grid, block, 0, stream>>>(qp, kp, vp, op, sq, skv, h,
                                                kvh, causal, q_offset, scale);
      break;
    case 128:
      fa_fwd<T, 128><<<grid, block, 0, stream>>>(qp, kp, vp, op, sq, skv, h,
                                                 kvh, causal, q_offset, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int b, int sq,
                                     int skv, int h, int kvh, int hd,
                                     int dtype, int causal, int q_offset,
                                     void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || kvh <= 0 || h % kvh != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, b, sq, skv, h, kvh, hd, causal,
                              q_offset, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, b, sq, skv, h, kvh, hd,
                                      causal, q_offset, s);
  return (int)cudaErrorInvalidValue;
}
