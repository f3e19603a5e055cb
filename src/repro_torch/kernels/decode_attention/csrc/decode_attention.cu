// Single-token GQA decode attention for Hopper (sm_90a), plain C ABI.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py
//   decode_attention_kernel (body _dec_kernel), the Pallas TPU kernel, in
//   its float32/bfloat16 mode.  The int8-cache mode of that kernel is not
//   ported here.
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
// so does this kernel.
//
// What bounds it on this card: each (b, kv-head) reads its min(kv_len, S)
// cached keys and values once and does 4*g*hd FLOPs per position, about
// 2 FLOPs a byte at g=2 in bf16 -- it is bound by device-memory bytes.
// Its design: one block per (b, kv-head), so the g query rows of a group
// share every K/V byte read; the sweep stops at min(kv_len[b], S) instead
// of sweeping all S; each warp streams its own 8-key chunks with the 32
// lanes on consecutive head_dim elements (coalesced 256-byte rows for
// hd=128 in bf16), keeps its own online-softmax state, and the 4 warps
// merge once at the end through shared memory.  At the engine's batch
// (B = n_slots = 8, KV = 8) that is 64 blocks for 132 SMs, so the card
// is not full: splitting S across blocks (split-K, with a second merge
// pass) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kChunk = 8;  // keys per warp step
constexpr unsigned kFull = 0xffffffffu;

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

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kWarps * 32)
    dec_fwd(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ kv_len,
            T* __restrict__ o, int s, int kvh, float sm_scale) {
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
  const T* kb = k + (long)b * s * row + (long)kh * HD + lane * E;
  const T* vb = v + (long)b * s * row + (long)kh * HD + lane * E;
  const T* qb = q + ((long)b * kvh * G + (long)kh * G) * HD + lane * E;

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
  T* ob = o + ((long)b * kvh * G + (long)kh * G) * HD;
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
    store(&ob[r * HD + d], num / fmaxf(den, 1e-20f));
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const T* q, const T* k, const T* v, const int* kv_len,
                      T* o, int b, int s, int kvh, int g, float scale,
                      cudaStream_t stream) {
  const dim3 grid((unsigned)(b * kvh)), block(kWarps * 32);
  switch (g) {
    case 1:
      dec_fwd<T, HD, 1><<<grid, block, 0, stream>>>(q, k, v, kv_len, o, s,
                                                    kvh, scale);
      break;
    case 2:
      dec_fwd<T, HD, 2><<<grid, block, 0, stream>>>(q, k, v, kv_len, o, s,
                                                    kvh, scale);
      break;
    case 4:
      dec_fwd<T, HD, 4><<<grid, block, 0, stream>>>(q, k, v, kv_len, o, s,
                                                    kvh, scale);
      break;
    case 8:
      dec_fwd<T, HD, 8><<<grid, block, 0, stream>>>(q, k, v, kv_len, o, s,
                                                    kvh, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, void* o, int b, int s, int h, int kvh,
                   int hd, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  const int g = h / kvh;
  const float scale = 1.f / sqrtf((float)hd);
  switch (hd) {
    case 32:
      return launch_hd<T, 32>(qp, kp, vp, kv_len, op, b, s, kvh, g, scale,
                              stream);
    case 64:
      return launch_hd<T, 64>(qp, kp, vp, kv_len, op, b, s, kvh, g, scale,
                              stream);
    case 128:
      return launch_hd<T, 128>(qp, kp, vp, kv_len, op, b, s, kvh, g, scale,
                               stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* kv_len,
                                      void* o, int b, int s, int h, int kvh,
                                      int hd, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || kvh <= 0 || h % kvh != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, lens, o, b, s, h, kvh, hd, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, lens, o, b, s, h, kvh, hd,
                                      st);
  return (int)cudaErrorInvalidValue;
}
