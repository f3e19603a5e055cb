// Mamba-1 selective scan for Hopper (sm_90a), plain C ABI.
//
// Replaces: src/repro/kernels/mamba_scan/kernel.py mamba_scan_kernel (body
//   _scan_kernel), the Pallas TPU kernel; and, for training, its gradient
//   (scan_bwd below; the forward's kStates flag saves the chunk states it
//   starts from).
//
// What it computes: xc, dt [B,S,di]; b, c [B,S,ds]; a_log [di,ds] f32;
// d [di] f32 (all row-major, contiguous) -> y [B,S,di] in xc's dtype and
// h_final [B,di,ds] f32.  With a = -exp(a_log) and h = 0 at the start,
// each step t does
//   h = exp(dt_t * a) * h + (dt_t * x_t) * b_t     (per channel, state)
//   y_t = sum_ds(h * c_t) + d * x_t
// all in f32, as src/repro/kernels/mamba_scan/ref.py does; exp(dt * a) is
// taken as exp2(dt * (a * log2 e)) on the special-function unit, with
// a * log2 e computed once per (channel, state).  Each of xc, dt, b and c
// is float32 or bfloat16 on its own (the model passes bf16 xc/b/c with an
// f32 dt).  Exactly S steps run for any S: the Pallas kernel's
// `s % chunk == 0` is not needed, and padding the sequence would change
// h_final (a padded step has dt = softplus(dt_bias) != 0).  Any a_log:
// nothing assumes the initial A_log = log(1..ds).
//
// What bounds it on this card: every input is read once and y written
// once -- at falcon-mamba-7b's prefill (B=1, S=1024, di=8192, ds=16, f32
// dt) 68.3 MB, 0.020 ms at 3.35 TB/s -- against ~7 f32 operations per
// (step, channel, state), 0.94 GFLOP or 0.014 ms at the 67 TFLOP/s f32
// rate.  Below both lies a third floor: one exponential per (step,
// channel, state), 134,217,728 at that shape, on special-function units
// that give 16 results a clock per SM -- 0.032 ms at 1.98 GHz on 132 SMs.
// The sweep over S is sequential per channel, so the card is filled by
// channels alone: di * B sequences.
//
// Its design:
//  - kLanes = 4 lanes per channel, each holding ds/4 states in registers
//    for the whole sweep (the Pallas kernel's VMEM state tile): the sum
//    over ds is mostly a sum in registers, and a channel's dt * x and
//    d * x are formed by 4 lanes, not ds.  A block of 256 threads covers
//    64 channels; B=1, di=8192 is 128 blocks, 1,024 warps.  S is not
//    split: a chunked parallel scan would make each segment's y wait for
//    the state carried in, which costs a second exponential per element.
//  - Each lane keeps its partial sum_ds(h * c) of the 8 steps of a group
//    in registers (lane 0 of a channel starts from d * x); once per group
//    a reduce-scatter over the channel's 4 lanes (2 exchanges, 6
//    shuffles) leaves each lane y of 2 steps, written over x in shared
//    memory and stored to y in coalesced 16-byte rows once per chunk.
//  - Staging, a ring of kStages = 3 chunks of 64 steps: x, dt, b and c go
//    from device memory to shared memory as 16-byte pieces (64 channels a
//    row) through cp.async, issued two chunks ahead of the sweep, so
//    their latency hides behind it (a prefetch into registers does not:
//    the barrier before the sweep waits for it, or the compiler moves it
//    past the sweep).  The bf16 arrays of a landed chunk are widened to
//    f32 once (a 16-bit shift, exact) into a work buffer; b and c are
//    read in the sweep as broadcast float4s.  A piece that is not 16-byte
//    aligned or runs past di or S is loaded element by element, its
//    missing elements zero.
//  - The steps of a short last group past S leave h as it is (a factor of
//    exactly 1 and an input of 0).
// What holds it back (measured on the card, PERF.md): the sweep, not
// memory -- about 30 instructions a step per warp at 2 warps per
// scheduler, whose dependent chains (shared load, exp2, the state's
// multiply-add) leave the schedulers idle half the time, and the
// per-chunk barriers, widening and stores, which do not overlap it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// tests/test_torch_mamba.py reads kLanes and kGroup from this file
constexpr int kLanes = 4;                 // lanes per channel
constexpr int kThreads = 256;
constexpr int kCh = kThreads / kLanes;    // 64 channels per block
constexpr int kChunk = 64;                // timesteps per staged chunk
constexpr int kGroup = 8;                 // timesteps per reduce-scatter
constexpr int kStages = 3;                // chunks staged at once
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kGroup % kLanes == 0 && kChunk % kGroup == 0, "groups");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 16 bytes of an f32 (4 values) or bf16 (8 values) array from element
// e on, n of them valid, loaded element by element, the missing ones zero
__device__ __forceinline__ int4 load16(const void* base, long e, int n,
                                       bool bf16) {
  const char* p = static_cast<const char*>(base) + e * (bf16 ? 2 : 4);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (bf16) {
      const unsigned short* hp = reinterpret_cast<const unsigned short*>(p);
      const uint32_t lo = 2 * i < n ? hp[2 * i] : 0u;
      const uint32_t hi = 2 * i + 1 < n ? hp[2 * i + 1] : 0u;
      w[i] = lo | (hi << 16);
    } else {
      w[i] = i < n ? reinterpret_cast<const uint32_t*>(p)[i] : 0u;
    }
  }
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

// those 16 bytes into shared memory at dst: through cp.async when all are
// valid and aligned, else element by element
__device__ __forceinline__ void stage16(void* dst, const void* base, long e,
                                        int n, bool bf16) {
  const char* p = static_cast<const char*>(base) + e * (bf16 ? 2 : 4);
  if (n >= (bf16 ? 8 : 4) && aligned16(p)) {
    cp_async16(dst, p);
  } else {
    *static_cast<int4*>(dst) = load16(base, e, n, bf16);
  }
}

// 8 bf16 values (16 bytes) as f32 at dst (16-byte aligned shared
// memory); bf16 -> f32 is a 16-bit shift, exact
__device__ __forceinline__ void widen8(int4 r, float* dst) {
  float4* d = reinterpret_cast<float4*>(dst);
  const uint32_t w[4] = {(uint32_t)r.x, (uint32_t)r.y, (uint32_t)r.z,
                         (uint32_t)r.w};
  d[0] = make_float4(__uint_as_float(w[0] << 16),
                     __uint_as_float(w[0] & 0xffff0000u),
                     __uint_as_float(w[1] << 16),
                     __uint_as_float(w[1] & 0xffff0000u));
  d[1] = make_float4(__uint_as_float(w[2] << 16),
                     __uint_as_float(w[2] & 0xffff0000u),
                     __uint_as_float(w[3] << 16),
                     __uint_as_float(w[3] & 0xffff0000u));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// f32 values at src (shared memory) -> 16 bytes of an f32 or bf16 array
// from element e on, n of them valid
__device__ __forceinline__ void store16(void* base, long e, int n, bool bf16,
                                        const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  if (bf16) {
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(base) + e;
    if (n >= 8 && aligned16(p)) {
      *reinterpret_cast<uint4*>(p) = make_uint4(
          bf16x2(a.x, a.y), bf16x2(a.z, a.w), bf16x2(b.x, b.y),
          bf16x2(b.z, b.w));
    } else {
      const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < n) p[i] = __float2bfloat16(f[i]);
    }
  } else {
    float* p = static_cast<float*>(base) + e;
    if (n >= 4 && aligned16(p)) {
      *reinterpret_cast<float4*>(p) = a;
    } else {
      const float f[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < n) p[i] = f[i];
    }
  }
}

template <int N>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if constexpr (N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

// One group of kGroup steps for one lane: NS states of channel lc (states
// n0 .. n0 + NS - 1) from step t0 of the staged chunk on; then y of the
// group, reduced over the channel's kLanes lanes by a reduce-scatter
// (lane sub keeps steps sub * kGroup / kLanes on), written over x.
// kTail: steps at and past `steps` leave h unchanged.
template <int DS, int NS, bool kTail>
__device__ __forceinline__ void group(float* xs, const float* dts,
                                      const float* bs, const float* cs,
                                      int t0, int lc, int sub, int steps,
                                      float dsel, const float* a2, float* h) {
  float p[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int t = t0 + u;
    const float x = xs[t * kCh + lc], dtt = dts[t * kCh + lc];
    const float dtx = dtt * x;
    float bv[NS], cv[NS];
    lds<NS>(bs + t * DS + sub * NS, bv);
    lds<NS>(cs + t * DS + sub * NS, cv);
    float acc = dsel * x;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float e = (kTail && t >= steps) ? 1.f : ex2(dtt * a2[j]);
      h[j] = fmaf(e, h[j], dtx * bv[j]);
      acc = fmaf(h[j], cv[j], acc);
    }
    p[u] = acc;
  }
  // halve the steps held at each exchange: the lane with the exchange's
  // bit of sub set keeps the upper half
#pragma unroll
  for (int off = kLanes / 2, n = kGroup / 2; off >= 1; off /= 2, n /= 2) {
    const bool hi = sub & off;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const float send = hi ? p[j] : p[j + n];
      const float keep = hi ? p[j + n] : p[j];
      p[j] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
  // y over x: the channel's lanes have read x of the group's steps, all
  // before the exchanges above
  constexpr int kOwn = kGroup / kLanes;
#pragma unroll
  for (int j = 0; j < kOwn; ++j) xs[(t0 + sub * kOwn + j) * kCh + lc] = p[j];
}

// kStates (training): also write the state entering each chunk, h_chunks
// [B, ceil(S / kChunk), di, ds] f32, which scan_bwd recomputes from
template <int DS, bool kStates>
__global__ void __launch_bounds__(kThreads, 1)
    scan_fwd(const void* __restrict__ xc, const void* __restrict__ dt,
             const void* __restrict__ bm, const void* __restrict__ cm,
             const float* __restrict__ a_log, const float* __restrict__ dd,
             void* __restrict__ y, float* __restrict__ h_final, int s,
             int di, bool x_bf16, bool dt_bf16, bool b_bf16, bool c_bf16,
             float* __restrict__ h_chunks) {
  constexpr int NS = DS / kLanes;  // states per lane
  constexpr int kBuf = 2 * kChunk * kCh + 2 * kChunk * DS;  // floats
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int bi = blockIdx.y, c0 = blockIdx.x * kCh;
  const int lc = tid / kLanes, sub = tid % kLanes;
  const int ch = c0 + lc, n0 = sub * NS;
  const bool valid = ch < di;  // the ragged channel edge
  float a2[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    a2[j] = valid ? -expf(a_log[(long)ch * DS + n0 + j]) * kLog2e : 0.f;
    h[j] = 0.f;
  }
  const float dsel = valid && sub == 0 ? dd[ch] : 0.f;
  const long row0 = (long)bi * s;  // row of step 0 of this sequence
  const int n_chunks = (s + kChunk - 1) / kChunk;

  // a stage holds a chunk as loaded: x and dt [kChunk][kCh], b and c
  // [kChunk][DS], each in its own dtype in room for f32; `work` holds the
  // bf16 ones widened to f32
  float* work = smem + kStages * kBuf;
  constexpr int kTile = kChunk * kCh;
  constexpr int kOff[4] = {0, kTile, 2 * kTile, 2 * kTile + kChunk * DS};
  const bool bf16[4] = {x_bf16, dt_bf16, b_bf16, c_bf16};
  const bool any_bf16 = x_bf16 || dt_bf16 || b_bf16 || c_bf16;

  // chunk t0 into stage st, 16 bytes a piece: x and dt piece g is row
  // g >> lg, columns from (g & (2^lg - 1)) * v on (lg = log2(kCh / v),
  // v = 8 bf16 or 4 f32 values); b and c piece g is the chunk's values
  // from g * v on
  auto issue = [&](int t0, float* st) {
    const int steps = min(kChunk, s - t0);
    const void* src[4] = {xc, dt, bm, cm};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int lg = bf16[a] ? 3 : 4, v = bf16[a] ? 8 : 4;
      char* dst = reinterpret_cast<char*>(st + kOff[a]);
      for (int g = tid; g < kChunk << lg; g += kThreads) {
        const int t = g >> lg, col = (g & ((1 << lg) - 1)) * v;
        const int n = t < steps ? min(v, di - c0 - col) : 0;
        stage16(dst + g * 16, src[a], (row0 + t0 + t) * di + c0 + col, n,
                bf16[a]);
      }
    }
#pragma unroll
    for (int a = 2; a < 4; ++a) {
      const int v = bf16[a] ? 8 : 4;
      char* dst = reinterpret_cast<char*>(st + kOff[a]);
      for (int g = tid; g * v < kChunk * DS; g += kThreads)
        stage16(dst + g * 16, src[a], (row0 + t0) * DS + g * v,
                steps * DS - g * v, bf16[a]);
    }
  };

  // chunk i goes to stage i % kStages; one commit group a chunk (empty
  // past the last), so that chunk i has landed when at most kStages - 2
  // later groups are pending
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_chunks) issue(i * kChunk, smem + i * kBuf);
    cp_async_commit();
  }
  for (int i = 0; i < n_chunks; ++i) {
    const int t0 = i * kChunk, steps = min(kChunk, s - t0);
    float* cur = smem + (i % kStages) * kBuf;
    if constexpr (kStates) {
      if (valid) {
        float* hc = h_chunks + (((long)bi * n_chunks + i) * di + ch) * DS + n0;
#pragma unroll
        for (int j = 0; j < NS; ++j) hc[j] = h[j];
      }
    }
    cp_async_wait<kStages - 2>();  // this thread's pieces of chunk i
    __syncthreads();  // everyone's pieces; chunk i-1's y has been stored
    // chunks i+1 .. i+kStages-1 in flight during the sweep
    const int ahead = i + kStages - 1;
    if (ahead < n_chunks)
      issue(ahead * kChunk, smem + (ahead % kStages) * kBuf);
    cp_async_commit();
    if (any_bf16) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (!bf16[a]) continue;
        const int n = a < 2 ? kTile : kChunk * DS;
        const char* raw = reinterpret_cast<const char*>(cur + kOff[a]);
        for (int g = tid; g * 8 < n; g += kThreads)
          widen8(*reinterpret_cast<const int4*>(raw + g * 16),
                 work + kOff[a] + g * 8);
      }
      __syncthreads();
    }
    // f32 views of the chunk: x (then y), dt, b, c
    float* view[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      view[a] = (bf16[a] ? work : cur) + kOff[a];
#pragma unroll 1
    for (int t = 0; t < steps; t += kGroup) {
      if (t + kGroup <= steps) {
        group<DS, NS, false>(view[0], view[1], view[2], view[3], t, lc, sub,
                             steps, dsel, a2, h);
      } else {
        group<DS, NS, true>(view[0], view[1], view[2], view[3], t, lc, sub,
                            steps, dsel, a2, h);
      }
    }
    __syncthreads();  // y of this chunk is in view[0]
    const int lg = x_bf16 ? 3 : 4, v = x_bf16 ? 8 : 4;
    for (int g = tid; g < kChunk << lg; g += kThreads) {
      const int t = g >> lg, col = (g & ((1 << lg) - 1)) * v;
      const int n = t < steps ? min(v, di - c0 - col) : 0;
      if (n > 0)
        store16(y, (row0 + t0 + t) * di + c0 + col, n, x_bf16,
                view[0] + t * kCh + col);
    }
  }
  if (valid) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
      h_final[((long)bi * di + ch) * DS + n0 + j] = h[j];
  }
}


// -- backward (training) ------------------------------------------------------
//
// Replaces the gradient of src/repro/models/mamba.py's selective_scan, which
// the reference takes by jax.grad of plain jnp (its Pallas kernel has no
// VJP).  With g_t = dL/dh_t (per channel, state), e_t = exp(dt_t a) and
// dh_final the gradient of h_final as the starting condition, the reverse
// recursion is
//   g_t   = g_{t+1} e_{t+1} + dy_t c_t            (g_{S-1} = dh_final + ...)
//   dc_t  = sum_di dy_t h_t       db_t = sum_di g_t dt_t x_t
//   dx_t  = dt_t sum_ds g_t b_t + d dy_t
//   ddt_t = x_t sum_ds g_t b_t + sum_ds g_t h_{t-1} e_t a
//   da    = sum_{B,S} g_t h_{t-1} e_t dt_t,  da_log = da * a  (a = -exp(a_log))
//   dd    = sum_{B,S} dy_t x_t
// scan_bwd: a block of 256 threads holds 256 / ds channels of one sequence,
// one thread a (channel, state).  It walks the chunks of kChunk steps from
// the last to the first; for each it stages x, dt, dy, b and c (as f32) in
// shared memory, recomputes the chunk's kChunk states in registers from the
// state scan_fwd<kStates> wrote on entering it -- with the forward's own
// ex2.approx and fmaf, so they are the forward's states -- then sweeps the
// chunk in reverse, taking the second exponential of a step there.  Sums
// over ds are shuffles inside the channel's ds lanes; dx and ddt of the
// chunk are stored coalesced.  db and dc (sums over di) are reduced over a
// warp's channels by shuffles, over the block's warps in shared memory, and
// written as one partial a block; da and dd (sums over B and S) stay in
// registers over the sweep and are written as one partial a sequence.
// scan_bwd_reduce then sums the partials in a fixed order: no atomics, and
// the gradients are bit-equal from run to run.
//
// What bounds it on this card: the inputs read once and dx, ddt, db, dc
// written once (plus the chunk states) -- 117 MB at falcon-mamba-7b's
// B=1, S=1024, di=8192 with bf16 x/b/c/dy and f32 dt, 0.035 ms at 3.35
// TB/s.  The gradient needs exp(dt a) once a (step, channel, state):
// 134,217,728 on the special-function units, 0.032 ms at 16 a clock per
// SM, 1.98 GHz, 132 SMs, so the bound is the bytes.  This first version
// takes each exponential twice (once recomputing the chunk's states, once
// in the reverse sweep), the staging does not overlap the sweep, and the
// partials of db and dc (B * di / 16 * S * 16 floats each) go through
// device memory.

constexpr int kBwdThreads = 256;  // ops.py's BWD_THREADS reads this

__device__ __forceinline__ float ld_f(const void* p, long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st_f(void* p, long i, bool bf16, float x) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(p)[i] = x;
}

template <int DS>
__global__ void __launch_bounds__(kBwdThreads, 2)
    scan_bwd(const void* __restrict__ xc, const void* __restrict__ dt,
             const void* __restrict__ bm, const void* __restrict__ cm,
             const float* __restrict__ a_log, const float* __restrict__ dd,
             const void* __restrict__ dy, const float* __restrict__ h_chunks,
             const float* __restrict__ dh_final, void* __restrict__ dxc,
             void* __restrict__ ddt, float* __restrict__ db_part,
             float* __restrict__ dc_part, float* __restrict__ da_part,
             float* __restrict__ dd_part, int s, int di, bool x_bf16,
             bool dt_bf16, bool b_bf16, bool c_bf16) {
  constexpr int kCh = kBwdThreads / DS;  // channels a block
  constexpr int kWarpsB = kBwdThreads / 32;
  extern __shared__ __align__(16) float bwd_smem[];
  float* xs = bwd_smem;              // [kChunk][kCh]
  float* dts = xs + kChunk * kCh;    // [kChunk][kCh]
  float* dys = dts + kChunk * kCh;   // [kChunk][kCh]
  float* dxs = dys + kChunk * kCh;   // [kChunk][kCh]
  float* ddts = dxs + kChunk * kCh;  // [kChunk][kCh]
  float* bs = ddts + kChunk * kCh;   // [kChunk][DS]
  float* cs = bs + kChunk * DS;      // [kChunk][DS]
  float* wb = cs + kChunk * DS;      // [warps][kChunk][DS]
  float* wc = wb + kWarpsB * kChunk * DS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid / DS, n = tid % DS;
  const int bi = blockIdx.y, c0 = blockIdx.x * kCh, ch = c0 + cl;
  const bool valid = ch < di;  // the ragged channel edge
  const int n_chunks = (s + kChunk - 1) / kChunk;
  const long row0 = (long)bi * s;
  const float a = valid ? -expf(a_log[(long)ch * DS + n]) : 0.f;
  const float a2 = a * kLog2e;  // the forward's exponent factor
  const float dch = valid ? dd[ch] : 0.f;
  float g = valid && dh_final != nullptr
                ? dh_final[((long)bi * di + ch) * DS + n]
                : 0.f;
  float da_acc = 0.f, dd_acc = 0.f;

  for (int i = n_chunks - 1; i >= 0; --i) {
    const int t0 = i * kChunk, steps = min(kChunk, s - t0);
    __syncthreads();  // the previous chunk's buffers are consumed
    for (int e = tid; e < kChunk * kCh; e += kBwdThreads) {
      const int u = e / kCh, c = e % kCh;
      const bool ok = u < steps && c0 + c < di;
      const long at = (row0 + t0 + u) * di + c0 + c;
      xs[e] = ok ? ld_f(xc, at, x_bf16) : 0.f;
      dts[e] = ok ? ld_f(dt, at, dt_bf16) : 0.f;
      dys[e] = ok ? ld_f(dy, at, x_bf16) : 0.f;
    }
    for (int e = tid; e < kChunk * DS; e += kBwdThreads) {
      const bool ok = e / DS < steps;
      const long at = (row0 + t0) * DS + e;
      bs[e] = ok ? ld_f(bm, at, b_bf16) : 0.f;
      cs[e] = ok ? ld_f(cm, at, c_bf16) : 0.f;
    }
    __syncthreads();
    // the chunk's states as the forward computed them; steps past S have
    // dt = 0 (a factor of exactly 1) and x = 0, so they leave h unchanged
    const float h_in =
        valid ? h_chunks[(((long)bi * n_chunks + i) * di + ch) * DS + n]
              : 0.f;
    float hist[kChunk];
    float hc = h_in;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float x = xs[u * kCh + cl], dtt = dts[u * kCh + cl];
      const float dtx = dtt * x;
      hc = fmaf(ex2(dtt * a2), hc, dtx * bs[u * DS + n]);
      hist[u] = hc;
    }
    // the reverse sweep; g becomes dL/dh_t of step u
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      const float x = xs[u * kCh + cl], dtt = dts[u * kCh + cl];
      const float dyv = dys[u * kCh + cl];
      const float hprev = u > 0 ? hist[u - 1] : h_in;
      g = fmaf(dyv, cs[u * DS + n], g);
      float gb = g * (dtt * x);  // -> db over the channels
      float gc = dyv * hist[u];  // -> dc over the channels
      const float e = ex2(dtt * a2);
      const float de = g * hprev * e;
      float q1 = g * bs[u * DS + n];  // -> d(dt x) over the states
      float q2 = de * a;              // -> ddt through the decay
      da_acc = fmaf(de, dtt, da_acc);
      g *= e;
#pragma unroll
      for (int off = DS / 2; off >= 1; off >>= 1) {
        q1 += __shfl_xor_sync(kFull, q1, off);
        q2 += __shfl_xor_sync(kFull, q2, off);
      }
#pragma unroll
      for (int off = DS; off < 32; off <<= 1) {
        gb += __shfl_xor_sync(kFull, gb, off);
        gc += __shfl_xor_sync(kFull, gc, off);
      }
      if (n == 0) {
        dxs[u * kCh + cl] = fmaf(q1, dtt, dyv * dch);
        ddts[u * kCh + cl] = fmaf(q1, x, q2);
        dd_acc = fmaf(dyv, x, dd_acc);
      }
      if (lane < DS) {  // the warp's first channel holds the warp's sums
        wb[(warp * kChunk + u) * DS + n] = gb;
        wc[(warp * kChunk + u) * DS + n] = gc;
      }
    }
    __syncthreads();
    for (int e = tid; e < kChunk * kCh; e += kBwdThreads) {
      const int u = e / kCh, c = e % kCh;
      if (u < steps && c0 + c < di) {
        const long at = (row0 + t0 + u) * di + c0 + c;
        st_f(dxc, at, x_bf16, dxs[e]);
        st_f(ddt, at, dt_bf16, ddts[e]);
      }
    }
    for (int e = tid; e < kChunk * DS; e += kBwdThreads) {
      if (e / DS >= steps) continue;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsB; ++w) {
        sb += wb[w * kChunk * DS + e];
        sc += wc[w * kChunk * DS + e];
      }
      const long at =
          (((long)bi * gridDim.x + blockIdx.x) * s + t0) * DS + e;
      db_part[at] = sb;
      dc_part[at] = sc;
    }
  }
  if (valid) {
    da_part[((long)bi * di + ch) * DS + n] = da_acc;
    if (n == 0) dd_part[(long)bi * di + ch] = dd_acc;
  }
}

// The second pass: db, dc [B, S, DS] summed over the blocks' partials, and
// da_log [di, DS], dd [di] over the sequences', each in a fixed order.
template <int DS>
__global__ void __launch_bounds__(256)
    scan_bwd_reduce(const float* __restrict__ db_part,
                    const float* __restrict__ dc_part,
                    const float* __restrict__ da_part,
                    const float* __restrict__ dd_part,
                    const float* __restrict__ a_log, void* __restrict__ db,
                    void* __restrict__ dc, float* __restrict__ da_log,
                    float* __restrict__ dd_out, int bsz, int s, int di,
                    int nblk, bool b_bf16, bool c_bf16) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long per_seq = (long)s * DS;
  if (idx < bsz * per_seq) {
    const long bi = idx / per_seq, rest = idx % per_seq;
    const long base = bi * nblk * per_seq + rest;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < nblk; ++k) {
      sb += db_part[base + k * per_seq];
      sc += dc_part[base + k * per_seq];
    }
    st_f(db, idx, b_bf16, sb);
    st_f(dc, idx, c_bf16, sc);
  }
  if (idx < (long)di * DS) {
    float sa = 0.f;
    for (int bi = 0; bi < bsz; ++bi) sa += da_part[(long)bi * di * DS + idx];
    da_log[idx] = sa * -expf(a_log[idx]);
    if (idx % DS == 0) {
      const long ch = idx / DS;
      float sd = 0.f;
      for (int bi = 0; bi < bsz; ++bi) sd += dd_part[(long)bi * di + ch];
      dd_out[ch] = sd;
    }
  }
}

template <int DS, bool kStates>
cudaError_t launch(const void* xc, const void* dt, const void* b,
                   const void* c, const float* a_log, const float* d,
                   void* y, float* h_final, int bsz, int s, int di,
                   bool x_bf16, bool dt_bf16, bool b_bf16, bool c_bf16,
                   float* h_chunks, cudaStream_t stream) {
  // kStages stages and the f32 work buffer
  constexpr int smem =
      (kStages + 1) * (2 * kChunk * kCh + 2 * kChunk * DS) * 4;
  // per launch: the limit is per device, and a failure is not cached
  const cudaError_t attr = cudaFuncSetAttribute(
      scan_fwd<DS, kStates>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((di + kCh - 1) / kCh, bsz);
  scan_fwd<DS, kStates><<<grid, kThreads, smem, stream>>>(
      xc, dt, b, c, a_log, d, y, h_final, s, di, x_bf16, dt_bf16, b_bf16,
      c_bf16, h_chunks);
  return cudaGetLastError();
}

template <bool kStates>
cudaError_t launch_ds(const void* xc, const void* dt, const void* b,
                      const void* c, const void* a_log, const void* d,
                      void* y, void* h_final, int bsz, int s, int di, int ds,
                      int x_dtype, int dt_dtype, int b_dtype, int c_dtype,
                      void* h_chunks, void* stream) {
  const float* al = static_cast<const float*>(a_log);
  const float* dv = static_cast<const float*>(d);
  float* hf = static_cast<float*>(h_final);
  float* hc = static_cast<float*>(h_chunks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool xb = x_dtype == 1, dtb = dt_dtype == 1, bb = b_dtype == 1,
             cb = c_dtype == 1;
  switch (ds) {
    case 4:
      return launch<4, kStates>(xc, dt, b, c, al, dv, y, hf, bsz, s, di, xb,
                                dtb, bb, cb, hc, st);
    case 8:
      return launch<8, kStates>(xc, dt, b, c, al, dv, y, hf, bsz, s, di, xb,
                                dtb, bb, cb, hc, st);
    case 16:
      return launch<16, kStates>(xc, dt, b, c, al, dv, y, hf, bsz, s, di,
                                 xb, dtb, bb, cb, hc, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int DS>
cudaError_t launch_bwd(const void* xc, const void* dt, const void* b,
                       const void* c, const float* a_log, const float* d,
                       const void* dy, const float* h_chunks,
                       const float* dh_final, void* dxc, void* ddt, void* db,
                       void* dc, float* da_log, float* dd_out,
                       float* scratch, int bsz, int s, int di, bool x_bf16,
                       bool dt_bf16, bool b_bf16, bool c_bf16,
                       cudaStream_t stream) {
  constexpr int kCh = kBwdThreads / DS;
  constexpr int smem = (5 * kChunk * kCh + 2 * kChunk * DS +
                        2 * (kBwdThreads / 32) * kChunk * DS) *
                       4;
  const int nblk = (di + kCh - 1) / kCh;
  const long part = (long)bsz * nblk * s * DS;
  float* db_part = scratch;
  float* dc_part = db_part + part;
  float* da_part = dc_part + part;
  float* dd_part = da_part + (long)bsz * di * DS;
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd<DS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  scan_bwd<DS><<<dim3(nblk, bsz), kBwdThreads, smem, stream>>>(
      xc, dt, b, c, a_log, d, dy, h_chunks, dh_final, dxc, ddt, db_part,
      dc_part, da_part, dd_part, s, di, x_bf16, dt_bf16, b_bf16, c_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long n = std::max((long)bsz * s * DS, (long)di * DS);
  scan_bwd_reduce<DS><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      db_part, dc_part, da_part, dd_part, a_log, db, dc, da_log, dd_out, bsz,
      s, di, nblk, b_bf16, c_bf16);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int repro_mamba_scan(const void* xc, const void* dt,
                                const void* b, const void* c,
                                const void* a_log, const void* d, void* y,
                                void* h_final, int bsz, int s, int di,
                                int ds, int x_dtype, int dt_dtype,
                                int b_dtype, int c_dtype, void* stream) {
  if (bsz <= 0 || s <= 0 || di <= 0 || bsz > 65535) {
    return cudaErrorInvalidValue;
  }
  return (int)launch_ds<false>(xc, dt, b, c, a_log, d, y, h_final, bsz, s,
                               di, ds, x_dtype, dt_dtype, b_dtype, c_dtype,
                               nullptr, stream);
}

// The training forward: the same kernel, also writing h_chunks
// [B, ceil(S / 64), di, ds] f32, the state entering each 64-step chunk.
extern "C" int repro_mamba_scan_fwd_states(
    const void* xc, const void* dt, const void* b, const void* c,
    const void* a_log, const void* d, void* y, void* h_final, void* h_chunks,
    int bsz, int s, int di, int ds, int x_dtype, int dt_dtype, int b_dtype,
    int c_dtype, void* stream) {
  if (bsz <= 0 || s <= 0 || di <= 0 || bsz > 65535) {
    return cudaErrorInvalidValue;
  }
  return (int)launch_ds<true>(xc, dt, b, c, a_log, d, y, h_final, bsz, s, di,
                              ds, x_dtype, dt_dtype, b_dtype, c_dtype,
                              h_chunks, stream);
}

// The backward: dy in xc's dtype, dh_final f32 [B, di, ds] or null (zero);
// dxc, ddt, db, dc in their inputs' dtypes, da_log [di, ds] and dd [di]
// f32; scratch f32 of 2 * B * nblk * S * ds + B * di * (ds + 1) floats,
// nblk = ceil(di / (256 / ds)).  Two launches on one stream.
extern "C" int repro_mamba_scan_bwd(
    const void* xc, const void* dt, const void* b, const void* c,
    const void* a_log, const void* d, const void* dy, const void* h_chunks,
    const void* dh_final, void* dxc, void* ddt, void* db, void* dc,
    void* da_log, void* dd, void* scratch, int bsz, int s, int di, int ds,
    int x_dtype, int dt_dtype, int b_dtype, int c_dtype, void* stream) {
  if (bsz <= 0 || s <= 0 || di <= 0 || bsz > 65535) {
    return cudaErrorInvalidValue;
  }
  const float* al = static_cast<const float*>(a_log);
  const float* dv = static_cast<const float*>(d);
  const float* hc = static_cast<const float*>(h_chunks);
  const float* dhf = static_cast<const float*>(dh_final);
  float* dal = static_cast<float*>(da_log);
  float* ddo = static_cast<float*>(dd);
  float* scr = static_cast<float*>(scratch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool xb = x_dtype == 1, dtb = dt_dtype == 1, bb = b_dtype == 1,
             cb = c_dtype == 1;
  switch (ds) {
    case 4:
      return (int)launch_bwd<4>(xc, dt, b, c, al, dv, dy, hc, dhf, dxc, ddt,
                                db, dc, dal, ddo, scr, bsz, s, di, xb, dtb,
                                bb, cb, st);
    case 8:
      return (int)launch_bwd<8>(xc, dt, b, c, al, dv, dy, hc, dhf, dxc, ddt,
                                db, dc, dal, ddo, scr, bsz, s, di, xb, dtb,
                                bb, cb, st);
    case 16:
      return (int)launch_bwd<16>(xc, dt, b, c, al, dv, dy, hc, dhf, dxc, ddt,
                                 db, dc, dal, ddo, scr, bsz, s, di, xb, dtb,
                                 bb, cb, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
