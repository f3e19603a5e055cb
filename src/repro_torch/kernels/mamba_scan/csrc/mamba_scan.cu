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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

namespace cg = cooperative_groups;

// tests/test_torch_mamba.py reads kLanes and kGroup from this file
constexpr int kLanes = 4;                 // lanes per channel
constexpr int kThreads = 256;
constexpr int kCh = kThreads / kLanes;    // 64 channels per block
constexpr int kChunk = 64;                // timesteps per staged chunk
constexpr int kGroup = 8;                 // timesteps per reduce-scatter
constexpr int kStages = 3;                // chunks staged at once
// training: the forward saves the state entering every kStateChunk-th step
// (ops.py's STATE_CHUNK reads this)
constexpr int kStateChunk = 16;
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

// kStates (training): also write the state entering every kStateChunk-th
// step, h_chunks [B, ceil(S / kStateChunk), di, ds] f32, which scan_bwd
// recomputes from
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
      if constexpr (kStates) {
        if (t % kStateChunk == 0 && valid) {
          const int n_saved = (s + kStateChunk - 1) / kStateChunk;
          float* hc = h_chunks +
                      (((long)bi * n_saved + (t0 + t) / kStateChunk) * di +
                       ch) * DS + n0;
#pragma unroll
          for (int j = 0; j < NS; ++j) hc[j] = h[j];
        }
      }
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
//
// What bounds it on this card: the inputs read once and dx, ddt, db, dc
// written once (the saved states counted one every 64 steps) -- at
// falcon-mamba-7b's B=1, S=1024, di=8192 with bf16 x/b/c/dy and f32 dt
// 127 MB, 0.038 ms at 3.35 TB/s.  That this kernel saves them every 16
// steps (below) adds 25 MB, its own cost, not the function's.  The
// gradient needs exp(dt a) once a (step, channel, state): 134,217,728 on
// the special-function units, 0.032 ms at 16 a clock per SM, 1.98 GHz, 132
// SMs.  So the bound is the bytes.
//
// scan_bwd's design:
//  - kBwdLanes = 8 lanes a channel (4 at ds 4), each holding ds/8 states in
//    registers, a block of 256 threads on 32 channels (64 at ds 4) of one
//    sequence, two blocks an SM: at B=1, di=8192, 256 blocks, 16 warps an
//    SM (scan_fwd's 4 lanes a channel give 8, and the sweep then waits on
//    its own latencies: it measured slower, PERF.md).
//  - the training forward saves the state entering every kStateChunk = 16
//    steps.  The backward walks the sequence from its end in sub-chunks of
//    16 steps: it recomputes the sub-chunk's states from the saved one into
//    registers (16 x ds/8 a lane) with the forward's own ex2 and fmaf, so
//    they are the forward's states, then sweeps the sub-chunk in reverse.
//    That takes exp(dt a) twice an element (once recomputing, once in the
//    sweep): keeping the 16 x ds/8 factors of the recompute as well would
//    take 32 more registers a thread at ds 16, past the 128 that two blocks
//    an SM leave, and the second exponential costs 0.032 ms of
//    special-function time, which the sweep's other work covers.
//  - reductions batched over a group of kBwdGroup = 4 steps, by
//    reduce-scatter (a lane keeps half of the values at each exchange, so
//    the shuffles are 1/2 + 1/4 + ... of the values).  Over a channel's
//    states (q1 = sum g b, q2 = sum g h e a): a sum in registers, then the
//    group's 8 values over the channel's 8 lanes (7 shuffles, and 1 to put
//    q1 and q2 of a step in one lane), from which it forms dx and ddt.
//    Over the channels (db, dc): the lane's 8 ds/8 values of the group over
//    the warp's 4 channels (6 ds/8 shuffles), written as the warp's partial
//    to shared memory, summed over the block's 8 warps once a chunk.
//    Shuffles an element: (8 + 6 ds/8) / (4 ds/8), 2.5 at ds 16 (the first
//    design took 10).
//  - db and dc summed over a cluster's kBwdCluster = 8 blocks through
//    distributed shared memory, each block summing an eighth of the chunk's
//    values over the 8 ranks in rank order, one cluster barrier a chunk,
//    split into arrive and wait around the next chunk's sweep; the
//    clusters' partials go to device memory (B x ceil(di / 256) x S x ds x 2
//    floats, 4.2 MB at falcon-mamba's width, read once more by
//    scan_bwd_reduce, which sums them in a fixed order).  No atomics: the
//    gradients are bit-equal from run to run.
//  - staging: a ring of kBwdRing = 3 chunks of kBwdChunk = 32 steps, x, dt,
//    dy, b, c copied by cp.async in 16-byte pieces, 32 channels (64 or 128
//    bytes) a step row, issued two chunks ahead of the sweep; the bf16
//    arrays widened to f32 once; dx and ddt written over x and dt in the
//    chunk buffer and stored as 16-byte rows after the chunk's sweep, their
//    stores draining while the next chunk is swept.
// What holds it back (measured, PERF.md): the sweep.  At 16 warps an SM its
// dependent chains (shared loads, the exponentials, the reductions'
// shuffles) leave the schedulers idle most of the time, and the two
// reductions are a large share of its instructions.

constexpr int kBwdChunk = 32;    // steps a staged chunk (two sub-chunks)
constexpr int kBwdGroup = 4;     // steps a batched reduction
constexpr int kBwdRing = 3;      // chunks staged at once
// ops.py reads these two: lanes a channel (ds >= 8; ds 4 takes 4) and
// blocks a cluster
constexpr int kBwdLanes = 8;
constexpr int kBwdCluster = 8;
constexpr int kWarpsB = kThreads / 32;

__host__ __device__ constexpr int log2i(int n) {
  return n > 1 ? 1 + log2i(n / 2) : 0;
}

// lanes a channel for d_state DS, and so states a lane (DS / lanes) and
// channels a block (kThreads / lanes)
template <int DS>
constexpr int kLanesB = DS >= kBwdLanes ? kBwdLanes : DS;
static_assert(kBwdChunk % kStateChunk == 0 && kStateChunk % kBwdGroup == 0,
              "chunks");

__device__ __forceinline__ void st_f(void* p, long i, bool bf16, float x) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(p)[i] = x;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// reduce-scatter of v[0 .. N) over the lanes lane ^ kOff, lane ^ 2 kOff,
// ... (kLevels of them): at each level the lane whose bit kOff is set keeps
// the upper half; after it v[0 .. N >> kLevels) holds the sums of the
// block of the N values its bits selected (the first level the block's top
// bit).  A recursion, so that every index is a constant and v stays in
// registers
template <int N, int kOff, int kLevels>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (kLevels > 0) {
    constexpr int n = N / 2;
    const bool hi = lane & kOff;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const float send = hi ? v[j] : v[j + n];
      const float keep = hi ? v[j + n] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, kOff);
    }
    reduce_scatter<n, 2 * kOff, kLevels - 1>(v, lane);
  }
}

template <int N>
__device__ __forceinline__ void sts(float* p, const float* v) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// One sub-chunk of kStateChunk steps from chunk-local step ts on, for one
// lane (states n0 .. n0 + NS - 1 of channel lc of the block's CH): recompute
// its states from hs, then sweep it in reverse, carrying g and da; after
// each group dx, ddt over x, dt and the warp's db, dc partials to wp
// ([kBwdChunk][2][DS]).
template <int DS, int LN, int CH>
__device__ __forceinline__ void bwd_sub(
    float* __restrict__ xs, float* __restrict__ dts,
    const float* __restrict__ dys, const float* __restrict__ bs,
    const float* __restrict__ cs, float* __restrict__ wp, int ts, int lc,
    int sub, int lane, const float* hs, const float* a, const float* a2,
    float dch, float* g, float* da, float& dd_acc) {
  constexpr int NS = DS / LN;
  constexpr int kGroups = kStateChunk / kBwdGroup;
  // the reduction over the warp's 32 / LN channels: levels, and the pairs
  // (step, db or dc) of the lane's states each lane keeps
  constexpr int kLevels = log2i(32 / LN);
  constexpr int kPairs = (2 * kBwdGroup) >> kLevels;
  float hist[kStateChunk][NS];
  {
    float h[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) h[j] = hs[j];
#pragma unroll
    for (int u = 0; u < kStateChunk; ++u) {
      const int t = ts + u;
      const float x = xs[t * CH + lc], dtt = dts[t * CH + lc];
      const float dtx = dtt * x;
      float bv[NS];
      lds<NS>(bs + t * DS + sub * NS, bv);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        h[j] = fmaf(ex2(dtt * a2[j]), h[j], dtx * bv[j]);
        hist[u][j] = h[j];
      }
    }
  }
  // the lane's block of pairs after the channel reduction (its first level
  // the top bit) ...
  int kb = 0;
#pragma unroll
  for (int l = 0; l < kLevels; ++l)
    kb = 2 * kb + ((lane >> (log2i(LN) + l)) & 1);
  // ... and its step of each group after the state reduction, with q1 in
  // the lane of sub bit 4 clear (LN = 8)
  const int own = 2 * (sub & 1) + ((sub >> 1) & 1);
  const bool writes = LN < 8 || sub < 4;
#pragma unroll
  for (int gq = kGroups - 1; gq >= 0; --gq) {
    const int tg = ts + gq * kBwdGroup;
    float qv[2 * kBwdGroup];       // [step][q1, q2]
    float bc[2 * kBwdGroup * NS];  // [step][db, dc][state]
#pragma unroll
    for (int uu = kBwdGroup - 1; uu >= 0; --uu) {
      const int u = gq * kBwdGroup + uu, t = ts + u;
      const float x = xs[t * CH + lc], dtt = dts[t * CH + lc];
      const float dyv = dys[t * CH + lc];
      const float dtx = dtt * x;
      float bv[NS], cv[NS];
      lds<NS>(bs + t * DS + sub * NS, bv);
      lds<NS>(cs + t * DS + sub * NS, cv);
      float q1 = 0.f, q2 = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float hprev = u > 0 ? hist[u - 1][j] : hs[j];
        g[j] = fmaf(dyv, cv[j], g[j]);
        bc[(2 * uu) * NS + j] = g[j] * dtx;
        bc[(2 * uu + 1) * NS + j] = dyv * hist[u][j];
        const float e = ex2(dtt * a2[j]);
        const float de = g[j] * hprev * e;
        q1 = fmaf(g[j], bv[j], q1);
        q2 = fmaf(de, a[j], q2);
        da[j] = fmaf(de, dtt, da[j]);
        g[j] *= e;
      }
      qv[2 * uu] = q1;
      qv[2 * uu + 1] = q2;
    }
    // over the channel's LN lanes (sub bits 1, 2, 4)
    reduce_scatter<2 * kBwdGroup, 1, log2i(LN)>(qv, sub);
    float q1 = qv[0], q2 = qv[1];
    if constexpr (LN == 8) {  // one value a lane: q1 and q2 meet
      const float other = __shfl_xor_sync(kFull, qv[0], 4);
      q1 = sub & 4 ? other : qv[0];
      q2 = sub & 4 ? qv[0] : other;
    }
    // over the warp's channels (lane bits LN, 2 LN, ...)
    reduce_scatter<2 * kBwdGroup * NS, LN, kLevels>(bc, lane);
#pragma unroll
    for (int m = 0; m < kPairs; ++m) {
      const int pr = kb * kPairs + m;  // (step pr / 2, db or dc)
      sts<NS>(wp + (tg + pr / 2) * 2 * DS + (pr % 2) * DS + sub * NS,
              bc + m * NS);
    }
    // every lane of the channel has read x, dt of the group's steps (before
    // the shuffles above)
    if (writes) {
      const int t = tg + own;
      const float x = xs[t * CH + lc], dtt = dts[t * CH + lc];
      const float dyv = dys[t * CH + lc];
      xs[t * CH + lc] = fmaf(q1, dtt, dyv * dch);
      dts[t * CH + lc] = fmaf(q1, x, q2);
      dd_acc = fmaf(dyv, x, dd_acc);
    }
  }
}

// kStateChunk-step states from scan_fwd<kStates> in, the chunks of
// kBwdChunk steps from the last to the first
template <int DS>
__global__ void __launch_bounds__(kThreads, 2)
    scan_bwd(const void* __restrict__ xc, const void* __restrict__ dt,
             const void* __restrict__ bm, const void* __restrict__ cm,
             const float* __restrict__ a_log, const float* __restrict__ dd,
             const void* __restrict__ dy, const float* __restrict__ h_chunks,
             const float* __restrict__ dh_final, void* __restrict__ dxc,
             void* __restrict__ ddt, float* __restrict__ db_part,
             float* __restrict__ dc_part, float* __restrict__ da_part,
             float* __restrict__ dd_part, int s, int di, bool x_bf16,
             bool dt_bf16, bool b_bf16, bool c_bf16) {
  constexpr int LN = kLanesB<DS>, NS = DS / LN;
  constexpr int CH = kThreads / LN;  // channels a block
  constexpr int kLgBf = log2i(CH * 2 / 16);  // bf16 16-byte pieces a row
  constexpr int kTile = kBwdChunk * CH;
  // a stage: x, dt, dy [kBwdChunk][CH] and b, c [kBwdChunk][DS], each in
  // its own dtype in room for f32
  constexpr int kOff[5] = {0, kTile, 2 * kTile, 3 * kTile,
                           3 * kTile + kBwdChunk * DS};
  constexpr int kBuf = 3 * kTile + 2 * kBwdChunk * DS;  // floats
  constexpr int kPart = kBwdChunk * 2 * DS;  // [step][db, dc][state]
  extern __shared__ __align__(16) float bwd_smem[];
  float* work = bwd_smem + kBwdRing * kBuf;  // the bf16 arrays as f32
  float* wpart = work + kBuf;                 // [warp][kPart]
  float* bpart = wpart + kWarpsB * kPart;     // [2][kPart]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lc = tid / LN, sub = tid % LN;
  const int bi = blockIdx.y, c0 = blockIdx.x * CH, ch = c0 + lc;
  const int n0 = sub * NS;
  const bool valid = ch < di;  // the ragged channel edge
  const int n_cl = gridDim.x / kBwdCluster, cl = blockIdx.x / kBwdCluster;
  const int n_chunks = (s + kBwdChunk - 1) / kBwdChunk;
  const int n_saved = (s + kStateChunk - 1) / kStateChunk;
  const long row0 = (long)bi * s;
  float a[NS], a2[NS], g[NS], da[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    a[j] = valid ? -expf(a_log[(long)ch * DS + n0 + j]) : 0.f;
    a2[j] = a[j] * kLog2e;  // the forward's exponent factor
    g[j] = valid && dh_final != nullptr
               ? dh_final[((long)bi * di + ch) * DS + n0 + j]
               : 0.f;
    da[j] = 0.f;
  }
  const float dch = valid ? dd[ch] : 0.f;
  float dd_acc = 0.f;

  const bool bf16[5] = {x_bf16, dt_bf16, x_bf16, b_bf16, c_bf16};
  const bool any_bf16 = x_bf16 || dt_bf16 || b_bf16 || c_bf16;
  // chunk ci into stage st, 16 bytes a piece, as scan_fwd stages its chunks
  auto issue = [&](int ci, float* st) {
    const int t0 = ci * kBwdChunk, steps = min(kBwdChunk, s - t0);
    const void* src[5] = {xc, dt, dy, bm, cm};
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int lg = bf16[q] ? kLgBf : kLgBf + 1, v = bf16[q] ? 8 : 4;
      char* dst = reinterpret_cast<char*>(st + kOff[q]);
      for (int p = tid; p < kBwdChunk << lg; p += kThreads) {
        const int t = p >> lg, col = (p & ((1 << lg) - 1)) * v;
        const int n = t < steps ? min(v, di - c0 - col) : 0;
        stage16(dst + p * 16, src[q], (row0 + t0 + t) * di + c0 + col, n,
                bf16[q]);
      }
    }
#pragma unroll
    for (int q = 3; q < 5; ++q) {
      const int v = bf16[q] ? 8 : 4;
      char* dst = reinterpret_cast<char*>(st + kOff[q]);
      for (int p = tid; p * v < kBwdChunk * DS; p += kThreads)
        stage16(dst + p * 16, src[q], (row0 + t0) * DS + p * v,
                steps * DS - p * v, bf16[q]);
    }
  };
  // the cluster's sum of chunk ci's db, dc (in every block's bpart[buf]):
  // this block's 1 / kBwdCluster of the values, over the ranks in order
  auto reduce_chunk = [&](int ci, int buf) {
    const int t0 = ci * kBwdChunk;
    constexpr int kShare = kPart / kBwdCluster;
    for (int e = rank * kShare + tid; e < (rank + 1) * kShare;
         e += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < kBwdCluster; ++r)
        sum += *cluster.map_shared_rank(bpart + buf * kPart + e, r);
      const int u = e / (2 * DS), n = e % DS;
      if (t0 + u < s) {
        const long at = (((long)bi * n_cl + cl) * s + t0 + u) * DS + n;
        ((e / DS) % 2 ? dc_part : db_part)[at] = sum;
      }
    }
  };

  // chunk i (from the end) goes to stage i % kBwdRing; one commit group a
  // chunk (empty once every chunk is issued)
#pragma unroll
  for (int i = 0; i < kBwdRing - 1; ++i) {
    if (i < n_chunks) issue(n_chunks - 1 - i, bwd_smem + i * kBuf);
    cp_async_commit();
  }
  for (int i = 0; i < n_chunks; ++i) {
    const int ci = n_chunks - 1 - i;
    const int t0 = ci * kBwdChunk, steps = min(kBwdChunk, s - t0);
    float* cur = bwd_smem + (i % kBwdRing) * kBuf;
    cp_async_wait<kBwdRing - 2>();  // this thread's pieces of chunk i
    __syncthreads();  // everyone's; chunk i-1's buffers are consumed
    const int ahead = i + kBwdRing - 1;
    if (ahead < n_chunks)
      issue(n_chunks - 1 - ahead, bwd_smem + (ahead % kBwdRing) * kBuf);
    cp_async_commit();
    if (any_bf16) {
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        if (!bf16[q]) continue;
        const int n = q < 3 ? kTile : kBwdChunk * DS;
        const char* raw = reinterpret_cast<const char*>(cur + kOff[q]);
        for (int p = tid; p * 8 < n; p += kThreads)
          widen8(*reinterpret_cast<const int4*>(raw + p * 16),
                 work + kOff[q] + p * 8);
      }
      __syncthreads();
    }
    float* view[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) view[q] = (bf16[q] ? work : cur) + kOff[q];
    float* wp = wpart + warp * kPart;
    // the sub-chunks of this chunk that hold steps < S, last first
#pragma unroll 1
    for (int ts = ((steps - 1) / kStateChunk) * kStateChunk; ts >= 0;
         ts -= kStateChunk) {
      float hs[NS];
      const long at =
          (((long)bi * n_saved + (t0 + ts) / kStateChunk) * di + ch) * DS +
          n0;
#pragma unroll
      for (int j = 0; j < NS; ++j) hs[j] = valid ? h_chunks[at + j] : 0.f;
      bwd_sub<DS, LN, CH>(view[0], view[1], view[2], view[3], view[4], wp,
                          ts, lc, sub, lane, hs, a, a2, dch, g, da, dd_acc);
    }
    __syncthreads();  // dx, ddt over x, dt; every warp's partial written
    const int lg = x_bf16 ? kLgBf : kLgBf + 1, v = x_bf16 ? 8 : 4;
    for (int p = tid; p < kBwdChunk << lg; p += kThreads) {
      const int t = p >> lg, col = (p & ((1 << lg) - 1)) * v;
      const int n = t < steps ? min(v, di - c0 - col) : 0;
      if (n > 0)
        store16(dxc, (row0 + t0 + t) * di + c0 + col, n, x_bf16,
                view[0] + t * CH + col);
    }
    const int lgt = dt_bf16 ? kLgBf : kLgBf + 1, vt = dt_bf16 ? 8 : 4;
    for (int p = tid; p < kBwdChunk << lgt; p += kThreads) {
      const int t = p >> lgt, col = (p & ((1 << lgt) - 1)) * vt;
      const int n = t < steps ? min(vt, di - c0 - col) : 0;
      if (n > 0)
        store16(ddt, (row0 + t0 + t) * di + c0 + col, n, dt_bf16,
                view[1] + t * CH + col);
    }
    // the previous chunk's cluster sum: every block wrote its bpart and
    // arrived; after the wait, bpart[i % 2] is read by no block any more
    if (i > 0) {
      cluster_wait();
      reduce_chunk(ci + 1, (i - 1) & 1);
    }
    for (int e = tid; e < kPart; e += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsB; ++w) sum += wpart[w * kPart + e];
      bpart[(i & 1) * kPart + e] = sum;
    }
    cluster_arrive();
  }
  cluster_wait();
  reduce_chunk(0, (n_chunks - 1) & 1);
  // no block leaves while another reads its shared memory
  cluster_arrive();
  cluster_wait();

  // da over the sequence; dd over the channel's lanes' steps
#pragma unroll
  for (int off = 1; off < LN; off *= 2)
    dd_acc += __shfl_xor_sync(kFull, dd_acc, off);
  if (valid) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
      da_part[((long)bi * di + ch) * DS + n0 + j] = da[j];
    if (sub == 0) dd_part[(long)bi * di + ch] = dd_acc;
  }
}

// The second pass: db, dc [B, S, DS] summed over the clusters' partials,
// and da_log [di, DS], dd [di] over the sequences', each in a fixed order.
template <int DS>
__global__ void __launch_bounds__(256)
    scan_bwd_reduce(const float* __restrict__ db_part,
                    const float* __restrict__ dc_part,
                    const float* __restrict__ da_part,
                    const float* __restrict__ dd_part,
                    const float* __restrict__ a_log, void* __restrict__ db,
                    void* __restrict__ dc, float* __restrict__ da_log,
                    float* __restrict__ dd_out, int bsz, int s, int di,
                    int n_cl, bool b_bf16, bool c_bf16) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long per_seq = (long)s * DS;
  if (idx < bsz * per_seq) {
    const long bi = idx / per_seq, rest = idx % per_seq;
    const long base = bi * n_cl * per_seq + rest;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < n_cl; ++k) {
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
  // the ring and the f32 work buffer, the warps' and the block's partials
  constexpr int CH = kThreads / kLanesB<DS>;  // channels a block
  constexpr int kBuf = 3 * kBwdChunk * CH + 2 * kBwdChunk * DS;
  constexpr int kPart = kBwdChunk * 2 * DS;
  constexpr int smem = ((kBwdRing + 1) * kBuf + (kWarpsB + 2) * kPart) * 4;
  const int nblk = (di + CH - 1) / CH;
  const int n_cl = (nblk + kBwdCluster - 1) / kBwdCluster;
  const long part = (long)bsz * n_cl * s * DS;
  float* db_part = scratch;
  float* dc_part = db_part + part;
  float* da_part = dc_part + part;
  float* dd_part = da_part + (long)bsz * di * DS;
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd<DS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_cl * kBwdCluster), (unsigned)bsz);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kBwdCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, scan_bwd<DS>, xc, dt, b, c, a_log, d, dy,
                           h_chunks, dh_final, dxc, ddt, db_part, dc_part,
                           da_part, dd_part, s, di, x_bf16, dt_bf16, b_bf16,
                           c_bf16);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long n = std::max((long)bsz * s * DS, (long)di * DS);
  scan_bwd_reduce<DS><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      db_part, dc_part, da_part, dd_part, a_log, db, dc, da_log, dd_out, bsz,
      s, di, n_cl, b_bf16, c_bf16);
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
// [B, ceil(S / 16), di, ds] f32, the state entering every 16th step.
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
// f32; scratch f32 of 2 * B * ncl * S * ds + B * di * (ds + 1) floats,
// ncl = ceil(ceil(di / (256 / min(8, ds))) / 8) clusters.  Two launches on
// one stream.
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
