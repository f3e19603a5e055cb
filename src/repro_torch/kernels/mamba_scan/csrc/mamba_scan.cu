// Mamba-1 selective scan for Hopper (sm_90a), plain C ABI.
//
// Replaces: src/repro/kernels/mamba_scan/kernel.py mamba_scan_kernel (body
//   _scan_kernel), the Pallas TPU kernel.
//
// What it computes: xc, dt [B,S,di]; b, c [B,S,ds]; a_log [di,ds] f32;
// d [di] f32 (all row-major, contiguous) -> y [B,S,di] in xc's dtype and
// h_final [B,di,ds] f32.  With a = -exp(a_log) and h = 0 at the start,
// each step t does
//   h = exp(dt_t * a) * h + (dt_t * x_t) * b_t     (per channel, state)
//   y_t = sum_ds(h * c_t) + d * x_t
// all in f32, as src/repro/kernels/mamba_scan/ref.py does.  Each of xc,
// dt, b and c is float32 or bfloat16 on its own (the model passes bf16
// xc/b/c with an f32 dt).  Exactly S steps run for any S: the Pallas
// kernel's `s % chunk == 0` is not needed, and padding the sequence
// would change h_final (a padded step has dt = softplus(dt_bias) != 0).
//
// What bounds it on this card: every input is read once and y written
// once -- at falcon-mamba-7b's prefill (B=1, S=1024, di=8192, ds=16, f32
// dt) 68.3 MB, 0.020 ms at 3.35 TB/s -- against ~7 f32 operations per
// (step, channel, state), 0.94 GFLOP or 0.014 ms at the 67 TFLOP/s f32
// rate: bound by device-memory bytes.
// Its design: one thread per (channel, state) pair holds that element of
// the f32 state in a register for the whole sweep over S (the Pallas
// kernel's VMEM state tile); a block of 256 threads covers 256/ds
// channels (16 at ds=16), so B=1, di=8192 gives 512 blocks for 132 SMs.
// The ds lanes of a channel are neighbours in one warp and reduce
// sum_ds(h * c) with __shfl_xor_sync.  Chunks of 32 timesteps of x/dt
// (the block's channels) and of b/c are staged in shared memory in f32,
// as the Pallas tile streams chunk x block_c tiles; y of a chunk is
// collected in shared memory and written back row by row.  The sweep
// over S is sequential: a chunked parallel scan over S, or tensor cores
// for a chunk's state products, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // timesteps staged in shared memory at a time

__device__ __forceinline__ float load(const void* p, long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, long i, float v, bool bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

template <int DS>
__global__ void __launch_bounds__(kThreads)
    scan_fwd(const void* __restrict__ xc, const void* __restrict__ dt,
             const void* __restrict__ bm, const void* __restrict__ cm,
             const float* __restrict__ a_log, const float* __restrict__ dd,
             void* __restrict__ y, float* __restrict__ h_final, int s,
             int di, bool x_bf16, bool dt_bf16, bool b_bf16, bool c_bf16) {
  constexpr int kCh = kThreads / DS;  // channels per block
  __shared__ float sx[kChunk][kCh];
  __shared__ float sdt[kChunk][kCh];
  __shared__ float sy[kChunk][kCh];
  __shared__ float sb[kChunk][DS];
  __shared__ float sc[kChunk][DS];

  const int bi = blockIdx.y;
  const int c0 = blockIdx.x * kCh;
  const int lc = threadIdx.x / DS, n = threadIdx.x % DS;
  const int ch = c0 + lc;
  const bool valid = ch < di;  // the ragged channel edge
  const float a = valid ? -expf(a_log[(long)ch * DS + n]) : 0.f;
  const float dch = valid ? dd[ch] : 0.f;
  const long xbase = (long)bi * s * di;
  const long bbase = (long)bi * s * DS;
  float h = 0.f;

  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int steps = min(kChunk, s - t0);
    for (int i = threadIdx.x; i < steps * kCh; i += kThreads) {
      const int t = i / kCh, c = i % kCh;
      const bool ok = c0 + c < di;
      const long off = xbase + (long)(t0 + t) * di + c0 + c;
      sx[t][c] = ok ? load(xc, off, x_bf16) : 0.f;
      sdt[t][c] = ok ? load(dt, off, dt_bf16) : 0.f;
    }
    for (int i = threadIdx.x; i < steps * DS; i += kThreads) {
      const int t = i / DS, k = i % DS;
      const long off = bbase + (long)(t0 + t) * DS + k;
      sb[t][k] = load(bm, off, b_bf16);
      sc[t][k] = load(cm, off, c_bf16);
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float x = sx[t][lc], dtt = sdt[t][lc];
      h = expf(dtt * a) * h + (dtt * x) * sb[t][n];
      float p = h * sc[t][n];
#pragma unroll
      for (int off = DS / 2; off > 0; off >>= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, off);
      }
      if (n == 0) sy[t][lc] = p + dch * x;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps * kCh; i += kThreads) {
      const int t = i / kCh, c = i % kCh;
      if (c0 + c < di) {
        store(y, xbase + (long)(t0 + t) * di + c0 + c, sy[t][c], x_bf16);
      }
    }
    // the next chunk's staging writes sx/sdt/sb/sc only, which no thread
    // reads after the barrier above; sy is next written after the
    // staging barrier, which every thread reaches after its stores
  }
  if (valid) h_final[((long)bi * di + ch) * DS + n] = h;
}

template <int DS>
cudaError_t launch(const void* xc, const void* dt, const void* b,
                   const void* c, const float* a_log, const float* d,
                   void* y, float* h_final, int bsz, int s, int di,
                   bool x_bf16, bool dt_bf16, bool b_bf16, bool c_bf16,
                   cudaStream_t stream) {
  constexpr int kCh = kThreads / DS;
  const dim3 grid((di + kCh - 1) / kCh, bsz);
  scan_fwd<DS><<<grid, kThreads, 0, stream>>>(xc, dt, b, c, a_log, d, y,
                                              h_final, s, di, x_bf16,
                                              dt_bf16, b_bf16, c_bf16);
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
  const float* al = static_cast<const float*>(a_log);
  const float* dv = static_cast<const float*>(d);
  float* hf = static_cast<float*>(h_final);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool xb = x_dtype == 1, dtb = dt_dtype == 1, bb = b_dtype == 1,
             cb = c_dtype == 1;
  switch (ds) {
    case 4:
      return launch<4>(xc, dt, b, c, al, dv, y, hf, bsz, s, di, xb, dtb, bb,
                       cb, st);
    case 8:
      return launch<8>(xc, dt, b, c, al, dv, y, hf, bsz, s, di, xb, dtb, bb,
                       cb, st);
    case 16:
      return launch<16>(xc, dt, b, c, al, dv, y, hf, bsz, s, di, xb, dtb,
                        bb, cb, st);
    default:
      return cudaErrorInvalidValue;
  }
}
