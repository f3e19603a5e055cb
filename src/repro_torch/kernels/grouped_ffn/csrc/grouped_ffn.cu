// Grouped expert FFN for Hopper (sm_90a), plain C ABI.
//
// Replaces no Pallas kernel: it stands for the reference's chain of
// jax.lax.ragged_dot calls in src/repro/models/moe.py (_grouped_ffn,
// lines 91-104), which XLA compiles, and for their gradients.  The port's
// MoE layer called one torch.matmul chain per non-empty expert instead,
// after reading the group sizes to the host; these kernels read the group
// offsets on the card.
//
// What it computes: the (token, expert) pairs' rows sorted by expert,
// x [P, d], and the group offsets [E + 1] int32 (rows off[e] .. off[e+1] - 1
// belong to expert e; off[0] = 0, off[E] = P), through their experts'
// weights w_up, w_gate [E, d, f] and w_down [E, f, d]:
//   h[r] = act(x[r] w_gate[e]) * (x[r] w_up[e])   (gated; else act(x w_up))
//   y[r] = h[r] w_down[e]
// in two launches, f32 sums, h rounded to x's dtype once (the plain loop
// in bf16 rounds u, act(g) and their product each), y rounded once.  act
// is SiLU, GELU (tanh form) or ReLU, as models/ops.activation.  An
// expert's weights are a [rows, columns] matrix with unit column stride;
// the experts and the rows may lie further apart (replicated storage's
// w[::R], a tensor-parallel block of f).
//
// Two kernels, one map of tiles.  Each block loads the offsets into
// shared memory, counts each expert's row tiles and their prefix sum (one
// warp), and walks the output tiles blockIdx.x, + gridDim.x, ... below the
// true count; a tile index maps to (expert, row block) by a binary search
// of the prefix.  Tiles are ordered row block first, column tile second,
// so the blocks in flight share the rows of x and the weights of few
// experts in L2.  The host sizes the grid from what it knows, P and E: at
// most ceil(P / rows a tile) + min(E, P) row tiles.  Nothing is read to
// the host.
//
// grouped_ffn_gemm (bf16, d and f multiples of 64, strides of 16 bytes:
// every MoE model of the port in serving).  What bounds it on this card: a
// prefill's pairs (thousands) reach every expert, so every routed weight
// is read once a layer: 3 * E * d * f * 2 bytes (1.11 GB at
// deepseek-moe-16b's widths, 0.33 ms at 3.35 TB/s) against 6 * P * d * f
// FLOPs (0.28 ms at 989 TFLOP/s for 16k pairs); a decode's few pairs read
// the weights of the experts they touch, so bytes.
//  - persistent blocks, one an SM, over row tiles of 128.
//  - a block is three warpgroups: two consumers, each owning 64 of the
//    tile's 128 rows, and a producer whose one thread issues every TMA
//    copy into a ring of kStages stages.  A stage holds the rows' 64
//    columns of the reduction (x or h, 128-byte swizzled, K-major) and two
//    [64 x 128] weight tiles (MN-major: the weights' rows are the
//    reduction): up and gate at the same columns (the gated mode), or
//    columns n0 and n0 + 128 of one matrix (the other modes).  Its bytes
//    count on the stage's "full" mbarrier; rows past P and columns past
//    the matrix are zero-filled by the copy.  The consumers release a
//    stage through its "empty" mbarrier once their products on it are
//    done.  setmaxnreg moves registers from the producer (40) to the
//    consumers (232): two m64n128 f32 accumulators a thread.
//  - a tile's rows that belong to the next expert (the group ends inside
//    the tile) are computed with the wrong weights and never stored.  A
//    consumer whose 64 rows all lie past the group's end (a decode's
//    groups of one or two rows) computes them all the same: a branch
//    around its products makes ptxas serialise every wgmma of the kernel.
//  - every product is a wgmma m64n128k16, both operands in shared memory;
//    the products of a stage stay in flight while the next stage's
//    barrier is awaited (wgmma.wait_group 1), then that stage is freed.
//  - the epilogue takes act(g) * u (or act, or nothing) in f32 on the
//    accumulators, rounds to bf16 and stores the group's rows.
//
// grouped_ffn_simt (f32, whose product on the tensor cores would be TF32,
// about 3 digits; bf16 at any other width; and the backward): CUDA-core
// tiles of 64 rows x 64 columns, 256 threads of 4 x 4 outputs, 16 steps
// of the reduction staged in shared memory as f32.  Rows past the group
// and columns past the matrix are zero-filled on load and never stored.
// Its modes add what the backward needs: u and g kept in f32 beside h, the
// activation's derivative in the epilogue of dh = dy w_down^T, and the sum
// of two products (dx = du w_up^T + dg w_gate^T).
//
// grouped_ffn_wgrad: each expert's weight gradient, the sum over its
// group's rows of a[r]^T g[r]: one block a (expert, 64 x 64 tile), 16 rows
// of the group at a time through shared memory, zero for an empty group.
//
// The backward (repro_grouped_ffn_bwd), six launches on the CUDA cores in
// the weights' dtype with f32 sums, as autograd differentiates the plain
// version: u, g and h again; dh = dy w_down^T, rounded to the dtype as h
// was, then du = dh act(g) and dg = dh u act'(g) in f32 (in place of u
// and g); dx = du w_up^T + dg w_gate^T; dw_up = x^T du, dw_gate = x^T dg
// and dw_down = h^T dy a group at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr int kWg = 128;                          // threads of a warpgroup
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * kWg;  // and the producer's
constexpr int kBM = kConsumers * 64;              // rows of a tile
constexpr int kBN = 128;                          // columns of one product
constexpr int kBK = 64;                           // reduction of a stage
constexpr int kStages = 4;
constexpr int kATile = kBM * kBK * 2;             // 16 KB
constexpr int kAtom = 64 * 128;                   // [64 rows][64 cols] bf16
constexpr int kBTile = 2 * kAtom;                 // [64][128]: 16 KB
constexpr int kStageBytes = kATile + 2 * kBTile;  // 48 KB
constexpr int kMaxExperts = 256;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr unsigned kFull = 0xffffffffu;

// the CUDA-core kernels' tiles
constexpr int kSBM = 64, kSBN = 64, kSBK = 16, kSThreads = 256;

// a launch's mode.  Forward: up and gate into h = act(g) * u; up alone
// into act(u); one product, no activation (down).  The CUDA cores' only:
// the gated and ungated forward with u and g kept in f32; dh's epilogue
// into du and dg (gated) or du (ungated); two products summed.
enum Mode {
  kGated = 0,
  kUngated = 1,
  kPlain = 2,
  kSaveGated = 3,
  kSaveUngated = 4,
  kBwdGated = 5,
  kBwdUngated = 6,
  kSum = 7
};
enum Act { kSilu = 0, kGelu = 1, kRelu = 2 };
enum Dtype { kF32 = 0, kBf16 = 1 };

// A, K-major: [64 rows][64 columns] as the TMA copies it (row r at 128 r
// bytes, its 16-byte chunk c at c ^ (r % 8)); 8-row groups 1024 bytes
// apart; k-step kk (16 columns) starts 32 bytes further along a row
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return gmma_desc(addr, 16, 1024, 1);
}
// B, MN-major: [64 rows (the reduction)][128 columns] as two column atoms
// [64][64] 8192 bytes apart; k-step kk starts 16 rows (2048 bytes) further
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return gmma_desc(addr, kAtom, 1024, 1);
}

// d[64] += A[64x16] B[16x128], A K-major and B MN-major in shared memory
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// the activation (kFast: the SFU's exponential, as the bf16 kernel takes)
template <bool kFast = true>
__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == kSilu) return x / (1.f + (kFast ? __expf(-x) : expf(-x)));
  if (act == kGelu) {
    const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.f + tanhf(u));
  }
  return fmaxf(x, 0.f);
}

// its derivative (ReLU's is 0 at 0, as autograd takes it)
__device__ __forceinline__ float act_grad(float x, int act) {
  if (act == kSilu) {
    const float s = 1.f / (1.f + expf(-x));
    return s * (1.f + x * (1.f - s));
  }
  if (act == kGelu) {
    const float c = 0.7978845608028654f;
    const float t = tanhf(c * (x + 0.044715f * x * x * x));
    return 0.5f * (1.f + t) +
           0.5f * x * (1.f - t * t) * c * (1.f + 3.f * 0.044715f * x * x);
  }
  return x > 0.f ? 1.f : 0.f;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// -- the map of tiles ---------------------------------------------------------

// s_cum[e]: the row tiles of BM rows before expert e's, s_cum[E] in all
// (one warp, lane `lane`, after s_off holds the offsets)
template <int BM>
__device__ __forceinline__ void count_row_tiles(const int* s_off, int* s_cum,
                                                int n_experts, int lane) {
  int carry = 0;
  if (lane == 0) s_cum[0] = 0;
  for (int base = 0; base < n_experts; base += 32) {
    const int e = base + lane;
    int v = e < n_experts ? (s_off[e + 1] - s_off[e] + BM - 1) / BM : 0;
#pragma unroll
    for (int sh = 1; sh < 32; sh <<= 1) {
      const int o = __shfl_up_sync(kFull, v, sh);
      if (lane >= sh) v += o;
    }
    if (e < n_experts) s_cum[e + 1] = carry + v;
    carry += __shfl_sync(kFull, v, 31);
  }
}

// where a tile lies: its expert, first row, rows in the group (<= BM)
// and first column
struct Tile {
  int e, row0, rows, n0;
};

template <int BM>
__device__ __forceinline__ Tile find_tile(int t, int n_tiles, int n_step,
                                          const int* s_off, const int* s_cum,
                                          int n_experts) {
  const int mi = t / n_tiles;
  int lo = 0, hi = n_experts - 1;  // the last expert whose first tile <= mi
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_cum[mid] <= mi)
      lo = mid;
    else
      hi = mid - 1;
  }
  Tile tile;
  tile.e = lo;
  tile.row0 = s_off[lo] + (mi - s_cum[lo]) * BM;
  tile.rows = min(BM, s_off[lo + 1] - tile.row0);
  tile.n0 = (t % n_tiles) * n_step;
  return tile;
}

// -- the warpgroup kernel (bf16) ----------------------------------------------

// Accumulator layout of an m64n128 product (g = lane / 4, t = lane % 4):
// warp w of the warpgroup holds rows 16 w + g (x[4 j], x[4 j + 1]) and
// 16 w + g + 8 (x[4 j + 2], x[4 j + 3]), columns 8 j + 2 t and 8 j + 2 t + 1.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    grouped_ffn_gemm(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_b0,
                     const __grid_constant__ CUtensorMap tm_b1,
                     const int* __restrict__ offsets,
                     __nv_bfloat16* __restrict__ out, int n_experts,
                     int k_dim, int n_dim, int act) {
  extern __shared__ __align__(1024) unsigned char gffn_smem[];
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ int s_cum[kMaxExperts + 1];  // row tiles before each expert
  // stages on 1024-byte boundaries (the launch adds 1024 bytes)
  unsigned char* smem =
      gffn_smem + ((1024 - (smem_u32(gffn_smem) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + kStages * kStageBytes;
  const uint32_t empty = full + 8 * kStages;
  const int tid = threadIdx.x;

  // the tiles' map: offsets, each expert's row tiles, their prefix sums
  if (tid <= n_experts) s_off[tid] = offsets[tid];
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);                 // the producer's expect_tx
      mbar_init(empty + 8 * st, kConsumers * kWg);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < 32) count_row_tiles<kBM>(s_off, s_cum, n_experts, tid);
  __syncthreads();
  constexpr int n_step = MODE == kGated ? kBN : 2 * kBN;  // a tile's columns
  const int n_tiles = (n_dim + n_step - 1) / n_step;
  const int total = s_cum[n_experts] * n_tiles;
  const int k_blocks = k_dim / kBK;
  // the second weight tile: the gate's same columns, or the next 128
  const int b1_col = MODE == kGated ? 0 : kBN;

  const int wg = tid / kWg;
  if (wg == kConsumers) {  // the producer
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers * kWg) {  // one thread issues every copy
      int it = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Tile tile =
            find_tile<kBM>(t, n_tiles, n_step, s_off, s_cum, n_experts);
        for (int kb = 0; kb < k_blocks; ++kb, ++it) {
          const int st = it % kStages;
          const uint32_t a = ring + st * kStageBytes;
          const uint32_t b0 = a + kATile, b1 = b0 + kBTile;
          const int k0 = kb * kBK;
          mbar_wait(empty + 8 * st, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * st, kStageBytes);
          tma_load2(a, &tm_a, k0, tile.row0, full + 8 * st);
          tma_load3(b0, &tm_b0, tile.n0, k0, tile.e, full + 8 * st);
          tma_load3(b0 + kAtom, &tm_b0, tile.n0 + 64, k0, tile.e,
                    full + 8 * st);
          tma_load3(b1, &tm_b1, tile.n0 + b1_col, k0, tile.e, full + 8 * st);
          tma_load3(b1 + kAtom, &tm_b1, tile.n0 + b1_col + 64, k0, tile.e,
                    full + 8 * st);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int row_lo = wg * 64 + ((tid & (kWg - 1)) >> 5) * 16 + g;  // and +8
  int it = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile tile =
        find_tile<kBM>(t, n_tiles, n_step, s_off, s_cum, n_experts);
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    fence_regs(acc0);
    fence_regs(acc1);
    for (int kb = 0; kb < k_blocks; ++kb, ++it) {
      const int st = it % kStages;
      const uint32_t a = ring + st * kStageBytes;
      const uint64_t da = desc_a(a + wg * (kATile / kConsumers));
      const uint64_t db0 = desc_b(a + kATile);
      const uint64_t db1 = desc_b(a + kATile + kBTile);
      mbar_wait(full + 8 * st, (it / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_n128(acc0, da + 2 * kk, db0 + 128 * kk);
        wgmma_n128(acc1, da + 2 * kk, db1 + 128 * kk);
      }
      wgmma_commit();
      // the previous stage's products are done: free it
      wgmma_wait<1>();
      if (kb > 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    mbar_arrive(empty + 8 * ((it - 1) % kStages));

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row_lo + hr * 8;
      if (r >= tile.rows) continue;
      __nv_bfloat16* orow = out + (long)(tile.row0 + r) * n_dim;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = tile.n0 + 8 * j + 2 * t4;
        const float u0 = acc0[4 * j + 2 * hr], u1 = acc0[4 * j + 2 * hr + 1];
        const float v0 = acc1[4 * j + 2 * hr], v1 = acc1[4 * j + 2 * hr + 1];
        if (MODE == kGated) {
          if (c < n_dim)
            *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                __floats2bfloat162_rn(act_fn(v0, act) * u0,
                                      act_fn(v1, act) * u1);
        } else {
          const bool a = MODE == kUngated;
          if (c < n_dim)
            *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                __floats2bfloat162_rn(a ? act_fn(u0, act) : u0,
                                      a ? act_fn(u1, act) : u1);
          if (c + kBN < n_dim)
            *reinterpret_cast<__nv_bfloat162*>(orow + c + kBN) =
                __floats2bfloat162_rn(a ? act_fn(v0, act) : v0,
                                      a ? act_fn(v1, act) : v1);
        }
      }
    }
  }
}

// -- the CUDA-core kernels ----------------------------------------------------

// A launch's operands: rows of A [P, k_dim] (unit column stride, rows
// k_dim apart), each expert's B with element (k, n) of expert e at
// e * se + k * sk + n * sn (a weight or its transpose), two of each at
// most; out [P, n_dim] in B's dtype; u and g [P, n_dim] f32.
template <typename TA, typename TB>
struct SimtArgs {
  const TA* a0;
  const TA* a1;
  const TB* b0;
  const TB* b1;
  long se0, sk0, sn0, se1, sk1, sn1;
  const int* offsets;
  int n_experts, k_dim, n_dim, act;
  TB* out;
  float* u;
  float* g;
};

template <typename TA, typename TB, int MODE>
__global__ void __launch_bounds__(kSThreads)
    grouped_ffn_simt(const SimtArgs<TA, TB> p) {
  constexpr bool kTwoA = MODE == kSum;
  constexpr bool kTwoB = MODE == kGated || MODE == kSaveGated || MODE == kSum;
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ int s_cum[kMaxExperts + 1];
  __shared__ float sa[kTwoA ? 2 : 1][kSBK][kSBM + 1];
  __shared__ float sb[kTwoB ? 2 : 1][kSBK][kSBN];
  const int tid = threadIdx.x;
  for (int i = tid; i <= p.n_experts; i += kSThreads) s_off[i] = p.offsets[i];
  __syncthreads();
  if (tid < 32) count_row_tiles<kSBM>(s_off, s_cum, p.n_experts, tid);
  __syncthreads();
  const int n_tiles = (p.n_dim + kSBN - 1) / kSBN;
  const int total = s_cum[p.n_experts] * n_tiles;
  const int tx = tid % 16, ty = tid / 16;  // rows ty + 16 i, cols tx + 16 j
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile tile =
        find_tile<kSBM>(t, n_tiles, kSBN, s_off, s_cum, p.n_experts);
    float acc0[4][4] = {}, acc1[4][4] = {};
    for (int k0 = 0; k0 < p.k_dim; k0 += kSBK) {
#pragma unroll
      for (int i = 0; i < kSBM * kSBK / kSThreads; ++i) {
        const int idx = tid + i * kSThreads, r = idx / kSBK, c = idx % kSBK;
        const bool ok = r < tile.rows && k0 + c < p.k_dim;
        const long at = (long)(tile.row0 + r) * p.k_dim + k0 + c;
        sa[0][c][r] = ok ? to_f(p.a0[at]) : 0.f;
        if constexpr (kTwoA) sa[kTwoA][c][r] = ok ? to_f(p.a1[at]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kSBK * kSBN / kSThreads; ++i) {
        const int idx = tid + i * kSThreads, c = idx / kSBN, n = idx % kSBN;
        const bool ok = k0 + c < p.k_dim && tile.n0 + n < p.n_dim;
        const long k = k0 + c, col = tile.n0 + n;
        sb[0][c][n] =
            ok ? to_f(p.b0[tile.e * p.se0 + k * p.sk0 + col * p.sn0]) : 0.f;
        if constexpr (kTwoB)
          sb[kTwoB][c][n] =
              ok ? to_f(p.b1[tile.e * p.se1 + k * p.sk1 + col * p.sn1])
                 : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kSBK; ++c) {
        float a0[4], a1[4], b0[4], b1[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a0[i] = sa[0][c][ty + 16 * i];
          a1[i] = sa[kTwoA][c][ty + 16 * i];
          b0[i] = sb[0][c][tx + 16 * i];
          b1[i] = sb[kTwoB][c][tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc0[i][j] += a0[i] * b0[j];
            if constexpr (kTwoB) acc1[i][j] += a1[i] * b1[j];
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, n = tile.n0 + tx + 16 * j;
        if (r >= tile.rows || n >= p.n_dim) continue;
        const long o = (long)(tile.row0 + r) * p.n_dim + n;
        const float x0 = acc0[i][j], x1 = acc1[i][j];
        if constexpr (MODE == kGated) {
          p.out[o] = from_f<TB>(act_fn<false>(x1, p.act) * x0);
        } else if constexpr (MODE == kUngated) {
          p.out[o] = from_f<TB>(act_fn<false>(x0, p.act));
        } else if constexpr (MODE == kPlain) {
          p.out[o] = from_f<TB>(x0);
        } else if constexpr (MODE == kSum) {
          p.out[o] = from_f<TB>(x0 + x1);
        } else if constexpr (MODE == kSaveGated) {
          p.u[o] = x0;
          p.g[o] = x1;
          p.out[o] = from_f<TB>(act_fn<false>(x1, p.act) * x0);
        } else if constexpr (MODE == kSaveUngated) {
          p.u[o] = x0;
          p.out[o] = from_f<TB>(act_fn<false>(x0, p.act));
        } else if constexpr (MODE == kBwdGated) {
          const float dh = to_f(from_f<TB>(x0)), u = p.u[o], g = p.g[o];
          p.u[o] = dh * act_fn<false>(g, p.act);
          p.g[o] = dh * u * act_grad(g, p.act);
        } else {  // kBwdUngated
          const float dh = to_f(from_f<TB>(x0));
          p.u[o] = dh * act_grad(p.u[o], p.act);
        }
      }
  }
}

// out[e] [k_dim, n_dim] = sum over the rows r of group e of a[r]^T g[r]
// (a [P, k_dim], g [P, n_dim]); grid (n tiles, k tiles, experts)
template <typename TA, typename TG, typename TO>
__global__ void __launch_bounds__(kSThreads)
    grouped_ffn_wgrad(const TA* __restrict__ a, const TG* __restrict__ g,
                      const int* __restrict__ offsets, int k_dim, int n_dim,
                      TO* __restrict__ out) {
  __shared__ float sa[kSBK][kSBM + 1];
  __shared__ float sg[kSBK][kSBN];
  const int e = blockIdx.z, k0 = blockIdx.y * kSBM, n0 = blockIdx.x * kSBN;
  const int lo = offsets[e], hi = offsets[e + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int r0 = lo; r0 < hi; r0 += kSBK) {
#pragma unroll
    for (int i = 0; i < kSBK * kSBM / kSThreads; ++i) {
      const int idx = tid + i * kSThreads, rr = idx / kSBM, c = idx % kSBM;
      const bool row = r0 + rr < hi;
      sa[rr][c] = row && k0 + c < k_dim
                      ? to_f(a[(long)(r0 + rr) * k_dim + k0 + c])
                      : 0.f;
      sg[rr][c] = row && n0 + c < n_dim
                      ? to_f(g[(long)(r0 + rr) * n_dim + n0 + c])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kSBK; ++rr) {
      float av[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = sa[rr][ty + 16 * i];
        gv[i] = sg[rr][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * gv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (k < k_dim && n < n_dim)
        out[((long)e * k_dim + k) * n_dim + n] = from_f<TO>(acc[i][j]);
    }
}

// -- host side ----------------------------------------------------------------

// a tensor map of a bf16 array of dims (dim0, dim1, dim2) (dim2 1 for a
// matrix) whose elements (i, j, l) lie at i + j s1 + l s2, with boxes of
// [box1][64] elements, 128-byte swizzled
bool tile_map(CUtensorMap* map, const void* x, int rank, long dim0,
              long dim1, long dim2, long s1, long s2, int box1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)dim0, (cuuint64_t)dim1,
                              (cuuint64_t)dim2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

// row tiles of bm rows that p rows over e groups can need, at most
long row_tiles(int p, int e, int bm) {
  return (long)(p + bm - 1) / bm + (e < p ? e : p);
}

// rows [p, k] through the experts' weights b0, b1 (expert stride se, row
// stride sk) into out [p, n]
template <int MODE>
cudaError_t launch_gemm(const void* a, const void* b0, const void* b1,
                        long se0, long sk0, long se1, long sk1,
                        const int* offsets, void* out, int p, int e, int k,
                        int n, int act, cudaStream_t stream) {
  constexpr int smem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      grouped_ffn_gemm<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tm_a, tm_b0, tm_b1;
  if (!tile_map(&tm_a, a, 2, k, p, 1, k, (long)k * p, kBM) ||
      !tile_map(&tm_b0, b0, 3, n, k, e, sk0, se0, kBK) ||
      !tile_map(&tm_b1, b1, 3, n, k, e, sk1, se1, kBK))
    return cudaErrorInvalidValue;
  const int n_step = MODE == kGated ? kBN : 2 * kBN;
  const long upper = row_tiles(p, e, kBM) * ((n + n_step - 1) / n_step);
  const int grid = (int)(upper < sm_count() ? upper : sm_count());
  grouped_ffn_gemm<MODE><<<grid, kThreads, smem, stream>>>(
      tm_a, tm_b0, tm_b1, offsets, static_cast<__nv_bfloat16*>(out), e, k,
      n, act);
  return cudaGetLastError();
}

template <typename TA, typename TB, int MODE>
cudaError_t launch_simt(const SimtArgs<TA, TB>& args, int p,
                        cudaStream_t stream) {
  const long upper = row_tiles(p, args.n_experts, kSBM) *
                     ((args.n_dim + kSBN - 1) / kSBN);
  const long cap = 8L * sm_count();
  grouped_ffn_simt<TA, TB, MODE>
      <<<(int)(upper < cap ? upper : cap), kSThreads, 0, stream>>>(args);
  return cudaGetLastError();
}

template <typename TA, typename TG, typename TO>
cudaError_t launch_wgrad(const TA* a, const TG* g, const int* offsets,
                         int e, int k, int n, TO* out, cudaStream_t stream) {
  const dim3 grid((n + kSBN - 1) / kSBN, (k + kSBM - 1) / kSBM, e);
  grouped_ffn_wgrad<TA, TG, TO><<<grid, kSThreads, 0, stream>>>(a, g, offsets,
                                                               k, n, out);
  return cudaGetLastError();
}

// the weights' strides in elements: (expert, row) of w_up, w_gate, w_down
struct Strides {
  long up_e, up_r, gate_e, gate_r, down_e, down_r;
};

// whether the warpgroup kernel takes the call: bf16, the widths whole
// 64-column blocks, every address and stride on 16 bytes
bool takes_wgmma(int dtype, int d, int f, const Strides& s,
                 const void* const* ptrs, int n_ptrs) {
  if (dtype != kBf16 || d % 64 || f % 64) return false;
  const long st[6] = {s.up_e, s.up_r, s.gate_e, s.gate_r, s.down_e, s.down_r};
  for (long v : st)
    if (v % 8) return false;
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

template <typename T>
cudaError_t forward_simt(const T* x, const int* off, const T* w_up,
                         const T* w_gate, const T* w_down, T* h, T* y, int p,
                         int d, int f, int e, const Strides& s, int gated,
                         int act, cudaStream_t st) {
  const SimtArgs<T, T> up{x,     x,      w_up, w_gate, s.up_e,  s.up_r,
                          1,     s.gate_e, s.gate_r, 1, off,    e,
                          d,     f,      act,  h,      nullptr, nullptr};
  cudaError_t err = gated ? launch_simt<T, T, kGated>(up, p, st)
                          : launch_simt<T, T, kUngated>(up, p, st);
  if (err != cudaSuccess) return err;
  const SimtArgs<T, T> down{h,   h,        w_down, w_down, s.down_e, s.down_r,
                            1,   s.down_e, s.down_r, 1,    off,      e,
                            f,   d,        act,    y,      nullptr,  nullptr};
  return launch_simt<T, T, kPlain>(down, p, st);
}

template <typename T>
cudaError_t backward(const T* x, const int* off, const T* w_up,
                     const T* w_gate, const T* w_down, const T* dy, float* u,
                     float* g, T* h, T* dx, T* dw_up, T* dw_gate, T* dw_down,
                     int p, int d, int f, int e, const Strides& s, int gated,
                     int act, cudaStream_t st) {
  // u, g and h again
  const SimtArgs<T, T> fwd{x,   x,        w_up, w_gate, s.up_e, s.up_r,
                           1,   s.gate_e, s.gate_r, 1,  off,    e,
                           d,   f,        act,  h,      u,      g};
  cudaError_t err = gated ? launch_simt<T, T, kSaveGated>(fwd, p, st)
                          : launch_simt<T, T, kSaveUngated>(fwd, p, st);
  if (err != cudaSuccess) return err;
  // dh = dy w_down^T, then du and dg in place of u and g
  const SimtArgs<T, T> dh{dy,  dy,       w_down, w_down, s.down_e, 1,
                          s.down_r, s.down_e, 1,   s.down_r, off,    e,
                          d,   f,        act,    nullptr, u,       g};
  err = gated ? launch_simt<T, T, kBwdGated>(dh, p, st)
              : launch_simt<T, T, kBwdUngated>(dh, p, st);
  if (err != cudaSuccess) return err;
  // dx = du w_up^T (+ dg w_gate^T)
  const SimtArgs<float, T> dxa{u,   g,        w_up, w_gate, s.up_e, 1,
                               s.up_r, s.gate_e, 1, s.gate_r, off,   e,
                               f,   d,        act,  dx,     nullptr, nullptr};
  err = gated ? launch_simt<float, T, kSum>(dxa, p, st)
              : launch_simt<float, T, kPlain>(dxa, p, st);
  if (err != cudaSuccess) return err;
  // the weights' gradients, a group at a time
  err = launch_wgrad<T, float, T>(x, u, off, e, d, f, dw_up, st);
  if (err != cudaSuccess) return err;
  if (gated) {
    err = launch_wgrad<T, float, T>(x, g, off, e, d, f, dw_gate, st);
    if (err != cudaSuccess) return err;
  }
  return launch_wgrad<T, T, T>(h, dy, off, e, f, d, dw_down, st);
}

bool bad_args(int p, int d, int f, int e, int act, int dtype) {
  return p <= 0 || d <= 0 || f <= 0 || e <= 0 || e > kMaxExperts ||
         act < 0 || act > kRelu || (dtype != kF32 && dtype != kBf16);
}

}  // namespace

// x [p, d], offsets [e + 1] int32, w_up and w_gate [e, d, f], w_down
// [e, f, d] (strides: expert and row strides in elements of w_up, w_gate
// and w_down, six int64), all of dtype (0 f32, 1 bf16) but the offsets;
// h [p, f] scratch, y [p, d] out.  gated 0 ignores w_gate; act: 0 SiLU,
// 1 GELU (tanh), 2 ReLU.  Two launches on one stream.  Returns the
// cudaError_t of the launches.
extern "C" int repro_grouped_ffn(const void* x, const void* offsets,
                                 const void* w_up, const void* w_gate,
                                 const void* w_down, void* h, void* y, int p,
                                 int d, int f, int e, const void* strides,
                                 int gated, int act, int dtype,
                                 void* stream) {
  if (bad_args(p, d, f, e, act, dtype)) return (int)cudaErrorInvalidValue;
  const long long* sv = static_cast<const long long*>(strides);
  const Strides s{(long)sv[0], (long)sv[1], (long)sv[2],
                  (long)sv[3], (long)sv[4], (long)sv[5]};
  if (!gated) w_gate = w_up;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  const void* ptrs[7] = {x, w_up, w_gate, w_down, h, y, offsets};
  if (takes_wgmma(dtype, d, f, s, ptrs, 6)) {
    const cudaError_t err =
        gated ? launch_gemm<kGated>(x, w_up, w_gate, s.up_e, s.up_r,
                                    s.gate_e, s.gate_r, off, h, p, e, d, f,
                                    act, st)
              : launch_gemm<kUngated>(x, w_up, w_up, s.up_e, s.up_r, s.up_e,
                                      s.up_r, off, h, p, e, d, f, act, st);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_gemm<kPlain>(h, w_down, w_down, s.down_e, s.down_r,
                                    s.down_e, s.down_r, off, y, p, e, f, d,
                                    act, st);
  }
  if (dtype == kF32)
    return (int)forward_simt<float>(
        static_cast<const float*>(x), off, static_cast<const float*>(w_up),
        static_cast<const float*>(w_gate), static_cast<const float*>(w_down),
        static_cast<float*>(h), static_cast<float*>(y), p, d, f, e, s, gated,
        act, st);
  using bf = __nv_bfloat16;
  return (int)forward_simt<bf>(
      static_cast<const bf*>(x), off, static_cast<const bf*>(w_up),
      static_cast<const bf*>(w_gate), static_cast<const bf*>(w_down),
      static_cast<bf*>(h), static_cast<bf*>(y), p, d, f, e, s, gated, act,
      st);
}

// The backward of repro_grouped_ffn: the same inputs, dy [p, d]; scratch
// u and g [p, f] f32 and h [p, f]; out dx [p, d], dw_up and dw_gate
// [e, d, f] and dw_down [e, f, d], contiguous (dw_gate unused when gated
// is 0).  Six launches (five ungated) on one stream.
extern "C" int repro_grouped_ffn_bwd(
    const void* x, const void* offsets, const void* w_up, const void* w_gate,
    const void* w_down, const void* dy, void* u, void* g, void* h, void* dx,
    void* dw_up, void* dw_gate, void* dw_down, int p, int d, int f, int e,
    const void* strides, int gated, int act, int dtype, void* stream) {
  if (bad_args(p, d, f, e, act, dtype)) return (int)cudaErrorInvalidValue;
  const long long* sv = static_cast<const long long*>(strides);
  const Strides s{(long)sv[0], (long)sv[1], (long)sv[2],
                  (long)sv[3], (long)sv[4], (long)sv[5]};
  if (!gated) w_gate = w_up;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  float* uf = static_cast<float*>(u);
  float* gf = static_cast<float*>(g);
  if (dtype == kF32) {
    using T = float;
    return (int)backward<T>(
        static_cast<const T*>(x), off, static_cast<const T*>(w_up),
        static_cast<const T*>(w_gate), static_cast<const T*>(w_down),
        static_cast<const T*>(dy), uf, gf, static_cast<T*>(h),
        static_cast<T*>(dx), static_cast<T*>(dw_up), static_cast<T*>(dw_gate),
        static_cast<T*>(dw_down), p, d, f, e, s, gated, act, st);
  }
  using T = __nv_bfloat16;
  return (int)backward<T>(
      static_cast<const T*>(x), off, static_cast<const T*>(w_up),
      static_cast<const T*>(w_gate), static_cast<const T*>(w_down),
      static_cast<const T*>(dy), uf, gf, static_cast<T*>(h),
      static_cast<T*>(dx), static_cast<T*>(dw_up), static_cast<T*>(dw_gate),
      static_cast<T*>(dw_down), p, d, f, e, s, gated, act, st);
}
