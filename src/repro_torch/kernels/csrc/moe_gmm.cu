// Grouped expert matmul of a mixture-of-experts layer on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm/kernel.py
// (_gmm_kernel / gmm).  The tokens of a layer come sorted by expert, each
// expert's group padded to a multiple of tile_m rows, so that row tile t
// belongs to expert tile_expert[t] alone.  For every valid row r of tile t
//
//     y[r, :] = x[r, :] @ round_to_x(w[tile_expert[t]])          (D -> F)
//
// summed in float32 and stored in x's type.  w may be float32 while x is
// bfloat16: each weight is rounded to bf16 on its way into shared memory,
// which gives exactly the numbers of casting w to x's type first and then
// multiplying, without writing the cast copy (for deepseek-moe-16b that copy
// is 64 experts x 3 x 2048 x 1408 weights a layer, ~1.1 GB of f32 read and
// bf16 written on every call).
//
// What bounds it on this card: operations.  At the deepseek-moe-16b
// forward's shape (4 x 2048 tokens, top-6: 49,152 valid rows, D 2048,
// F 1408) a gate or up product is 2 * 49,152 * 2,048 * 1,408 = 2.83e11
// FLOP, 0.287 ms at the 989 TFLOP/s of the bf16 tensor cores, against
// ~1.1 GB of bytes (f32 weights), 0.33 ms at 3.35 TB/s, so with f32 weights
// the bytes bind by a little and with bf16 weights the operations do.  At a
// decode step (4 tokens, 24 rows) only the ~20 experts hit are read: bytes.
//
// Two paths, chosen by x's type:
// * bf16 x (the models' compute type): the tensor cores.  A block of 8
//   warps computes a 128 x 128 tile of y (a whole 128-row tile of the
//   padded buffer) with mma.sync m16n8k16, bf16 x bf16 with f32
//   accumulators in registers; each warp owns 64 rows x 32 columns.  x
//   arrives by 16-byte cp.async in a ring of 4 stages of depth 32 in
//   dynamic shared memory, so three stages are in flight while the tensor
//   cores work on the fourth (the ring is what keeps a decode step's
//   weight stream, the bytes that bound it, moving); bf16 w rides the same
//   ring.  Rows are padded (x to 80 bytes, w to 272) so ldmatrix and
//   ldmatrix.trans read the A and B fragments without bank conflicts.
//   f32 w comes through registers one stage ahead (16-byte loads issued
//   before a stage's products, stored after them) and is rounded to bf16 as
//   it is stored into shared memory: each product in the tensor core is
//   then exact and the result equals casting w to bf16 first, up to the
//   order of the f32 sums.  Rounding at the store, rather than as each
//   warp builds its B fragments, is what measurement chose: the fragment
//   reads out of shared memory bound this kernel (benchmarks/
//   torch_gmm_probe.py times it with its copies and its products removed),
//   and f32 w in shared memory doubled the B bytes written and read there,
//   while two warps rounded every weight twice.
// * f32 x: the FMA units, as before (a 64 x 128 tile a block, a 4 x 8
//   register tile a thread over stages of 16), which keeps the f32 path's
//   sums in full f32.  f16 x takes the same kernel: x widened to f32 as it
//   is loaded, w rounded to f16 (the plain version's cast) and y rounded to
//   f16 once; no model of the repo computes in f16, so it is untuned.
//
// How the design answers the TPU kernel's structure:
// * The TPU kernel gets the expert of each row tile by scalar prefetch, and
//   its weight BlockSpec DMAs that expert's (D x tile_f) panel each grid
//   step.  Here a block reads its tile's expert id (and its count of valid
//   rows) from device memory and addresses the expert's weights itself.
// * The padding is skipped, not computed.  The padded row space has
//   (ceil(T / tile_m) + E) * tile_m rows, 347 times the 24 valid rows of a
//   decode step; a block whose rows are all padding returns at once, and a
//   warp skips the products of its 16-row slices that are all padding.
//   Padding rows are never read (the copies zero-fill them) and never
//   written.
// * The sort's gathers are folded into the loads and stores.  The op
//   passes row_src, the token row of every padded row, and the kernel reads
//   each valid row of x from its token's row and writes its row of y back
//   to the same token's row: neither the padded copy of x nor the unsort of
//   y goes through device memory (at the forward's shape, even done in one
//   pass each, they moved about 0.7 GB a product).
// * Raster order.  The grid is one-dimensional, the column blocks of one
//   row tile consecutive and the row tiles in order, so the row tiles of
//   one expert (consecutive after the sort) run close together in time and
//   its weight panels come from device memory about once, from L2 after
//   that; a row tile's x is read by its column blocks at the same time.
//   The 1-D grid also takes any number of row tiles (grid.x up to 2^31 - 1
//   blocks), where a grid.y of row tiles stopped at 65,535.
// * Rows, columns and D are masked, so any tile_m, D and F run through the
//   same code; the 16-byte copies need D (for x) and F (for w) to keep rows
//   16-byte aligned, and other shapes load element by element.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

// -- the FMA path (f32 x) -----------------------------------------------------

constexpr int kBM = 64;         // rows of y a block computes
constexpr int kBN = 128;        // columns of y a block computes
constexpr int kBK = 16;         // depth of one shared-memory stage
constexpr int kThreads = 256;   // 16 x 16, a 4 x 8 register tile each
constexpr int kXPad = kBM + 1;  // x is stored transposed, rows padded

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store_y(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_y(__half* p, float v) {
  *p = __float2half_rn(v);
}
// w rounded to x's type TX (the plain version casts w to x's dtype first):
// nothing to do for f32 x, a round trip through f16 for f16 x
template <typename TX>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<TX, __half>::value)
    return __half2float(__float2half_rn(v));
  else
    return v;
}

// n consecutive elements from p as f32, one vector load where `vec`
// (aligned and in bounds), element by element with the bound `left`
// otherwise.
template <int N, typename T>
__device__ __forceinline__ void load_row(const T* p, bool vec, int left,
                                         float (&out)[N]) {
  if (vec) {
    if constexpr (sizeof(T) * N == 32) {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      const float* f = reinterpret_cast<const float*>(&a);
      const float* g = reinterpret_cast<const float*>(&b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        out[i] = to_f32(reinterpret_cast<const T*>(f)[i]);
        out[4 + i] = to_f32(reinterpret_cast<const T*>(g)[i]);
      }
    } else {
      constexpr int kWords = sizeof(T) * N / 4;  // 16 or 8 bytes
      uint32_t raw[kWords];
      if constexpr (kWords == 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        raw[0] = v.x, raw[1] = v.y, raw[2] = v.z, raw[3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        raw[0] = v.x, raw[1] = v.y;
      }
      const T* t = reinterpret_cast<const T*>(raw);
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = to_f32(t[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = i < left ? to_f32(p[i]) : 0.f;
  }
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const TX* __restrict__ x, const int* __restrict__ tile_expert,
               const int* __restrict__ tile_rows,
               const int* __restrict__ row_src, const TW* __restrict__ w,
               TX* __restrict__ y, int n_expert, int d, int f, int tile_m,
               int slices, int n_col, bool x_vec, bool w_vec) {
  const int col_blk = blockIdx.x % n_col;  // see "Raster order" above
  const int row_blk = blockIdx.x / n_col;
  const int tile = row_blk / slices;
  const int r0 = (row_blk % slices) * kBM;  // first row inside the tile
  const int rows = min(min(tile_rows[tile], tile_m) - r0, kBM);
  if (rows <= 0) return;  // all padding
  const int e = tile_expert[tile];
  if (e < 0 || e >= n_expert) return;  // rows of no local expert
  const long long row0 = (long long)tile * tile_m + r0;
  const int c0 = col_blk * kBN;
  const TW* wb = w + (long long)e * d * f + c0;

  __shared__ float xs[2][kBK][kXPad];
  __shared__ __align__(16) float ws[2][kBK][kBN];
  __shared__ int src[kBM];  // the x and y row of each of this block's rows

  const int tid = threadIdx.x;
  for (int r = tid; r < rows; r += kThreads) src[r] = row_src[row0 + r];
  __syncthreads();
  const int tx = tid % 16, ty = tid / 16;
  const bool active = ty * 4 < rows;  // this thread's rows hold a token
  // stage loads: x as 64 rows x 4 groups of 4 k, w as 16 k x 16 groups of
  // 8 columns; vector loads where the launcher found them aligned
  const int xr = tid / 4, xk = (tid % 4) * 4;
  const int wk = tid / 16, wn = (tid % 16) * 8;
  float xreg[4], wreg[8];

  auto load = [&](int k0) {
    const int kx = k0 + xk;
    if (xr < rows && kx < d)
      load_row<4>(x + (long long)src[xr] * d + kx, x_vec && kx + 4 <= d,
                  d - kx, xreg);
    else
      xreg[0] = xreg[1] = xreg[2] = xreg[3] = 0.f;
    const int kw = k0 + wk, cw = c0 + wn;
    if (kw < d && cw < f) {
      load_row<8>(wb + (long long)kw * f + wn, w_vec && cw + 8 <= f,
                  f - cw, wreg);
#pragma unroll
      for (int i = 0; i < 8; ++i) wreg[i] = round_to<TX>(wreg[i]);
    } else
#pragma unroll
      for (int i = 0; i < 8; ++i) wreg[i] = 0.f;
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) xs[buf][xk + i][xr] = xreg[i];
    float4* dst = reinterpret_cast<float4*>(&ws[buf][wk][wn]);
    dst[0] = make_float4(wreg[0], wreg[1], wreg[2], wreg[3]);
    dst[1] = make_float4(wreg[4], wreg[5], wreg[6], wreg[7]);
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int stages = (d + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < stages) load((s + 1) * kBK);  // in flight during the FMAs
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[buf][kk][ty * 4 + i];
        // columns tx*4 + j and 64 + tx*4 + j: a quarter warp reads 128
        // contiguous bytes, free of bank conflicts
        const float4 b0 =
            *reinterpret_cast<const float4*>(&ws[buf][kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&ws[buf][kk][64 + tx * 4]);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (s + 1 < stages) store(buf ^ 1);  // the other buffer: read last stage
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) break;
    TX* yr = y + (long long)src[r] * f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c < f) store_y(&yr[c], acc[i][j]);
    }
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* tile_expert,
                   const void* tile_rows, const void* row_src, const void* w,
                   void* y, int n_tiles, int tile_m, int n_expert, int d,
                   int f, cudaStream_t stream) {
  const int slices = (tile_m + kBM - 1) / kBM;
  const int n_col = (f + kBN - 1) / kBN;
  const long long blocks = (long long)n_tiles * slices * n_col;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  // vector loads of 4 x elements and 8 w elements stay aligned when the
  // rows are multiples of them and the bases are 16-byte aligned
  const bool x_vec = d % 4 == 0 && (uintptr_t)x % 16 == 0;
  const bool w_vec = f % 8 == 0 && (uintptr_t)w % 16 == 0;
  gmm_kernel<TX, TW><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const TX*)x, (const int*)tile_expert, (const int*)tile_rows,
      (const int*)row_src, (const TW*)w, (TX*)y, n_expert, d, f, tile_m,
      slices, n_col, x_vec, w_vec);
  return cudaGetLastError();
}

// -- the tensor-core path (bf16 x) --------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;        // rows of y a block computes
constexpr int kBN = 128;        // columns of y a block computes
constexpr int kBK = 32;         // depth of one stage
constexpr int kStages = 4;      // the cp.async ring
constexpr int kThreads = 256;   // 8 warps: 2 (rows) x 4 (columns)
constexpr int kAPitch = kBK + 8;  // x rows of 80 bytes: ldmatrix conflict-free
constexpr int kBPitch = kBN + 8;  // w rows of 272 bytes: ldmatrix.trans too

// B (w, as bf16) slots in shared memory: a cp.async ring beside x's for
// bf16 w; two for f32 w, which comes through registers to be rounded
template <typename TW>
__host__ __device__ constexpr int b_slots() {
  return sizeof(TW) == 4 ? 2 : kStages;
}

template <typename TW>
constexpr int smem_bytes() {
  return (kStages * kBM * kAPitch + b_slots<TW>() * kBK * kBPitch) *
         (int)sizeof(bf16);
}

__device__ __forceinline__ bf16 bf16_zero() {
  return __float2bfloat16_rn(0.f);
}

template <typename TW>
__global__ void __launch_bounds__(kThreads, 2)
    gmm_mma_kernel(const bf16* __restrict__ x,
                   const int* __restrict__ tile_expert,
                   const int* __restrict__ tile_rows,
                   const int* __restrict__ row_src,
                   const TW* __restrict__ w, bf16* __restrict__ y,
                   int n_expert, int d, int f, int tile_m, int slices,
                   int n_col, bool x_vec, bool w_vec, bool y_pair) {
  constexpr bool kF32W = sizeof(TW) == 4;
  constexpr int kHChunks = kBN / 8;  // 16-byte chunks in a bf16 w row
  constexpr int kFChunks = kBN / 4;  // 16-byte chunks in an f32 w row
  constexpr int kWRegs = kBK * kFChunks / kThreads;  // ... that a thread loads
  const int col_blk = blockIdx.x % n_col;  // see "Raster order" above
  const int row_blk = blockIdx.x / n_col;
  const int tile = row_blk / slices;
  const int r0 = (row_blk % slices) * kBM;  // first row inside the tile
  const int rows = min(min(tile_rows[tile], tile_m) - r0, kBM);
  if (rows <= 0) return;  // all padding
  const int e = tile_expert[tile];
  if (e < 0 || e >= n_expert) return;  // rows of no local expert
  const long long row0 = (long long)tile * tile_m + r0;
  const int c0 = col_blk * kBN;
  const TW* wb = w + (long long)e * d * f;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kStages * kBM * kAPitch;
  __shared__ int src[kBM];  // the x and y row of each of this block's rows

  const int tid = threadIdx.x;
  for (int r = tid; r < rows; r += kThreads)
    src[r] = row_src[row0 + r];
  __syncthreads();

  // x rows [0, rows) at depth k0 into A slot `slot`; what lies outside is
  // zero-filled, not read
  auto load_a = [&](int slot, int k0) {
    bf16* as = As + slot * kBM * kAPitch;
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = i % (kBK / 8) * 8, k = k0 + c;
      bf16* dst = as + r * kAPitch + c;
      if (x_vec) {
        const bool in = r < rows && k < d;  // d % 8 == 0 here
        mma::cp_async_16(mma::smem_addr(dst),
                         in ? x + (long long)src[r] * d + k : x, in ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = r < rows && k + j < d ? x[(long long)src[r] * d + k + j]
                                         : bf16_zero();
      }
    }
  };
  // bf16 w columns [c0, c0 + kBN) at depth k0 into B slot `slot`
  auto copy_b = [&](int slot, int k0) {
    bf16* bs = Bs + slot * kBK * kBPitch;
    for (int i = tid; i < kBK * kHChunks; i += kThreads) {
      const int kr = i / kHChunks, c = i % kHChunks * 8;
      const int k = k0 + kr, n = c0 + c;
      bf16* dst = bs + kr * kBPitch + c;
      if (w_vec) {
        const bool in = k < d && n < f;  // f % 8 == 0 here
        mma::cp_async_16(mma::smem_addr(dst),
                         in ? (const bf16*)wb + (long long)k * f + n
                            : (const bf16*)w,
                         in ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = k < d && n + j < f
                       ? ((const bf16*)wb)[(long long)k * f + n + j]
                       : bf16_zero();
      }
    }
  };
  // f32 w columns [c0, c0 + kBN) at depth k0 into registers ...
  float4 wreg[kWRegs];
  auto fetch_b = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kWRegs; ++j) {
      const int i = tid + j * kThreads;
      const int kr = i / kFChunks, c = i % kFChunks * 4;
      const int k = k0 + kr, n = c0 + c;
      const float* p = (const float*)wb + (long long)k * f + n;
      if (w_vec) {  // f % 4 == 0 here
        wreg[j] = k < d && n < f ? *reinterpret_cast<const float4*>(p)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const bool in = k < d;
        wreg[j] = make_float4(in && n < f ? p[0] : 0.f,
                              in && n + 1 < f ? p[1] : 0.f,
                              in && n + 2 < f ? p[2] : 0.f,
                              in && n + 3 < f ? p[3] : 0.f);
      }
    }
  };
  // ... and rounded to bf16 into B slot `slot` (the cast of w to x's type,
  // done once a block for every weight it reads)
  auto store_b = [&](int slot) {
    bf16* bs = Bs + slot * kBK * kBPitch;
#pragma unroll
    for (int j = 0; j < kWRegs; ++j) {
      const int i = tid + j * kThreads;
      const int kr = i / kFChunks, c = i % kFChunks * 4;
      *reinterpret_cast<uint2*>(bs + kr * kBPitch + c) =
          make_uint2(mma::pack_bf16(wreg[j].x, wreg[j].y),
                     mma::pack_bf16(wreg[j].z, wreg[j].w));
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wrow = warp / 4 * 64;  // this warp's rows [wrow, wrow + 64)
  const int wcol = warp % 4 * 32;  // and columns [wcol, wcol + 32)
  const bool warp_active = wrow < rows;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // this warp's products at one stage: A and B fragments by ldmatrix
  auto compute = [&](const bf16* as, const bf16* bs) {
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        mma::ldmatrix_x4_trans(
            r, mma::smem_addr(bs + (ks + lane % 8 + (lane / 8) % 2 * 8) *
                                       kBPitch +
                              wcol + np * 16 + lane / 16 * 8));
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (wrow + mt * 16 >= rows) break;  // the rest is padding
        uint32_t a[4];
        mma::ldmatrix_x4(a, mma::smem_addr(as + (wrow + mt * 16 + lane % 16) *
                                                    kAPitch +
                                           ks + lane / 16 * 8));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma::mma_16816(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
  };

  const int ktiles = (d + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) {
      load_a(s, s * kBK);
      if constexpr (!kF32W) copy_b(s, s * kBK);
    }
    mma::cp_async_commit();  // an empty group keeps the count aligned
  }
  if constexpr (kF32W) {
    fetch_b(0);
    store_b(0);
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    mma::cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();  // ... for every thread; and the slots of kt - 1 are free
    const int next = kt + kStages - 1;
    if (next < ktiles) {
      load_a(next % kStages, next * kBK);
      if constexpr (!kF32W) copy_b(next % kStages, next * kBK);
    }
    mma::cp_async_commit();
    const bool more = kF32W && kt + 1 < ktiles;
    if (more) fetch_b((kt + 1) * kBK);  // in flight during the products
    if (warp_active)
      compute(As + (kt % kStages) * kBM * kAPitch,
              Bs + (kF32W ? kt % 2 : kt % kStages) * kBK * kBPitch);
    if (more) store_b((kt + 1) % 2);  // its last reader was stage kt - 1
  }
  mma::cp_async_wait<0>();
  if (!warp_active) return;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wrow + mt * 16 + g + half * 8;
      if (r >= rows) continue;
      bf16* yr = y + (long long)src[r] * f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = c0 + wcol + nt * 8 + 2 * t;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (y_pair && col + 1 < f) {
          *reinterpret_cast<__nv_bfloat162*>(yr + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < f) yr[col] = __float2bfloat16_rn(v0);
          if (col + 1 < f) yr[col + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <typename TW>
cudaError_t launch(const void* x, const void* tile_expert,
                   const void* tile_rows, const void* row_src, const void* w,
                   void* y, int n_tiles, int tile_m, int n_expert, int d,
                   int f, cudaStream_t stream) {
  const int slices = (tile_m + kBM - 1) / kBM;
  const int n_col = (f + kBN - 1) / kBN;
  const long long blocks = (long long)n_tiles * slices * n_col;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  constexpr int bytes = smem_bytes<TW>();  // above 48 KB: opt in
  cudaError_t err = cudaFuncSetAttribute(
      gmm_mma_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // 16-byte copies stay aligned when rows are whole 16-byte chunks and the
  // bases are 16-byte aligned; bf16 pairs of y when F is even
  const bool x_vec = d % 8 == 0 && (uintptr_t)x % 16 == 0;
  const bool w_vec =
      f % (16 / (int)sizeof(TW)) == 0 && (uintptr_t)w % 16 == 0;
  const bool y_pair = f % 2 == 0 && (uintptr_t)y % 4 == 0;
  gmm_mma_kernel<TW><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      (const bf16*)x, (const int*)tile_expert, (const int*)tile_rows,
      (const int*)row_src, (const TW*)w, (bf16*)y, n_expert, d, f, tile_m,
      slices, n_col, x_vec, w_vec, y_pair);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The padded row space has n_tiles * tile_m rows, sorted by expert so that
// row tile t belongs to expert tile_expert[t]; tile_expert, tile_rows:
// (n_tiles,) int32, tile_rows[t] the number of valid rows at the head of
// tile t (0 for a padding tile).  row_src: (n_tiles * tile_m,) int32, the
// row of x that padded row i reads and the row of y it writes (valid rows
// only are read).  x: (rows, d) in `x_dtype` (0 = float32, 1 = bfloat16,
// 2 = float16); w: (n_expert, d, f) in `w_dtype` (the same codes; f16 w
// with bf16 x is not taken: the op casts it to bf16 first); y: (rows, f)
// in x_dtype.  All
// contiguous.  Writes the rows of y that valid rows map to, only.  Returns
// the cudaGetLastError() code of the launch.
extern "C" int moe_gmm_launch(const void* x, const void* tile_expert,
                              const void* tile_rows, const void* row_src,
                              const void* w, void* y, int n_tiles,
                              int tile_m, int n_expert, int d, int f,
                              int x_dtype, int w_dtype, int device,
                              void* stream) {
  if (n_tiles <= 0 || tile_m <= 0 || n_expert <= 0 || d <= 0 || f <= 0 ||
      row_src == nullptr || x_dtype < 0 || x_dtype > 2 || w_dtype < 0 ||
      w_dtype > 2 || (x_dtype == 1 && w_dtype == 2))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
#define GMM_FMA(TX_, TW_)                                                    \
  launch<TX_, TW_>(x, tile_expert, tile_rows, row_src, w, y, n_tiles,        \
                   tile_m, n_expert, d, f, s)
  if (x_dtype != 1) {  // f32 and f16 x: the FMA kernel
    if (x_dtype == 0)
      err = w_dtype == 0 ? GMM_FMA(float, float)
            : w_dtype == 1 ? GMM_FMA(float, bf16) : GMM_FMA(float, __half);
    else
      err = w_dtype == 0 ? GMM_FMA(__half, float)
            : w_dtype == 1 ? GMM_FMA(__half, bf16) : GMM_FMA(__half, __half);
  }
#undef GMM_FMA
  else if (w_dtype == 0)
    err = tc::launch<float>(x, tile_expert, tile_rows, row_src, w, y,
                            n_tiles, tile_m, n_expert, d, f, s);
  else
    err = tc::launch<bf16>(x, tile_expert, tile_rows, row_src, w, y, n_tiles,
                           tile_m, n_expert, d, f, s);
  return (int)err;
}

extern "C" const char* moe_gmm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
