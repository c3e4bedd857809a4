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
// bfloat16: each weight is rounded to bf16 in registers before the product,
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
// This first design runs the product on the f32 FMA units out of shared
// memory, so it is bound by its own arithmetic (tens of TFLOP/s at best);
// tensor cores (mma.sync, then wgmma fed by TMA) are later work.
//
// How the design answers the TPU kernel's structure:
// * The TPU kernel gets the expert of each row tile by scalar prefetch, and
//   its weight BlockSpec DMAs that expert's (D x tile_f) panel each grid
//   step.  Here a block reads its tile's expert id (and its count of valid
//   rows) from device memory and addresses the expert's weights itself.
// * The padding is skipped, not computed.  The padded buffer has
//   (ceil(T / tile_m) + E) * tile_m rows, 347 times the 24 valid rows of a
//   decode step; a block whose rows are all padding returns at once, and a
//   warp whose rows are all padding skips the products.  Padded rows of y
//   are never written: they hold whatever the buffer held, and the op's
//   unsort never reads them.
// * Grid: (column block of 128, row tile x 64-row slice of the tile).  A
//   block of 256 threads computes a 64 x 128 tile of y over a loop on D in
//   stages of 16, each thread a 4 x 8 register tile.  Two shared-memory
//   buffers: the next stage's loads are started into registers before the
//   current stage's FMAs and stored to the other buffer after them, so the
//   load latency (all that a decode step's few rows wait on) overlaps the
//   arithmetic, with one barrier a stage.  x is stored transposed with rows
//   padded by one float; a thread's columns are tx*4 + j and 64 + tx*4 + j,
//   so each quarter warp reads 128 contiguous bytes of w.  Loads are 16
//   bytes wide where the rows keep them aligned; rows, columns and D are
//   masked, so any tile_m, D and F run through the same code.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;         // rows of y a block computes
constexpr int kBN = 128;        // columns of y a block computes
constexpr int kBK = 16;         // depth of one shared-memory stage
constexpr int kThreads = 256;   // 16 x 16, a 4 x 8 register tile each
constexpr int kXPad = kBM + 1;  // x is stored transposed, rows padded

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded to T and back (the cast of w to x's type)
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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
               const int* __restrict__ tile_rows, const TW* __restrict__ w,
               TX* __restrict__ y, int n_expert, int d, int f, int tile_m,
               int slices, bool x_vec, bool w_vec) {
  const int tile = blockIdx.y / slices;
  const int r0 = (blockIdx.y % slices) * kBM;  // first row inside the tile
  const int rows = min(min(tile_rows[tile], tile_m) - r0, kBM);
  if (rows <= 0) return;  // all padding
  const int e = tile_expert[tile];
  if (e < 0 || e >= n_expert) return;  // ops.sort_by_expert never gives it
  const long long row0 = (long long)tile * tile_m + r0;
  const int c0 = blockIdx.x * kBN;
  const TX* xb = x + row0 * d;
  const TW* wb = w + (long long)e * d * f + c0;

  __shared__ float xs[2][kBK][kXPad];
  __shared__ __align__(16) float ws[2][kBK][kBN];

  const int tid = threadIdx.x;
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
      load_row<4>(xb + (long long)xr * d + kx, x_vec && kx + 4 <= d,
                  d - kx, xreg);
    else
      xreg[0] = xreg[1] = xreg[2] = xreg[3] = 0.f;
    const int kw = k0 + wk, cw = c0 + wn;
    if (kw < d && cw < f)
      load_row<8>(wb + (long long)kw * f + wn, w_vec && cw + 8 <= f,
                  f - cw, wreg);
    else
#pragma unroll
      for (int i = 0; i < 8; ++i) wreg[i] = 0.f;
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) xs[buf][xk + i][xr] = xreg[i];
    float4* dst = reinterpret_cast<float4*>(&ws[buf][wk][wn]);
    dst[0] = make_float4(round_to<TX>(wreg[0]), round_to<TX>(wreg[1]),
                         round_to<TX>(wreg[2]), round_to<TX>(wreg[3]));
    dst[1] = make_float4(round_to<TX>(wreg[4]), round_to<TX>(wreg[5]),
                         round_to<TX>(wreg[6]), round_to<TX>(wreg[7]));
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
    TX* yr = y + (row0 + r) * f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c < f) yr[c] = from_f32<TX>(acc[i][j]);
    }
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* tile_expert,
                   const void* tile_rows, const void* w, void* y,
                   int n_tiles, int tile_m, int n_expert, int d, int f,
                   cudaStream_t stream) {
  const int slices = (tile_m + kBM - 1) / kBM;
  const long long grid_y = (long long)n_tiles * slices;
  if (grid_y > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((f + kBN - 1) / kBN, (unsigned)grid_y);
  // 16-byte loads of 4 x elements and 8 w elements stay aligned when the
  // rows are multiples of them and the bases are 16-byte aligned
  const bool x_vec = d % 4 == 0 && (uintptr_t)x % 16 == 0;
  const bool w_vec = f % 8 == 0 && (uintptr_t)w % 16 == 0;
  gmm_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
      (const TX*)x, (const int*)tile_expert, (const int*)tile_rows,
      (const TW*)w, (TX*)y, n_expert, d, f, tile_m, slices, x_vec, w_vec);
  return cudaGetLastError();
}

}  // namespace

// x: (n_tiles * tile_m, d) in `x_dtype` (0 = float32, 1 = bfloat16), rows
// sorted by expert and padded so that row tile t belongs to expert
// tile_expert[t]; tile_expert, tile_rows: (n_tiles,) int32, tile_rows[t]
// the number of valid rows at the head of tile t (0 for a padding tile);
// w: (n_expert, d, f) in `w_dtype`; y: (n_tiles * tile_m, f) in x_dtype.
// All contiguous.  Writes the valid rows of y only.  Returns the
// cudaGetLastError() code of the launch.
extern "C" int moe_gmm_launch(const void* x, const void* tile_expert,
                              const void* tile_rows, const void* w, void* y,
                              int n_tiles, int tile_m, int n_expert, int d,
                              int f, int x_dtype, int w_dtype, int device,
                              void* stream) {
  if (n_tiles <= 0 || tile_m <= 0 || n_expert <= 0 || d <= 0 || f <= 0 ||
      (x_dtype != 0 && x_dtype != 1) || (w_dtype != 0 && w_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && w_dtype == 0)
    err = launch<float, float>(x, tile_expert, tile_rows, w, y, n_tiles,
                               tile_m, n_expert, d, f, s);
  else if (x_dtype == 0)
    err = launch<float, bf16>(x, tile_expert, tile_rows, w, y, n_tiles,
                              tile_m, n_expert, d, f, s);
  else if (w_dtype == 0)
    err = launch<bf16, float>(x, tile_expert, tile_rows, w, y, n_tiles,
                              tile_m, n_expert, d, f, s);
  else
    err = launch<bf16, bf16>(x, tile_expert, tile_rows, w, y, n_tiles,
                             tile_m, n_expert, d, f, s);
  return (int)err;
}

extern "C" const char* moe_gmm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
