// Zero-padded "same" 2-D cross-correlation with an odd k x k kernel of
// constant taps, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stencil/kernel.py
// (_stencil_kernel / stencil2d_pallas): out[r, c] = sum over (dr, dc) of
// taps[dr][dc] * img[r + dr - h, c + dc - h], reading zero outside the image,
// accumulated in f32 and cast back to the image's type (f32 or bf16).
//
// What bounds it on this card: bytes.  A pixel costs at most 2 k^2 = 50 f32
// operations against 2 * itemsize bytes of traffic, about 6 operations a
// byte, far below the ~20 at which the f32 rate (67 TFLOP/s) would bind
// before the memory (3.35 TB/s).  The least time is reading the image once
// and writing the result once.
//
// How the design answers that:
// * One block per 32 x 32 output tile.  The block loads the tile and its halo
//   of h = k / 2 pixels on each side into shared memory once (zero where the
//   halo leaves the image), so every input pixel is read from device memory
//   about once; the (32 + 2h)^2 / 32^2 re-read of the halo mostly hits L2.
//   This replaces the TPU kernel's previous / current / next row-block
//   inputs and the H padding of its wrapper: the kernel masks the ragged
//   edges itself, so any H and W work without a copy.
// * A warp reads and writes 32 consecutive pixels of a row: coalesced
//   global traffic and conflict-free shared-memory reads.
// * The taps come by value in a struct of 25 floats (kernel parameter
//   space), and zero taps are skipped as the TPU kernel skips them.
//   Products and sums are rounded on their own (__fmul_rn / __fadd_rn) in
//   (dr, dc) order, the plain PyTorch version's order, so the two agree
//   exactly.
// * Templated on K in {3, 5} and on the element type, so the tap loops
//   unroll and bf16 converts on load and rounds to nearest on store.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kThreadsY = 8;  // each thread computes kTileH / kThreadsY rows

struct Taps {
  float w[25];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int K, typename T>
__global__ void stencil_kernel(const T* __restrict__ img, T* __restrict__ out,
                               int height, int width, Taps taps) {
  constexpr int H = K / 2;
  constexpr int SW = kTileW + 2 * H;
  constexpr int SH = kTileH + 2 * H;
  __shared__ float tile[SH][SW];

  const int row0 = blockIdx.y * kTileH;
  const int col0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < SH * SW; i += kTileW * kThreadsY) {
    const int r = i / SW, c = i % SW;
    const int gr = row0 - H + r, gc = col0 - H + c;
    float v = 0.0f;
    if (gr >= 0 && gr < height && gc >= 0 && gc < width)
      v = to_f32(img[(size_t)gr * width + gc]);
    tile[r][c] = v;
  }
  __syncthreads();

  const int col = col0 + threadIdx.x;
  if (col >= width) return;
#pragma unroll
  for (int rr = 0; rr < kTileH / kThreadsY; ++rr) {
    const int r = threadIdx.y + rr * kThreadsY;
    const int row = row0 + r;
    if (row >= height) break;
    float acc = 0.0f;
#pragma unroll
    for (int dr = 0; dr < K; ++dr) {
#pragma unroll
      for (int dc = 0; dc < K; ++dc) {
        const float w = taps.w[dr * K + dc];
        if (w != 0.0f)
          acc = __fadd_rn(acc, __fmul_rn(w, tile[r + dr][threadIdx.x + dc]));
      }
    }
    store(&out[(size_t)row * width + col], acc);
  }
}

template <int K, typename T>
cudaError_t launch(const void* img, void* out, int height, int width,
                   const Taps& taps, cudaStream_t stream) {
  const dim3 block(kTileW, kThreadsY);
  const dim3 grid((width + kTileW - 1) / kTileW,
                  (height + kTileH - 1) / kTileH);
  stencil_kernel<K, T><<<grid, block, 0, stream>>>(
      (const T*)img, (T*)out, height, width, taps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  taps: k * k floats in host memory,
// row-major; copied into the kernel's parameters.
extern "C" int stencil2d_launch(const void* img, void* out, int height,
                                int width, int k, int dtype,
                                const float* taps, int device, void* stream) {
  if ((k != 3 && k != 5) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Taps t{};
  for (int i = 0; i < k * k; ++i) t.w[i] = taps[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 3)
    err = dtype == 0 ? launch<3, float>(img, out, height, width, t, s)
                     : launch<3, __nv_bfloat16>(img, out, height, width, t, s);
  else
    err = dtype == 0 ? launch<5, float>(img, out, height, width, t, s)
                     : launch<5, __nv_bfloat16>(img, out, height, width, t, s);
  return (int)err;
}

extern "C" const char* stencil2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
