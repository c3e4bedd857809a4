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
// * For k <= 9 the taps come by value in a struct of 81 floats (kernel
//   parameter space), and the kernel is templated on K in {1, 3, 5, 7, 9}
//   and on the element type, so the tap loops unroll and bf16 converts on
//   load and rounds to nearest on store.
// * Any larger odd k takes a runtime-k kernel: the taps sit in a small
//   device buffer that the wrapper fills from the host tuple (a
//   host-to-device copy; nothing is read back), and each thread reads its
//   window from device memory through the L1 cache, so no halo tile has to
//   fit in shared memory whatever k is.
// * Zero taps are skipped as the TPU kernel skips them.  Products and sums
//   are rounded on their own (__fmul_rn / __fadd_rn) in (dr, dc) order, the
//   plain PyTorch version's order, so every k agrees exactly.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kThreadsY = 8;  // each thread computes kTileH / kThreadsY rows

constexpr int kMaxStaticK = 9;  // larger k takes the runtime-k kernel

struct Taps {
  float w[kMaxStaticK * kMaxStaticK];
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

// Any odd k: taps (k * k floats, row-major) in device memory, the window
// read from device memory (zero outside the image), one thread a pixel.
template <typename T>
__global__ void stencil_any_k_kernel(const T* __restrict__ img,
                                     T* __restrict__ out, int height,
                                     int width, int k,
                                     const float* __restrict__ taps) {
  const int h = k / 2;
  const int col = blockIdx.x * kTileW + threadIdx.x;
  const int row = blockIdx.y * kThreadsY + threadIdx.y;
  if (col >= width || row >= height) return;
  float acc = 0.0f;
  for (int dr = 0; dr < k; ++dr) {
    const int gr = row + dr - h;
    for (int dc = 0; dc < k; ++dc) {
      const float w = taps[dr * k + dc];
      if (w == 0.0f) continue;
      const int gc = col + dc - h;
      float v = 0.0f;
      if (gr >= 0 && gr < height && gc >= 0 && gc < width)
        v = to_f32(img[(size_t)gr * width + gc]);
      acc = __fadd_rn(acc, __fmul_rn(w, v));
    }
  }
  store(&out[(size_t)row * width + col], acc);
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

template <typename T>
cudaError_t launch_static(int k, const void* img, void* out, int height,
                          int width, const Taps& t, cudaStream_t s) {
  switch (k) {
    case 1: return launch<1, T>(img, out, height, width, t, s);
    case 3: return launch<3, T>(img, out, height, width, t, s);
    case 5: return launch<5, T>(img, out, height, width, t, s);
    case 7: return launch<7, T>(img, out, height, width, t, s);
    case 9: return launch<9, T>(img, out, height, width, t, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_any_k(int k, const void* img, void* out, int height,
                         int width, const float* taps, cudaStream_t s) {
  const dim3 block(kTileW, kThreadsY);
  const dim3 grid((width + kTileW - 1) / kTileW,
                  (height + kThreadsY - 1) / kThreadsY);
  stencil_any_k_kernel<T><<<grid, block, 0, s>>>((const T*)img, (T*)out,
                                                 height, width, k, taps);
  return cudaGetLastError();
}

}  // namespace

// Returns the largest k whose taps go by value (larger k need taps_dev).
extern "C" int stencil2d_max_static_k() { return kMaxStaticK; }

// dtype: 0 = float32, 1 = bfloat16; k odd.  For k <= stencil2d_max_static_k()
// `taps` holds the k * k floats in host memory, row-major, copied into the
// kernel's parameters; for larger k `taps_dev` holds them in device memory
// (`taps` is then not read).
extern "C" int stencil2d_launch(const void* img, void* out, int height,
                                int width, int k, int dtype,
                                const float* taps, const float* taps_dev,
                                int device, void* stream) {
  if (k < 1 || k % 2 == 0 || (dtype != 0 && dtype != 1) ||
      (k > kMaxStaticK && taps_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (k > kMaxStaticK)
    return (int)(dtype == 0 ? launch_any_k<float>(k, img, out, height, width,
                                                  taps_dev, s)
                            : launch_any_k<__nv_bfloat16>(
                                  k, img, out, height, width, taps_dev, s));
  Taps t{};
  for (int i = 0; i < k * k; ++i) t.w[i] = taps[i];
  err = dtype == 0
            ? launch_static<float>(k, img, out, height, width, t, s)
            : launch_static<__nv_bfloat16>(k, img, out, height, width, t, s);
  return (int)err;
}

extern "C" const char* stencil2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
