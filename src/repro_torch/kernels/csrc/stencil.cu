// Zero-padded "same" 2-D cross-correlation with an odd k x k kernel of
// constant taps, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stencil/kernel.py
// (_stencil_kernel / stencil2d_pallas): out[r, c] = sum over (dr, dc) of
// taps[dr][dc] * img[r + dr - h, c + dc - h], reading zero outside the image,
// accumulated in f32 and cast back to the image's type (f32, bf16 or f16).
//
// What bounds it on this card: bytes.  A pixel costs at most 2 k^2 = 50 f32
// operations against 2 * itemsize bytes of traffic, about 6 operations a
// byte, far below the ~20 at which the f32 rate (67 TFLOP/s) would bind
// before the memory (3.35 TB/s).  The least time is reading the image once
// and writing the result once.
//
// How the design answers that (k <= 9, taps by value):
// * Tiles come in without thread instructions.  A block owns 32 x 128
//   output tiles and copies each tile with its halo into shared memory by
//   16-byte cp.async (zero-filled where a copy lies outside the image, which
//   gives the zero padding), kStages tiles deep.  Blocks are persistent, one
//   grid of the card's resident blocks: while a block computes one tile,
//   the copies of its next kStages - 1 tiles are in flight.  The halo is one
//   whole 16-byte copy wide on each side, so every copy is aligned; the
//   (32 + 2h) x (128 + 2 * 16 B) tile re-reads 15-20 % beside the output,
//   mostly from L2.
// * Register blocking.  Each thread computes 4 x 4 outputs.  It reads each
//   row of its window from shared memory once, as 4-element vectors, and
//   keeps 4 rows of it in registers: the loop runs over the taps (dr
//   outer, dc inner) and, inside, over the 16 outputs, so every output's
//   sum is taken in (dr, dc) order, the plain version's.
// * Two tap loops, one instance each.  The general one multiplies and
//   adds every tap and skips zero taps, as the plain version does (one
//   uniform branch a tap, amortised over a thread's 16 outputs).  The
//   ring one serves EDGE5, the pipeline's taps: every tap but the centre
//   is -1 and is subtracted without the multiply (w * x is exactly -x,
//   signed zeros, inf and NaN included, so the result does not change),
//   26 instead of 50 f32 instructions an output.  The host picks the
//   instance from the taps (is_ring).  (Choosing subtract or multiply by a
//   branch on each tap cost more than the multiplies it saved.)
// * Widths whose rows are not 16-byte multiples (W % 4 for f32, W % 8 for
//   bf16 and f16), or an unaligned base, cannot take 16-byte copies: the
//   same kernel then loads its tiles element by element through registers
//   (same layout, same arithmetic) and stores elementwise.
// * Any larger odd k takes a runtime-k kernel: the taps sit in a small
//   device buffer that the wrapper fills from the host tuple (a
//   host-to-device copy; nothing is read back), and each thread reads its
//   window from device memory through the L1 cache, so no halo tile has to
//   fit in shared memory whatever k is.
// * Zero taps are skipped as the TPU kernel skips them.  Products and sums
//   are rounded on their own (__fmul_rn / __fadd_rn) in (dr, dc)
//   order, the plain PyTorch version's order, so every k agrees exactly.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"  // cp.async helpers
#include "resident.cuh"

namespace {

constexpr int kTileW = 128;  // output columns of a tile
constexpr int kTileH = 32;   // output rows of a tile
constexpr int kRows = 4;     // output rows of a thread
constexpr int kCols = 4;     // output columns of a thread
constexpr int kThreads = (kTileW / kCols) * (kTileH / kRows);
constexpr int kMinBlocks = 2;  // blocks an SM at least (caps the registers)
constexpr int kStages = 3;   // tiles in shared memory: 1 computed, 2 landing
static_assert(kTileW / kCols == 32, "a warp covers one row strip of a tile");

constexpr int kMaxStaticK = 9;  // larger k takes the runtime-k kernel

struct Taps {
  float w[kMaxStaticK * kMaxStaticK];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

// Four consecutive elements of shared memory (aligned to four) as f32.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void load4(const __half* p, float* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&x.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&x.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// Four f32 values rounded to T and stored at once (p aligned to four).
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <typename T2, typename T>
__device__ __forceinline__ void store4_16(T* p, T2 a, T2 b) {
  uint2 x;
  x.x = *reinterpret_cast<uint32_t*>(&a);
  x.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  store4_16(p, __floats2bfloat162_rn(v[0], v[1]),
            __floats2bfloat162_rn(v[2], v[3]));
}
__device__ __forceinline__ void store4(__half* p, const float* v) {
  store4_16(p, __floats2half2_rn(v[0], v[1]), __floats2half2_rn(v[2], v[3]));
}

// The shared-memory tile of one output tile: its rows with h halo rows
// above and below, its columns with one 16-byte copy of halo on each side.
template <int K, typename T>
struct Tile {
  static constexpr int kHalo = K / 2;
  static constexpr int kVec = 16 / sizeof(T);  // elements of one copy
  static constexpr int kPad = kVec;            // halo columns stored a side
  static constexpr int kH = kTileH + 2 * kHalo;
  static constexpr int kW = kTileW + 2 * kPad;  // the pitch, in elements
  static constexpr int kSize = kH * kW;
  static constexpr int kCopiesPerRow = kW / kVec;
  static_assert(kHalo <= kPad, "the halo fits in one copy");
};

// Copy tile `t` (with its halo, zero outside the image) into `tile`: by
// 16-byte cp.async when `aligned` (rows are whole copies and the image is
// 16-byte aligned), else element by element through registers.
template <int K, typename T>
__device__ __forceinline__ void load_tile(T* tile, const T* __restrict__ img,
                                          int height, int width, int row0,
                                          int col0, bool aligned) {
  using G = Tile<K, T>;
  if (aligned) {
    for (int i = threadIdx.x; i < G::kH * G::kCopiesPerRow; i += kThreads) {
      const int r = i / G::kCopiesPerRow, q = i - r * G::kCopiesPerRow;
      const int gr = row0 - G::kHalo + r, gc = col0 - G::kPad + q * G::kVec;
      // width is a multiple of kVec: a copy lies wholly in or out
      const bool in = gr >= 0 && gr < height && gc >= 0 && gc < width;
      mma::cp_async_16(mma::smem_addr(tile + r * G::kW + q * G::kVec),
                       in ? img + (size_t)gr * width + gc : img,
                       in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < G::kSize; i += kThreads) {
      const int r = i / G::kW, c = i - r * G::kW;
      const int gr = row0 - G::kHalo + r, gc = col0 - G::kPad + c;
      const bool in = gr >= 0 && gr < height && gc >= 0 && gc < width;
      tile[i] = in ? img[(size_t)gr * width + gc] : from_f32<T>(0.0f);
    }
  }
}

// Row j of this thread's window, as f32: the 4 + 2h columns its 4 outputs
// read, from aligned 4-element loads.
template <int K, typename T>
__device__ __forceinline__ void load_window_row(const T* row,
                                                float (&seg)[kCols + K - 1]) {
  using G = Tile<K, T>;
  constexpr int lo = (G::kPad - G::kHalo) / 4 * 4;
  constexpr int hi = (G::kPad + kCols + G::kHalo + 3) / 4 * 4;
  float raw[hi - lo];
#pragma unroll
  for (int v = 0; v < (hi - lo) / 4; ++v) load4(row + lo + 4 * v, raw + 4 * v);
#pragma unroll
  for (int m = 0; m < kCols + K - 1; ++m)
    seg[m] = raw[G::kPad - G::kHalo - lo + m];
}

// The kRows x kCols outputs of this thread in tile (row0, col0), from
// `tile`.  kRing: every tap but the centre is -1 and is subtracted; else
// every nonzero tap multiplies and adds.
template <int K, bool kRing, typename T>
__device__ __forceinline__ void compute_tile(const T* tile,
                                             T* __restrict__ out, int height,
                                             int width, int row0, int col0,
                                             const Taps& taps, bool aligned) {
  using G = Tile<K, T>;
  constexpr int S = kCols + K - 1;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const T* base = tile + ty * kRows * G::kW + tx * kCols;
  float win[kRows][S];  // window rows dr .. dr + kRows - 1, row j in slot
                        // j % kRows
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int j = 0; j < kRows - 1; ++j)
    load_window_row<K>(base + j * G::kW, win[j]);
#pragma unroll
  for (int dr = 0; dr < K; ++dr) {
    load_window_row<K>(base + (dr + kRows - 1) * G::kW,
                       win[(dr + kRows - 1) % kRows]);
#pragma unroll
    for (int dc = 0; dc < K; ++dc) {
      const float w = taps.w[dr * K + dc];
      const bool ring = kRing && (dr != K / 2 || dc != K / 2);
      if (!kRing && w == 0.0f) continue;
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float x = win[(dr + i) % kRows][j + dc];
          // w * x is exactly -x for w = -1
          acc[i][j] = ring ? __fsub_rn(acc[i][j], x)
                           : __fadd_rn(acc[i][j], __fmul_rn(w, x));
        }
    }
  }
  const int col = col0 + tx * kCols;
  if (col >= width) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + ty * kRows + i;
    if (row >= height) break;
    T* dst = out + (size_t)row * width + col;
    if (aligned) {  // width % 4 == 0: the 4 outputs lie in the image
      store4(dst, acc[i]);
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (col + j < width) store(dst + j, acc[i][j]);
    }
  }
}

// Persistent blocks: block b computes tiles b, b + grid, ...; the copies of
// its next kStages - 1 tiles are in flight while it computes one.
template <int K, bool kRing, typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    stencil_kernel(const T* __restrict__ img, T* __restrict__ out,
                   int height, int width, int tiles_x, int n_tiles,
                   bool aligned, Taps taps) {
  using G = Tile<K, T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int grid = gridDim.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int t = blockIdx.x + s * grid;
    if (t < n_tiles)
      load_tile<K>(smem + s * G::kSize, img, height, width,
                   t / tiles_x * kTileH, t % tiles_x * kTileW, aligned);
    mma::cp_async_commit();
  }
  int stage = 0;
  for (int t = blockIdx.x; t < n_tiles; t += grid) {
    mma::cp_async_wait<kStages - 2>();  // tile t has landed (this thread's)
    __syncthreads();  // ... every thread's; and tile t - grid is computed
    const int next = t + (kStages - 1) * grid;
    if (next < n_tiles)
      load_tile<K>(smem + (stage + kStages - 1) % kStages * G::kSize, img,
                   height, width, next / tiles_x * kTileH,
                   next % tiles_x * kTileW, aligned);
    mma::cp_async_commit();
    compute_tile<K, kRing>(smem + stage * G::kSize, out, height, width,
                           t / tiles_x * kTileH, t % tiles_x * kTileW, taps,
                           aligned);
    stage = (stage + 1) % kStages;
  }
  mma::cp_async_wait<0>();
}

// Any odd k: taps (k * k floats, row-major) in device memory, the window
// read from device memory (zero outside the image), one thread a pixel.
constexpr int kAnyKBlockX = 32;
constexpr int kAnyKBlockY = 8;

template <typename T>
__global__ void stencil_any_k_kernel(const T* __restrict__ img,
                                     T* __restrict__ out, int height,
                                     int width, int k,
                                     const float* __restrict__ taps) {
  const int h = k / 2;
  const int col = blockIdx.x * kAnyKBlockX + threadIdx.x;
  const int row = blockIdx.y * kAnyKBlockY + threadIdx.y;
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

template <int K, bool kRing, typename T>
cudaError_t launch(const void* img, void* out, int height, int width,
                   const Taps& taps, int device, cudaStream_t stream) {
  using G = Tile<K, T>;
  constexpr int smem = kStages * G::kSize * (int)sizeof(T);
  const auto kernel = stencil_kernel<K, kRing, T>;
  static std::atomic<int> resident[64];  // this instance's, per device
  const int r = resident_blocks(kernel, resident, device, kThreads, smem);
  if (r == 0) return cudaGetLastError();
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const long long tiles = (long long)tiles_x * ((height + kTileH - 1) / kTileH);
  if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  const int n_tiles = (int)tiles;
  const bool aligned = width % G::kVec == 0 &&
                       reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int grid = n_tiles < r ? n_tiles : r;
  kernel<<<grid, kThreads, smem, stream>>>((const T*)img, (T*)out, height,
                                           width, tiles_x, n_tiles, aligned,
                                           taps);
  return cudaGetLastError();
}

template <int K, typename T>
cudaError_t launch_k(const void* img, void* out, int height, int width,
                     const Taps& t, bool ring, int dev, cudaStream_t s) {
  return ring ? launch<K, true, T>(img, out, height, width, t, dev, s)
              : launch<K, false, T>(img, out, height, width, t, dev, s);
}

template <typename T>
cudaError_t launch_static(int k, const void* img, void* out, int height,
                          int width, const Taps& t, bool ring, int dev,
                          cudaStream_t s) {
  switch (k) {
    case 1: return launch_k<1, T>(img, out, height, width, t, ring, dev, s);
    case 3: return launch_k<3, T>(img, out, height, width, t, ring, dev, s);
    case 5: return launch_k<5, T>(img, out, height, width, t, ring, dev, s);
    case 7: return launch_k<7, T>(img, out, height, width, t, ring, dev, s);
    case 9: return launch_k<9, T>(img, out, height, width, t, ring, dev, s);
    default: return cudaErrorInvalidValue;
  }
}

// Whether a k x k kernel's taps (row-major) are a ring of -1 round a
// nonzero centre, as EDGE5's.  The centre must be nonzero: the ring loop
// multiplies by it, and the plain version skips a zero tap (0 * inf would
// be NaN).
bool is_ring(const float* taps, int k) {
  const int centre = k * k / 2;
  bool ring = k > 1 && taps[centre] != 0.0f;
  for (int i = 0; i < k * k; ++i)
    if (i != centre) ring = ring && taps[i] == -1.0f;
  return ring;
}

template <typename T>
cudaError_t launch_any_k(int k, const void* img, void* out, int height,
                         int width, const float* taps, cudaStream_t s) {
  const dim3 block(kAnyKBlockX, kAnyKBlockY);
  const dim3 grid((width + kAnyKBlockX - 1) / kAnyKBlockX,
                  (height + kAnyKBlockY - 1) / kAnyKBlockY);
  stencil_any_k_kernel<T><<<grid, block, 0, s>>>((const T*)img, (T*)out,
                                                 height, width, k, taps);
  return cudaGetLastError();
}

}  // namespace

// Returns the largest k whose taps go by value (larger k need taps_dev).
extern "C" int stencil2d_max_static_k() { return kMaxStaticK; }

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; k odd.  For k <=
// stencil2d_max_static_k() `taps` holds the k * k floats in host memory,
// row-major, copied into the kernel's parameters; for larger k `taps_dev`
// holds them in device memory (`taps` is then not read).
extern "C" int stencil2d_launch(const void* img, void* out, int height,
                                int width, int k, int dtype,
                                const float* taps, const float* taps_dev,
                                int device, void* stream) {
  if (k < 1 || k % 2 == 0 || dtype < 0 || dtype > 2 ||
      (k > kMaxStaticK && taps_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (k > kMaxStaticK) {
    switch (dtype) {
      case 0:
        return (int)launch_any_k<float>(k, img, out, height, width, taps_dev,
                                        s);
      case 1:
        return (int)launch_any_k<__nv_bfloat16>(k, img, out, height, width,
                                                taps_dev, s);
      default:
        return (int)launch_any_k<__half>(k, img, out, height, width,
                                         taps_dev, s);
    }
  }
  Taps t{};
  for (int i = 0; i < k * k; ++i) t.w[i] = taps[i];
  const bool ring = is_ring(taps, k);
  switch (dtype) {
    case 0:
      return (int)launch_static<float>(k, img, out, height, width, t, ring,
                                       device, s);
    case 1:
      return (int)launch_static<__nv_bfloat16>(k, img, out, height, width, t,
                                               ring, device, s);
    default:
      return (int)launch_static<__half>(k, img, out, height, width, t, ring,
                                        device, s);
  }
}

extern "C" const char* stencil2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
