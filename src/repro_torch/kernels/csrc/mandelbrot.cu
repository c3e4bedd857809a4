// Mandelbrot escape-time counts on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mandelbrot/kernel.py
// (_mandelbrot_kernel / mandelbrot): int32 (H, W) counts of the steps of
// z <- z^2 + c with |z|^2 <= 4, over max_iterations masked steps, with
// c = (x0 + delta * col) + i (y0 + delta * row).  There is no input array.
//
// What bounds it on this card: operations.  Each pixel does 9 f32 operations
// per step and writes 4 bytes once, so the work is thousands of times the
// bytes; the bound is the f32 rate (67 TFLOP/s outside the tensor cores,
// which counts an FMA as two operations) over the steps the pixels actually
// need.  A step here is 8 unfused f32 operations, the escape test and the
// count: about 10 instruction slots a warp, against 4.5 lane-cycles in the
// bound, so no exact kernel gets past ~45 % of it.
//
// How the design answers that:
// * Work spread over every SM.  A farm band (32 x 4096) is small beside the
//   card, and its in-set pixels (1000 steps each) sit in contiguous column
//   ranges: with one block per 2-D tile, whole blocks were heavy or light
//   and the band lasted as long as the SM holding the most heavy blocks.
//   Here the work is cut into chunks of 32 consecutive pixels of a row (one
//   warp's task: neighbouring pixels take similar step counts, so the lanes
//   stay busy together), and chunk q lies at position (q * stride) mod
//   chunks, `stride` coprime with the chunk count and near 0.618 of it
//   (task_stride), so consecutive chunks land far apart.  A grid
//   of the card's resident warps (4 on each SM scheduler) renders chunk g
//   on warp g first: that first wave covers the whole image and starts all
//   its in-set chunks at once.  Each warp then renders a run of consecutive
//   chunks, which samples the whole image, so on a large image the warps'
//   totals come out alike.  The order is static: no counter, no host sync,
//   nothing shared between calls.
// * No branch inside a step.  A branch on the escape test at every step
//   stalls the warp behind it, which lengthens both a lone warp's step and
//   a busy scheduler's share of a step.  Steps run in branch-free batches
//   of 8 instead: a lane keeps an `inside` flag and counts while it holds,
//   the count is the loop variable, and 2 zr is zr + zr (exact, as 2.0f *
//   zr is).
// * A lane leaves a pixel at the end of the batch in which it escaped.  The
//   TPU kernel keeps every lane stepping with a masked update; after escape
//   that update leaves z and the count unchanged, so stopping early gives
//   the same counts and does only the work the data needs, to within a
//   batch.
// * x0, y0, delta and max_iterations are runtime arguments (the TPU kernel
//   bakes them in), so one build serves every band and window.  A farm band
//   passes its first row as a device int32 pointer (row0): the kernel forms
//   y0 + delta * row0 itself, and the host never reads the band index back.
// * Every product and sum is rounded on its own (__fmul_rn / __fadd_rn /
//   __fsub_rn) in the order of the plain PyTorch version.  nvcc would
//   otherwise contract them into FMAs, which flips pixels on the set's
//   boundary; done this way the kernel equals the plain version exactly.
//   max_iterations <= 0 runs no step: every count is 0.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "resident.cuh"

namespace {

constexpr int kThreads = 128;      // 4 warps: one on each scheduler of an SM
constexpr int kMaxBlocksPerSM = 4;  // 16 warps an SM
constexpr int kChunk = 32;         // pixels of a row a warp takes at once
constexpr int kUnroll = 8;

// The number of steps pixel c stays inside |z|^2 <= 4, at most
// max_iterations.  Whole batches of kUnroll steps run without a branch:
// `inside` holds while every step so far kept |z|^2 <= 4 and the count
// grows only while it holds, so the count stops at the escape as the masked
// update's does; z goes on changing after the escape, and nothing reads it.
// The last max_iterations % kUnroll steps test and leave at every step.
__device__ __forceinline__ int escape_count(float cr, float ci,
                                            int max_iterations) {
  float zr = 0.0f, zi = 0.0f;
  int it = 0;
  for (; max_iterations - it >= kUnroll; it += kUnroll) {
    bool inside = true;
    int count = it;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float zr2 = __fmul_rn(zr, zr);
      const float zi2 = __fmul_rn(zi, zi);
      inside = inside & (__fadd_rn(zr2, zi2) <= 4.0f);
      count += inside;
      zi = __fadd_rn(__fmul_rn(__fadd_rn(zr, zr), zi), ci);
      zr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
    }
    if (!inside) return count;
  }
  for (; it < max_iterations; ++it) {
    const float zr2 = __fmul_rn(zr, zr);
    const float zi2 = __fmul_rn(zi, zi);
    if (!(__fadd_rn(zr2, zi2) <= 4.0f)) return it;  // escaped
    zi = __fadd_rn(__fmul_rn(__fadd_rn(zr, zr), zi), ci);
    zr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
  }
  return it;
}

// Chunk q (0 <= q < chunks) lies at position (q * stride) mod chunks,
// which covers pixels (pos / chunks_per_row, 32 (pos % chunks_per_row) +
// lane).  Warp g of n_warps renders chunk g first, so the first wave is
// spread over the whole image and every in-set chunk of it starts at once;
// then the chunks n_warps + g * per_warp + j, j < per_warp: a run of
// consecutive q, whose positions step by `stride` and so sample the whole
// image, which keeps the warps' totals alike on a large image.
__global__ void __launch_bounds__(kThreads)
    mandelbrot_kernel(int32_t* __restrict__ out, int width, float x0,
                      float y0, float delta,
                      const int32_t* __restrict__ row0, int max_iterations,
                      unsigned chunks_per_row, unsigned chunks,
                      unsigned stride, unsigned per_warp) {
  float top = y0;
  if (row0 != nullptr) top = __fadd_rn(y0, __fmul_rn(delta, (float)row0[0]));
  const unsigned lane = threadIdx.x % 32;
  const unsigned warp = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const unsigned n_warps = gridDim.x * (kThreads / 32);
  const unsigned long long first =
      n_warps + (unsigned long long)warp * per_warp;
  const unsigned long long last = first + per_warp;
  unsigned q = warp;
  unsigned pos = (unsigned)((unsigned long long)q * stride % chunks);
  for (int k = 0; q < chunks; ++k) {
    const unsigned row = pos / chunks_per_row;
    const unsigned col = (pos - row * chunks_per_row) * kChunk + lane;
    if (col < (unsigned)width) {
      const float ci = __fadd_rn(top, __fmul_rn(delta, (float)row));
      const float cr = __fadd_rn(x0, __fmul_rn(delta, (float)col));
      out[(size_t)row * width + col] = escape_count(cr, ci, max_iterations);
    }
    if (k == 0) {  // on to this warp's run
      if (first >= chunks) break;
      q = (unsigned)first;
      pos = (unsigned)(first * stride % chunks);
    } else {
      if (++q >= last) break;
      pos += stride;  // pos, stride < chunks < 2^31: no wrap of the sum
      if (pos >= chunks) pos -= chunks;
    }
  }
}

// Blocks a launch uses: the card's resident blocks of this kernel (up to
// kMaxBlocksPerSM on each SM), and never more than the chunks need.
int grid_size(int device, unsigned chunks) {
  static std::atomic<int> resident[64];  // zeroed: static storage
  const int r = resident_blocks(mandelbrot_kernel, resident, device, kThreads,
                                0, kMaxBlocksPerSM);
  const unsigned warps_per_block = kThreads / 32;
  const unsigned need = (chunks + warps_per_block - 1) / warps_per_block;
  return need < (unsigned)r ? (int)need : r;
}

unsigned gcd(unsigned a, unsigned b) {
  while (b != 0) {
    const unsigned t = a % b;
    a = b, b = t;
  }
  return a;
}

// The smallest integer at or above 0.618 chunks (rounded) that is coprime
// with `chunks`, reduced mod chunks: q -> (q * stride) mod chunks then
// permutes the chunks and sends consecutive q far apart.
unsigned task_stride(unsigned chunks) {
  if (chunks <= 1) return 0;
  unsigned stride = (unsigned)std::llround(chunks * 0.6180339887498949);
  while (gcd(stride, chunks) != 1) ++stride;
  return stride % chunks;
}

}  // namespace

extern "C" int mandelbrot_launch(void* out, int height, int width, float x0,
                                 float y0, float delta, const void* row0,
                                 int max_iterations, int device,
                                 void* stream) {
  const unsigned long long per_row =
      ((unsigned long long)width + kChunk - 1) / kChunk;
  const unsigned long long chunks = (unsigned long long)height * per_row;
  if (height <= 0 || width <= 0 || chunks >= (1ull << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned stride = task_stride((unsigned)chunks);
  const int grid = grid_size(device, (unsigned)chunks);
  const unsigned long long n_warps = grid * (kThreads / 32);
  const unsigned per_warp =
      chunks > n_warps ? (unsigned)((chunks - n_warps + n_warps - 1) / n_warps)
                       : 0;
  mandelbrot_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, width, x0, y0, delta, (const int32_t*)row0,
      max_iterations, (unsigned)per_row, (unsigned)chunks, stride, per_warp);
  return (int)cudaGetLastError();
}

extern "C" const char* mandelbrot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
