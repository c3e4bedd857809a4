// Mandelbrot escape-time counts on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mandelbrot/kernel.py
// (_mandelbrot_kernel / mandelbrot): int32 (H, W) counts of the steps of
// z <- z^2 + c with |z|^2 <= 4, over max_iterations masked steps, with
// c = (x0 + delta * col) + i (y0 + delta * row).  There is no input array.
//
// What bounds it on this card: operations.  Each pixel does 9 f32 operations
// per step and writes 4 bytes once, so the work is thousands of times the
// bytes; the bound is the f32 rate (67 TFLOP/s outside the tensor cores) over
// the steps the pixels actually need.
//
// How the design answers that:
// * One thread per pixel on a 2-D grid whose x dimension runs along a row, so
//   a warp's int32 stores coalesce into one 128-byte write.
// * A thread leaves its loop once the pixel escapes.  The TPU kernel keeps
//   every lane stepping with a masked update; after escape that update leaves
//   z and the count unchanged, so stopping early gives the same counts and
//   does only the work the data needs.
// * x0, y0, delta and max_iterations are runtime arguments (the TPU kernel
//   bakes them in), so one build serves every band and window.  A farm band
//   passes its first row as a device int32 pointer (row0): the kernel forms
//   y0 + delta * row0 itself, and the host never reads the band index back.
// * Every product and sum is rounded on its own (__fmul_rn / __fadd_rn /
//   __fsub_rn) in the order of the plain PyTorch version.  nvcc would
//   otherwise contract them into FMAs, which flips pixels on the set's
//   boundary; done this way the kernel equals the plain version exactly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;  // one warp along a row
constexpr int kBlockY = 8;

__global__ void mandelbrot_kernel(int32_t* __restrict__ out, int height,
                                  int width, float x0, float y0, float delta,
                                  const int32_t* __restrict__ row0,
                                  int max_iterations) {
  const int col = blockIdx.x * kBlockX + threadIdx.x;
  const int row = blockIdx.y * kBlockY + threadIdx.y;
  if (col >= width || row >= height) return;
  float top = y0;
  if (row0 != nullptr) top = __fadd_rn(y0, __fmul_rn(delta, (float)row0[0]));
  const float ci = __fadd_rn(top, __fmul_rn(delta, (float)row));
  const float cr = __fadd_rn(x0, __fmul_rn(delta, (float)col));
  float zr = 0.0f, zi = 0.0f;
  int count = 0;
  for (int it = 0; it < max_iterations; ++it) {
    const float zr2 = __fmul_rn(zr, zr);
    const float zi2 = __fmul_rn(zi, zi);
    if (!(__fadd_rn(zr2, zi2) <= 4.0f)) break;  // escaped: frozen from here
    const float nzr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
    const float nzi = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, zr), zi), ci);
    zr = nzr;
    zi = nzi;
    ++count;
  }
  out[(size_t)row * width + col] = count;
}

}  // namespace

extern "C" int mandelbrot_launch(void* out, int height, int width, float x0,
                                 float y0, float delta, const void* row0,
                                 int max_iterations, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY);
  mandelbrot_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, height, width, x0, y0, delta, (const int32_t*)row0,
      max_iterations);
  return (int)cudaGetLastError();
}

extern "C" const char* mandelbrot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
