// Mamba2 SSD (state-space duality) chunked scan on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py:25
// (_ssd_kernel, called by ssd_scan).  For each (batch row b, head h) it runs
//
//     h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * B_t (x) x_t      h: (N, P)
//     y_t = C_t . h_t
//
// in the chunked form: per chunk of 64 steps, with cum the inclusive prefix
// sum of the log-decays a = dt * A_h (<= 0) and total its last entry,
//   intra-chunk   y  = ((C B^T) * exp(cum_t - cum_s) * [s <= t] * dt_s) x
//   inter-chunk   y += exp(cum_t) * (C h)
//   state         h  = exp(total) h + B^T ((exp(total - cum_s) dt_s) * x)
// and writes y (x's type) and, when asked, the final state hT (f32).
//
// What bounds it on this card: bytes.  At the mamba2-2.7b forward's shape
// (batch 4, S 2048, H 80, P 64, N 128, one group, bf16) the function reads
// x, B, C, dt and writes y once, 174.6 MB, against about 150 operations a
// byte, below the ~295 a byte at which the bf16 tensor cores (989 TFLOP/s)
// would bind before the memory (3.35 TB/s).
//
// Two kernels, chosen here by dtype (the C code alone owns the rule):
// * bf16: ssd_mma_kernel, the four products of a chunk on the tensor cores
//   as mma.sync m16n8k16 (bf16 x bf16 -> f32, csrc/mma_bf16.cuh).  A block
//   of 4 warps owns one (b, h) and walks the chunks in order; warp w owns
//   the chunk's rows t in [16 w, 16 w + 16) and the state's rows n in
//   [w NP / 4, (w + 1) NP / 4).  Per chunk:
//     G = C B^T       A = C (ldmatrix, kept in registers for C h), B = B
//                     rows; only the blocks on or below the diagonal
//     W = G * exp(cum_t - cum_s) * dt_s, formed in G's registers, which are
//                     the A fragments of W x
//     y = exp(cum_t) (C h) + W x, one f32 accumulator; x by ldmatrix.trans
//     h = exp(total) h + B^T u, u_s = exp(total - cum_s) dt_s x_s; B^T by
//                     ldmatrix.trans, the f32 accumulator seeded with the
//                     decayed state.
//   Why hi + lo: W, h and u are f32.  Each goes in as two bf16 operands,
//   hi = bf16(v) and lo = bf16(v - hi) (about 16 bits of v), in two mma
//   passes; the other operand of each of these products is an exact bf16
//   input (x, C, B), so the dropped lo * lo term is not there to lose and
//   the products keep f32-level accuracy.  The state carries 32 chunks of
//   error at S 2048 and is held to 2e-4 against the f32 plain version.
//   Layout: the state lives in the state product's accumulator registers
//   for the whole sequence (64 floats a thread at N 128); shared memory
//   holds its bf16 hi and lo copies for C h, the chunk's x, u (hi, lo), B
//   and C as bf16 and the chunk's cum, dt and u weights: 97.8 KB at NP 128,
//   PP 64 (two blocks an SM), 63.8 KB at NP 64.  Rows are padded by 8
//   elements, so the eight row addresses of every ldmatrix fall on distinct
//   banks.  Loads: rows that are 16-byte aligned (base, seq stride and
//   width in multiples of 8 elements) arrive by cp.async, the next chunk's
//   x and C while this chunk's state product runs and its B while the state
//   is written back (the buffers are free by then; a second set would not
//   leave room for two blocks an SM); other rows go through registers
//   element by element, at the same points: no row is refused.  Loaded at
//   the top of each chunk instead, the rows' latency adds to the products'
//   time at two blocks an SM.
// * f32: ssd_kernel, every product on the f32 FMA units out of shared
//   memory (256 threads, a thread owns a 4-row slice of the (64, 64) tiles
//   and rows ty + 16 i, columns tx + 16 j of the state).
//
// What is left for later: wgmma with the operands read from shared memory,
// C B^T computed once per group and shared by its heads (today every head
// recomputes it), a chunk-parallel split of the sequence (a grid of
// batch * heads blocks, 320 at the mamba2 shape, does not fill two waves
// of 132 SMs evenly).
//
// What both keep from the TPU kernel's structure, and where they leave it:
// * The TPU kernel keeps h in VMEM scratch across a sequential chunk grid
//   axis.  Hopper blocks run in parallel and in no order, so one block owns
//   one (b, h) and walks the chunks itself, with h on the SM (shared memory
//   or registers) for the whole sequence.
// * a = dt * A_h is formed here, so the wrapper does not materialise it;
//   its inclusive prefix sum is one warp's shuffles.
// * exp(cum_t - cum_s) is evaluated only for s <= t, where the exponent is
//   non-positive; above the diagonal the weight is set to zero, never
//   multiplied by a mask, so a large |dt * A| cannot make inf * 0.
// * B and C are read through the group index h / (H / G): the (b * H, S, N)
//   broadcast of the TPU wrapper is never formed.
// * A ragged last chunk is masked: its missing steps load as dt = 0, x = B =
//   C = 0, which leaves cum flat and adds nothing, and their rows of y are
//   not stored.  The TPU wrapper instead takes a ragged sequence as one
//   chunk; the function is the same up to the order of the sums.
// * x, dt, B, C and y are addressed through their (batch, seq, head or
//   group) strides, so the model's (B, S, H, P) views of its projection go
//   in without a copy.
// * P and N are padded in shared memory (zeros, which add nothing): the FMA
//   kernel to 16 or 64 and to 16, 64 or 128 (rows of B and C padded by one
//   float so its strided reads hit distinct banks), the tensor-core kernel
//   to 16 or 64 and to 64 or 128.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kChunk = 64;      // steps per chunk
constexpr int kThreads = 256;   // 16 x 16

struct Strides {
  long long x[3], dt[3], b[3], c[3], y[3];  // (batch, seq, head or group)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <int NP, int PP>
constexpr size_t smem_bytes() {
  // xs: kChunk x PP; bs, cs: kChunk x (NP + 1); hs: NP x PP;
  // ws: kChunk x (kChunk + 1); dts, cum, ecum, wst: kChunk each
  return sizeof(float) * ((size_t)kChunk * PP + 2 * (size_t)kChunk * (NP + 1) +
                          (size_t)NP * PP + (size_t)kChunk * (kChunk + 1) +
                          4 * (size_t)kChunk);
}

template <int NP, int PP, typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y,
           float* __restrict__ hT, int seq, int n_heads, int heads_per_group,
           int P, int N, Strides st) {
  constexpr int BP = NP + 1;      // pitch of bs and cs
  constexpr int WP = kChunk + 1;  // pitch of ws
  constexpr int NI = NP / 16;     // state rows per thread
  constexpr int NJ = PP / 16;     // y and state columns per thread
  extern __shared__ float smem[];
  float* xs = smem;
  float* bs = xs + kChunk * PP;
  float* cs = bs + kChunk * BP;
  float* hs = cs + kChunk * BP;
  float* ws = hs + NP * PP;
  float* dts = ws + kChunk * WP;
  float* cum = dts + kChunk;
  float* ecum = cum + kChunk;
  float* wst = ecum + kChunk;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int g = h / heads_per_group;
  const float a_head = A[h];

  const T* xp = x + b * st.x[0] + h * st.x[2];
  const float* dtp = dt + b * st.dt[0] + h * st.dt[2];
  const T* bp = Bm + b * st.b[0] + g * st.b[2];
  const T* cp = Cm + b * st.c[0] + g * st.c[2];
  T* yp = y + b * st.y[0] + h * st.y[2];

  for (int i = tid; i < NP * PP; i += kThreads) hs[i] = 0.0f;

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int rows = min(kChunk, seq - t0);

    // -- this chunk's x, B, C and dt, as f32, zeros past the sequence ------
    for (int i = tid; i < kChunk * PP; i += kThreads) {
      const int r = i / PP, c = i % PP;
      float v = 0.0f;
      if (r < rows && c < P) v = to_f32(xp[(long long)(t0 + r) * st.x[1] + c]);
      xs[i] = v;
    }
    for (int i = tid; i < kChunk * NP; i += kThreads) {
      const int r = i / NP, c = i % NP;
      float bv = 0.0f, cv = 0.0f;
      if (r < rows && c < N) {
        bv = to_f32(bp[(long long)(t0 + r) * st.b[1] + c]);
        cv = to_f32(cp[(long long)(t0 + r) * st.c[1] + c]);
      }
      bs[r * BP + c] = bv;
      cs[r * BP + c] = cv;
    }
    if (tid < kChunk)
      dts[tid] = tid < rows ? dtp[(long long)(t0 + tid) * st.dt[1]] : 0.0f;
    __syncthreads();

    // -- inclusive prefix sum of a = dt * A_h, by warp 0 (two steps a lane) --
    if (tid < 32) {
      float lo = dts[tid] * a_head, hi = dts[tid + 32] * a_head;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float l = __shfl_up_sync(0xffffffffu, lo, off);
        const float u = __shfl_up_sync(0xffffffffu, hi, off);
        if (tid >= off) {
          lo += l;
          hi += u;
        }
      }
      hi += __shfl_sync(0xffffffffu, lo, 31);
      const float total = __shfl_sync(0xffffffffu, hi, 31);
      cum[tid] = lo;
      cum[tid + 32] = hi;
      ecum[tid] = expf(lo);
      ecum[tid + 32] = expf(hi);
      wst[tid] = expf(total - lo) * dts[tid];
      wst[tid + 32] = expf(total - hi) * dts[tid + 32];
    }
    __syncthreads();

    // -- W = (C B^T) * exp(cum_t - cum_s) * dt_s for s <= t, else 0 ---------
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
      for (int n = 0; n < NP; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * BP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * BP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          ws[t * WP + s] =
              s <= t ? acc[i][j] * expf(cum[t] - cum[s]) * dts[s] : 0.0f;
        }
      }
    }
    __syncthreads();

    // -- y = W x + exp(cum_t) (C h), rows ty + 16 i, columns tx + 16 j ------
    {
      float intra[4][NJ], inter[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) intra[i][j] = inter[i][j] = 0.0f;
#pragma unroll 8
      for (int s = 0; s < kChunk; ++s) {
        float wv[4], xv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = ws[(ty + 16 * i) * WP + s];
#pragma unroll
        for (int j = 0; j < NJ; ++j) xv[j] = xs[s * PP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            intra[i][j] = fmaf(wv[i], xv[j], intra[i][j]);
      }
#pragma unroll 8
      for (int n = 0; n < NP; ++n) {
        float cv[4], hv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * BP + n];
#pragma unroll
        for (int j = 0; j < NJ; ++j) hv[j] = hs[n * PP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            inter[i][j] = fmaf(cv[i], hv[j], inter[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= rows) continue;
        T* row = yp + (long long)(t0 + t) * st.y[1];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int p = tx + 16 * j;
          if (p < P) store(&row[p], intra[i][j] + ecum[t] * inter[i][j]);
        }
      }
    }
    __syncthreads();  // every y row has read the state entering this chunk

    // -- h = exp(total) h + sum_s (B_s w_s) x_s, rows ty + 16 i, cols tx + 16 j
    {
      const float decay = expf(cum[kChunk - 1]);
      float acc[NI][NJ];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[i][j] = decay * hs[(ty + 16 * i) * PP + tx + 16 * j];
#pragma unroll 4
      for (int s = 0; s < kChunk; ++s) {
        const float w = wst[s];
        float bv[NI], xv[NJ];
#pragma unroll
        for (int i = 0; i < NI; ++i) bv[i] = bs[s * BP + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < NJ; ++j) xv[j] = xs[s * PP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          hs[(ty + 16 * i) * PP + tx + 16 * j] = acc[i][j];
    }
    __syncthreads();  // the next chunk refills xs, bs, cs and reads hs
  }

  if (hT != nullptr) {
    float* hp = hT + (long long)bh * N * P;
    for (int i = tid; i < NP * PP; i += kThreads) {
      const int n = i / PP, p = i % PP;
      if (n < N && p < P) hp[n * P + p] = hs[i];
    }
  }
}

template <int NP, int PP, typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* hT,
                   int batch, int seq, int n_heads, int heads_per_group,
                   int p, int n, const Strides& st, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<NP, PP>();  // above 48 KB but at 16/16
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<NP, PP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_kernel<NP, PP, T><<<batch * n_heads, kThreads, bytes, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B,
      (const T*)C, (T*)y, (float*)hT, seq, n_heads, heads_per_group, p, n,
      st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* A,
                     const void* B, const void* C, void* y, void* hT,
                     int batch, int seq, int n_heads, int hpg, int p, int n,
                     const Strides& st, cudaStream_t s) {
  const int pp = p <= 16 ? 16 : 64;
  const int np = n <= 16 ? 16 : n <= 64 ? 64 : 128;
#define SSD_CASE(NP_, PP_)                                                   \
  if (np == NP_ && pp == PP_)                                                \
    return launch<NP_, PP_, T>(x, dt, A, B, C, y, hT, batch, seq, n_heads,   \
                               hpg, p, n, st, s);
  SSD_CASE(16, 16)
  SSD_CASE(16, 64)
  SSD_CASE(64, 16)
  SSD_CASE(64, 64)
  SSD_CASE(128, 16)
  SSD_CASE(128, 64)
#undef SSD_CASE
  return cudaErrorInvalidValue;
}

// -- the tensor-core path (bf16) -------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;  // warp w: chunk rows 16 w.., state rows w NP / 4..
constexpr int kThreads = 32 * kWarps;

template <int NP, int PP>
constexpr size_t smem_bytes() {
  // xs, uh, ul: kChunk x (PP + 8); hh, hl: NP x (PP + 8); bs, cs: kChunk x
  // (NP + 8), all bf16; cum, dts, ws: kChunk floats
  return sizeof(bf16) * (3 * (size_t)kChunk * (PP + 8) +
                         2 * (size_t)NP * (PP + 8) +
                         2 * (size_t)kChunk * (NP + 8)) +
         sizeof(float) * 3 * kChunk;
}

// v0, v1 as hi + lo bf16 pairs (packed, v0 in the lower half):
// hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = mma::pack_bf16(v0 - hf.x, v1 - hf.y);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Rows [t0, t0 + kChunk) of x (one head) or of B or C (one group) into
// shared memory: W columns at pitch `pitch`, zeros past `rows` and past the
// first n columns.  Rows that are 16-byte aligned (`vec`) go by cp.async,
// which the caller commits and waits for; others through registers,
// element by element.
template <int W>
__device__ __forceinline__ void load_rows(bf16* dst, int pitch,
                                          const bf16* __restrict__ src,
                                          long long seq_stride, int t0,
                                          int rows, int n, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < kChunk * W / 8; i += kThreads) {
      const int r = i / (W / 8), c = i % (W / 8) * 8;
      const bool in = r < rows && c < n;
      mma::cp_async_16(mma::smem_addr(dst + r * pitch + c),
                       in ? src + (long long)(t0 + r) * seq_stride + c : src,
                       in ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.0f);
    for (int i = threadIdx.x; i < kChunk * W; i += kThreads) {
      const int r = i / W, c = i % W;
      dst[r * pitch + c] =
          r < rows && c < n ? src[(long long)(t0 + r) * seq_stride + c] : zero;
    }
  }
}

template <int NP, int PP>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const bf16* __restrict__ Bm,
                   const bf16* __restrict__ Cm, bf16* __restrict__ y,
                   float* __restrict__ hT, int seq, int n_heads,
                   int heads_per_group, int P, int N, Strides st) {
  constexpr int XP = PP + 8;     // pitch of xs, uh, ul, hh, hl
  constexpr int BP = NP + 8;     // pitch of bs, cs
  constexpr int KN = NP / 16;    // k-steps over the state rows
  constexpr int NT = PP / 8;     // column tiles of y and of the state
  constexpr int MW = NP / 64;    // state row tiles of a warp
  static_assert(NP % 64 == 0 && PP % 16 == 0, "tile shapes");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* uh = xs + kChunk * XP;
  bf16* ul = uh + kChunk * XP;
  bf16* hh = ul + kChunk * XP;
  bf16* hl = hh + NP * XP;
  bf16* bs = hl + NP * XP;
  bf16* cs = bs + kChunk * BP;
  float* cum = reinterpret_cast<float*>(cs + kChunk * BP);
  float* dts = cum + kChunk;
  float* ws = dts + kChunk;  // u's weights exp(total - cum_s) dt_s

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int grp = h / heads_per_group;
  const float a_head = A[h];

  const bf16* xp = x + b * st.x[0] + h * st.x[2];
  const float* dtp = dt + b * st.dt[0] + h * st.dt[2];
  const bf16* bp = Bm + b * st.b[0] + grp * st.b[2];
  const bf16* cp = Cm + b * st.c[0] + grp * st.c[2];
  bf16* yp = y + b * st.y[0] + h * st.y[2];
  // 16-byte rows: base, seq stride and width in multiples of 8 elements
  const bool xvec = P % 8 == 0 && st.x[1] % 8 == 0 &&
                    (reinterpret_cast<uintptr_t>(xp) & 15) == 0;
  const bool bvec = N % 8 == 0 && st.b[1] % 8 == 0 &&
                    (reinterpret_cast<uintptr_t>(bp) & 15) == 0;
  const bool cvec = N % 8 == 0 && st.c[1] % 8 == 0 &&
                    (reinterpret_cast<uintptr_t>(cp) & 15) == 0;

  // the state: rows 16 (warp MW + i) + g (+ 8), columns 8 j + 2 t4 (+ 1)
  float hacc[MW][NT][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) hacc[i][j][c] = 0.0f;
  for (int i = tid; i < NP * XP; i += kThreads)
    hh[i] = hl[i] = __float2bfloat16_rn(0.0f);

  // x, C and B of the first chunk; later chunks' copies fly while the
  // chunk before is computed (x and C during its state product, B while
  // its state is written back)
  load_rows<PP>(xs, XP, xp, st.x[1], 0, min(kChunk, seq), P, xvec);
  load_rows<NP>(cs, BP, cp, st.c[1], 0, min(kChunk, seq), N, cvec);
  load_rows<NP>(bs, BP, bp, st.b[1], 0, min(kChunk, seq), N, bvec);
  mma::cp_async_commit();

  const int tr0 = warp * 16 + g, tr1 = tr0 + 8;  // this thread's y rows
  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int rows = min(kChunk, seq - t0);
    const int next = t0 + kChunk, next_rows = min(kChunk, seq - next);

    // -- prefix sum of a = dt * A_h by warp 0 (lane l: steps l, l + 32) ----
    if (warp == 0) {
      const float d_lo =
          lane < rows ? dtp[(long long)(t0 + lane) * st.dt[1]] : 0.0f;
      const float d_hi =
          lane + 32 < rows ? dtp[(long long)(t0 + lane + 32) * st.dt[1]]
                           : 0.0f;
      float c_lo = d_lo * a_head, c_hi = d_hi * a_head;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float l = __shfl_up_sync(0xffffffffu, c_lo, off);
        const float u = __shfl_up_sync(0xffffffffu, c_hi, off);
        if (lane >= off) {
          c_lo += l;
          c_hi += u;
        }
      }
      c_hi += __shfl_sync(0xffffffffu, c_lo, 31);
      const float total = __shfl_sync(0xffffffffu, c_hi, 31);
      cum[lane] = c_lo;
      cum[lane + 32] = c_hi;
      dts[lane] = d_lo;
      dts[lane + 32] = d_hi;
      ws[lane] = expf(total - c_lo) * d_lo;
      ws[lane + 32] = expf(total - c_hi) * d_hi;
    }
    mma::cp_async_wait<0>();
    __syncthreads();  // the chunk, cum, dt, ws and the entering state

    // -- u = ws * x as bf16 hi + lo, for the state product ------------------
    for (int i = tid; i < kChunk * PP / 8; i += kThreads) {
      const int r = i / (PP / 8), c = i % (PP / 8) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(xs + r * XP + c);
      const float w = ws[r];
      const uint32_t in[4] = {v.x, v.y, v.z, v.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = unpack_bf16(in[k]);
        split_bf16(f.x * w, f.y * w, hi[k], lo[k]);
      }
      *reinterpret_cast<uint4*>(uh + r * XP + c) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(ul + r * XP + c) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }

    // -- y = exp(cum_t) (C h) + W x, rows tr0 and tr1 ------------------------
    uint32_t cf[KN][4];  // C of this warp's rows, every k-step over n
#pragma unroll
    for (int k = 0; k < KN; ++k)
      mma::ldmatrix_x4(cf[k], mma::smem_addr(cs + (warp * 16 + lane % 16) * BP +
                                             k * 16 + lane / 16 * 8));
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
#pragma unroll
    for (int k = 0; k < KN; ++k) {
      const int row = k * 16 + lane % 8 + (lane / 8) % 2 * 8;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        mma::ldmatrix_x4_trans(
            r, mma::smem_addr(hh + row * XP + np * 16 + lane / 16 * 8));
        mma::mma_16816(acc[2 * np], cf[k], r[0], r[1]);
        mma::mma_16816(acc[2 * np + 1], cf[k], r[2], r[3]);
        mma::ldmatrix_x4_trans(
            r, mma::smem_addr(hl + row * XP + np * 16 + lane / 16 * 8));
        mma::mma_16816(acc[2 * np], cf[k], r[0], r[1]);
        mma::mma_16816(acc[2 * np + 1], cf[k], r[2], r[3]);
      }
    }
    const float ct0 = cum[tr0], ct1 = cum[tr1];
    {
      const float e0 = expf(ct0), e1 = expf(ct1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
    }
    // W x over the column blocks kk <= warp (the rest lie above the diagonal)
    for (int kk = 0; kk <= warp; ++kk) {
      float gt[2][4];  // G = C B^T, columns s = 16 kk + 8 j + 2 t4 (+ 1)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) gt[j][c] = 0.0f;
#pragma unroll
      for (int k = 0; k < KN; ++k) {
        uint32_t r[4];
        mma::ldmatrix_x4(r, mma::smem_addr(bs + (kk * 16 + lane % 8 +
                                                 lane / 16 * 8) * BP +
                                           k * 16 + (lane / 8) % 2 * 8));
        mma::mma_16816(gt[0], cf[k], r[0], r[1]);
        mma::mma_16816(gt[1], cf[k], r[2], r[3]);
      }
      // W's A fragments: a0 / a1 rows tr0 / tr1 of column tile 0, a2 / a3
      // of column tile 1; zero above the diagonal, never exp * mask
      uint32_t wh[4], wl[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s0 = kk * 16 + j * 8 + 2 * t4, s1 = s0 + 1;
        const float cs0 = cum[s0], cs1 = cum[s1];
        const float d0 = dts[s0], d1 = dts[s1];
        const float w00 = s0 <= tr0 ? gt[j][0] * expf(ct0 - cs0) * d0 : 0.0f;
        const float w01 = s1 <= tr0 ? gt[j][1] * expf(ct0 - cs1) * d1 : 0.0f;
        const float w10 = s0 <= tr1 ? gt[j][2] * expf(ct1 - cs0) * d0 : 0.0f;
        const float w11 = s1 <= tr1 ? gt[j][3] * expf(ct1 - cs1) * d1 : 0.0f;
        split_bf16(w00, w01, wh[2 * j], wl[2 * j]);
        split_bf16(w10, w11, wh[2 * j + 1], wl[2 * j + 1]);
      }
      const int row = kk * 16 + lane % 8 + (lane / 8) % 2 * 8;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        mma::ldmatrix_x4_trans(
            r, mma::smem_addr(xs + row * XP + np * 16 + lane / 16 * 8));
        mma::mma_16816(acc[2 * np], wh, r[0], r[1]);
        mma::mma_16816(acc[2 * np + 1], wh, r[2], r[3]);
        mma::mma_16816(acc[2 * np], wl, r[0], r[1]);
        mma::mma_16816(acc[2 * np + 1], wl, r[2], r[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = half ? tr1 : tr0;
      if (t >= rows) continue;
      bf16* row = yp + (long long)(t0 + t) * st.y[1];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int p = j * 8 + 2 * t4;
        if (p < P) row[p] = __float2bfloat16_rn(acc[j][2 * half]);
        if (p + 1 < P) row[p + 1] = __float2bfloat16_rn(acc[j][2 * half + 1]);
      }
    }

    __syncthreads();  // u is written; x and C of this chunk are read
    if (next < seq) {
      load_rows<PP>(xs, XP, xp, st.x[1], next, next_rows, P, xvec);
      load_rows<NP>(cs, BP, cp, st.c[1], next, next_rows, N, cvec);
      mma::cp_async_commit();
    }

    // -- h = exp(total) h + B^T (u_hi + u_lo), this warp's state rows -------
    {
      const float decay = expf(cum[kChunk - 1]);
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) hacc[i][j][c] *= decay;
    }
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      uint32_t fh[NT / 2][4], fl[NT / 2][4];
      const int row = ks * 16 + lane % 8 + (lane / 8) % 2 * 8;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        mma::ldmatrix_x4_trans(
            fh[np], mma::smem_addr(uh + row * XP + np * 16 + lane / 16 * 8));
        mma::ldmatrix_x4_trans(
            fl[np], mma::smem_addr(ul + row * XP + np * 16 + lane / 16 * 8));
      }
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        uint32_t af[4];  // B^T: rows n of this tile, k = steps of ks
        mma::ldmatrix_x4_trans(
            af, mma::smem_addr(bs + (ks * 16 + lane % 8 + lane / 16 * 8) * BP +
                               (warp * MW + i) * 16 + (lane / 8) % 2 * 8));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          mma::mma_16816(hacc[i][2 * np], af, fh[np][0], fh[np][1]);
          mma::mma_16816(hacc[i][2 * np + 1], af, fh[np][2], fh[np][3]);
          mma::mma_16816(hacc[i][2 * np], af, fl[np][0], fl[np][1]);
          mma::mma_16816(hacc[i][2 * np + 1], af, fl[np][2], fl[np][3]);
        }
      }
    }
    __syncthreads();  // B, u and the entering state are read
    if (next < seq) {
      load_rows<NP>(bs, BP, bp, st.b[1], next, next_rows, N, bvec);
      mma::cp_async_commit();
    }

    // -- the state entering the next chunk, as hi + lo for C h --------------
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = (warp * MW + i) * 16 + g + half * 8;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t hi, lo;
          split_bf16(hacc[i][j][2 * half], hacc[i][j][2 * half + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(hh + n * XP + j * 8 + 2 * t4) = hi;
          *reinterpret_cast<uint32_t*>(hl + n * XP + j * 8 + 2 * t4) = lo;
        }
      }
  }

  if (hT != nullptr) {
    float* hp = hT + (long long)bh * N * P;
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = (warp * MW + i) * 16 + g + c / 2 * 8;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int p = j * 8 + 2 * t4 + c % 2;
          if (p < P) hp[(long long)n * P + p] = hacc[i][j][c];
        }
      }
  }
}

template <int NP, int PP>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* hT,
                   int batch, int seq, int n_heads, int heads_per_group,
                   int p, int n, const Strides& st, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<NP, PP>();  // above 48 KB
  cudaError_t err = cudaFuncSetAttribute(
      ssd_mma_kernel<NP, PP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_mma_kernel<NP, PP><<<batch * n_heads, kThreads, bytes, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,
      (const bf16*)C, (bf16*)y, (float*)hT, seq, n_heads, heads_per_group, p,
      n, st);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* x, const void* dt, const void* A,
                     const void* B, const void* C, void* y, void* hT,
                     int batch, int seq, int n_heads, int hpg, int p, int n,
                     const Strides& st, cudaStream_t s) {
  const int pp = p <= 16 ? 16 : 64;
  const int np = n <= 64 ? 64 : 128;
#define SSD_MMA_CASE(NP_, PP_)                                               \
  if (np == NP_ && pp == PP_)                                                \
    return launch<NP_, PP_>(x, dt, A, B, C, y, hT, batch, seq, n_heads, hpg, \
                            p, n, st, s);
  SSD_MMA_CASE(64, 16)
  SSD_MMA_CASE(64, 64)
  SSD_MMA_CASE(128, 16)
  SSD_MMA_CASE(128, 64)
#undef SSD_MMA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// x: (batch, seq, n_heads, p) and y like it, in `dtype` (0 = float32 on
// the FMA kernel, 1 = bfloat16 on the tensor cores); dt: (batch, seq,
// n_heads) float32; A: (n_heads,) float32,
// contiguous; B, C: (batch, seq, n_groups, n) in `dtype`, head h reading
// group h / (n_heads / n_groups).  Each of x, dt, B, C, y is addressed by
// the 15 strides in `strides` (batch, seq, head or group of x, dt, B, C, y,
// in elements; the p and n axes are contiguous).  hT: (batch * n_heads, n,
// p) float32, contiguous, or null when the final state is not wanted.
// 1 <= p <= 64, 1 <= n <= 128.  Returns the cudaGetLastError() code of the
// launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* hT, int batch, int seq, int n_heads,
                               int n_groups, int p, int n, int dtype,
                               const long long* strides, int device,
                               void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || seq <= 0 ||
      n_heads <= 0 || n_groups <= 0 || n_heads % n_groups != 0 || p < 1 ||
      p > 64 || n < 1 || n > 128)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.dt[i] = strides[3 + i];
    st.b[i] = strides[6 + i];
    st.c[i] = strides[9 + i];
    st.y[i] = strides[12 + i];
  }
  const int hpg = n_heads / n_groups;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    err = dispatch<float>(x, dt, A, B, C, y, hT, batch, seq, n_heads, hpg, p,
                          n, st, s);
  else
    err = tc::dispatch(x, dt, A, B, C, y, hT, batch, seq, n_heads, hpg, p, n,
                       st, s);
  return (int)err;
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
