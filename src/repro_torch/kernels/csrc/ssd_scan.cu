// Mamba2 SSD (state-space duality) chunked scan on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel / ssd_scan).  For each (batch row b, head h) it runs
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
// (batch 4, S 2048, H 80, P 64, N 128, one group, bf16) the work is about
// 150 operations a byte of x, B, C, dt and y, below the ~295 a byte at which
// the bf16 tensor cores would bind before the memory.  This first
// design runs the three products on the f32 FMA units out of shared memory,
// and recomputes C B^T for every head of a group, so it is bound by its own
// arithmetic long before the memory: it is right first; tensor cores
// (mma.sync / wgmma), sharing C B^T across a group's heads and a
// chunk-parallel split of the sequence are later work.
//
// How the design answers the TPU kernel's structure:
// * The TPU kernel keeps h in VMEM scratch across a sequential chunk grid
//   axis.  Hopper blocks run in parallel and in no order, so one block of
//   256 threads owns one (b, h) and walks the chunks itself, with h
//   (N x P f32, 32 KiB at N 128, P 64) in shared memory for the whole
//   sequence.
// * a = dt * A_h is formed here, so the wrapper does not materialise it.
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
// * P and N are padded in shared memory to 16 or 64 and to 16, 64 or 128
//   (zeros, which add nothing); a thread owns a 4-row slice of the (64, 64)
//   tiles and rows ty + 16 i, columns tx + 16 j of the state.  Rows of B
//   and C are padded by one float so the strided reads hit distinct banks.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;      // steps per chunk
constexpr int kThreads = 256;   // 16 x 16

struct Strides {
  long long x[3], dt[3], b[3], c[3], y[3];  // (batch, seq, head or group)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

}  // namespace

// x: (batch, seq, n_heads, p) and y like it, in `dtype` (0 = float32,
// 1 = bfloat16); dt: (batch, seq, n_heads) float32; A: (n_heads,) float32,
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
    err = dispatch<__nv_bfloat16>(x, dt, A, B, C, y, hT, batch, seq,
                                  n_heads, hpg, p, n, st, s);
  return (int)err;
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
