// Causal grouped-query flash attention on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention): o = softmax(scale * q k^T + mask) v for
// q (B, H, Sq, D) and k, v (B, K, Sk, D), query head h reading kv head
// h / (H / K), with the online softmax (running max m, running sum l, f32
// accumulator acc) so the (Sq, Sk) logits never reach device memory.  Inputs
// are f32 or bf16; every product and sum is f32; the output is q's type.
//
// What bounds it on this card: operations.  The causal work is about
// 2 * B * H * Sq * Sk * D multiply-adds against (q + k + v + o) bytes read or
// written once, some hundreds of operations a byte at the serving shapes
// (S = 2048, D = 64), above the ~295 a byte at which the bf16 tensor cores
// (989 TFLOP/s) would bind before the memory (3.35 TB/s).  This first design
// runs on the f32 FMA units (67 TFLOP/s), and its shared-memory reads bound
// it before those: it is right first; the tensor-core version (mma / wgmma,
// TMA, warp specialisation) is later work.
//
// How the design answers that, and where it leaves the TPU kernel's blocking:
// * One block of 256 threads per (b * H + h, 64-row q tile).  The TPU kernel
//   carries m, l and acc in VMEM across its sequential kv grid axis; here
//   blocks run in parallel and in no order, so the kv loop is inside the
//   block and m, l and acc stay in registers for the whole tile.
// * The kv head is (b * H + h) / group, as the TPU kernel's index map reads
//   it: repeated KV is never formed.
// * Causality is aligned to the real ends (diag = Sk - Sq), so decode
//   (Sq = 1, long Sk) is right; the kv loop stops at the causal frontier of
//   the tile's last real q row and at Sk, which halves the causal work.
//   Tiles are taken longest first, so the long diagonal tiles do not trail.
// * The ragged edges are masked here: q rows past Sq load as zeros and are
//   not stored, k/v rows past Sk load as zeros and are masked, so the
//   wrapper pads and copies nothing.  q, k, v and o are addressed through
//   their (batch, head, seq) strides, so the model's (B, S, H, D) layout is
//   read and written in place without a transpose.
// * Each kv tile of 64 rows is staged through shared memory, converted to
//   f32 once.  A thread owns a 4 x 4 piece of the (64, 64) score tile (rows
//   ty + 16 i, columns tx + 16 j), so a row's max and sum are a shuffle over
//   the 16 lanes of a half-warp; the probabilities go through shared memory
//   into the P V product, where a thread owns rows ty + 16 i and columns
//   tx + 16 j of acc.  Rows of q and k are padded by one float so the
//   strided reads hit distinct banks.
// * Masked scores take NEG_INF = -1e30, as on the TPU, and their
//   probabilities are set to zero, so a row whose keys are all masked comes
//   out as zeros (l == 0 divides by 1), as the TPU kernel's emit does.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;       // q rows per block and kv rows per step
constexpr int kThreads = 256;   // 16 x 16
constexpr float kNegInf = -1e30f;

struct Strides {
  long long q[3], k[3], v[3], o[3];  // (batch, head, seq), in elements
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int D>
constexpr size_t smem_bytes() {
  // qs, ks: kTile x (D + 1); vs: kTile x D; ps: kTile x (kTile + 1)
  return sizeof(float) *
         (2 * kTile * (D + 1) + kTile * D + kTile * (kTile + 1));
}

// Load rows [row0, row0 + kTile) of one head into smem (f32, row pitch
// `pitch`), zeros past `rows`.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const T* __restrict__ src,
                                          long long seq_stride, int row0,
                                          int rows) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float val = 0.0f;
    if (row0 + r < rows) val = to_f32(src[(long long)(row0 + r) * seq_stride + c]);
    dst[r * pitch + c] = val;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int n_heads,
             int group, int sq, int sk, int causal, float scale,
             Strides st) {
  constexpr int QP = D + 1;      // pitch of qs and ks
  constexpr int PP = kTile + 1;  // pitch of ps
  constexpr int NC = D / 16;     // acc columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * QP;
  float* vs = ks + kTile * QP;
  float* ps = vs + kTile * D;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const int kvh = h / group;  // (b * H + h) / group = b * K + h / group
  const int q0 = qt * kTile;
  const int diag = sk - sq;

  const T* qp = q + b * st.q[0] + h * st.q[1];
  const T* kp = k + b * st.k[0] + kvh * st.k[1];
  const T* vp = v + b * st.v[0] + kvh * st.v[1];
  T* op = o + b * st.o[0] + h * st.o[1];

  load_tile<D>(qs, QP, qp, st.q[2], q0, sq);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;
  }

  int kv_end = sk;
  if (causal) {
    const int last_q = min(q0 + kTile - 1, sq - 1);
    kv_end = min(sk, last_q + diag + 1);
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    load_tile<D>(ks, QP, kp, st.k[2], kv0, sk);
    load_tile<D>(vs, D, vp, st.v[2], kv0, sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool keep[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kv0 + tx + 16 * j;
        keep[j] = kj < sk && (!causal || kj <= qi + diag);
        s[i][j] = keep[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? __expf(s[i][j] - m_new) : 0.0f;
        sum += p;
        ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // ks, vs and ps are refilled by the next step
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
    T* row = op + (long long)qi * st.o[2];
#pragma unroll
    for (int j = 0; j < NC; ++j) store(&row[tx + 16 * j], acc[i][j] * inv);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int n_heads, int group, int sq, int sk,
                   int causal, float scale, const Strides& st,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();  // above 48 KB for D >= 64
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kTile - 1) / kTile, batch * n_heads);
  flash_kernel<D, T><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, n_heads, group, sq, sk,
      causal, scale, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* o, int batch, int n_heads, int group, int sq,
                     int sk, int causal, float scale, const Strides& st,
                     cudaStream_t s) {
  switch (d) {
    case 16: return launch<16, T>(q, k, v, o, batch, n_heads, group, sq, sk, causal, scale, st, s);
    case 32: return launch<32, T>(q, k, v, o, batch, n_heads, group, sq, sk, causal, scale, st, s);
    case 64: return launch<64, T>(q, k, v, o, batch, n_heads, group, sq, sk, causal, scale, st, s);
    case 128: return launch<128, T>(q, k, v, o, batch, n_heads, group, sq, sk, causal, scale, st, s);
    case 256: return launch<256, T>(q, k, v, o, batch, n_heads, group, sq, sk, causal, scale, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (batch, n_heads, sq, d) and k, v: (batch, n_heads / group, sk, d),
// o like q, each addressed by the 12 strides in `strides` (batch, head, seq
// of q, k, v, o, in elements; the d axis is contiguous).  dtype: 0 = float32,
// 1 = bfloat16.  Returns the cudaGetLastError() code of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int n_heads, int group, int sq, int sk,
                                      int d, int causal, float scale,
                                      int dtype, const long long* strides,
                                      int device, void* stream) {
  if ((dtype != 0 && dtype != 1) || group <= 0 || n_heads % group != 0 ||
      batch <= 0 || sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    err = dispatch<float>(d, q, k, v, o, batch, n_heads, group, sq, sk,
                          causal, scale, st, s);
  else
    err = dispatch<__nv_bfloat16>(d, q, k, v, o, batch, n_heads, group, sq,
                                  sk, causal, scale, st, s);
  return (int)err;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
