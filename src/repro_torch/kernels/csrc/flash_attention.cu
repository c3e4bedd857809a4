// Causal grouped-query flash attention on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention): o = softmax(scale * q k^T + mask) v for
// q (B, H, Sq, D) and k, v (B, K, Sk, D), query head h reading kv head
// h / (H / K), with the online softmax (running max m, running sum l, f32
// accumulator acc) so the (Sq, Sk) logits never reach device memory.  Inputs
// are f32, bf16 or f16; every product and sum is f32; the output is q's type.
//
// What bounds it on this card: operations.  The causal work is about
// 2 * B * H * Sq * Sk * D multiply-adds against (q + k + v + o) bytes read or
// written once, some hundreds of operations a byte at the serving shapes
// (S = 2048, D = 64), above the ~295 a byte at which the bf16 tensor cores
// (989 TFLOP/s) bind before the memory (3.35 TB/s).
//
// Two paths, chosen by dtype and head dim:
// * bf16 with D in {16, 32, 64, 128, 256} (the models' compute type and
//   head dims): the tensor cores, in FlashAttention-2's shape.  One block
//   of 4 warps per (b * H + h, 64-row q tile), one warp per 16 q rows.  K
//   and V tiles arrive by 16-byte cp.async into a double-buffered ring in
//   shared memory (the next tile's copies fly while this one is computed),
//   read through the strides, so the model's (B, S, H, D) layout stays in
//   place.  S = Q K^T runs as m16n8k16 mma.sync in registers; the online
//   softmax stays in registers (row max and sum by quad shuffles, exp2 with
//   scale * log2 e folded into the scores); P is rounded to bf16 in
//   registers and reused as the A fragment of P V, with V through
//   ldmatrix.trans; the accumulator is f32.  Rows are padded to D + 8
//   elements so every ldmatrix is free of bank conflicts.  A warp skips the
//   kv tiles past its own causal frontier and a warp whose rows all lie past
//   Sq computes nothing.  Up to D = 128 the Q fragments are loaded once
//   into registers and kv tiles are 64 rows.  At D = 256 (gemma) O alone
//   is 128 floats a thread, so Q stays in shared memory and is read by
//   ldmatrix at each depth step, and kv tiles are 32 rows (S is 16 floats
//   a thread, and the ring's 101 KB lets two blocks share an SM).
// * f32 and f16 (no model of the repo computes in f16: untuned): the f32
//   FMA units.  256 threads per
//   (b * H + h, 64-row q tile); q, k and v are staged in shared memory as
//   f32, a thread owns a 4 x 4 piece of the (64, 64) score tile (rows
//   ty + 16 i, columns tx + 16 j), so a row's max and sum are a shuffle over
//   the 16 lanes of a half-warp; the probabilities go through shared memory
//   into the P V product.  Every product and sum is f32, which keeps the
//   f32 path's 2e-4 agreement.
//
// What both keep from the TPU kernel, and where they leave its blocking:
// * The TPU kernel carries m, l and acc in VMEM across its sequential kv
//   grid axis; here blocks run in parallel and in no order, so the kv loop
//   is inside the block and m, l and acc stay in registers for the whole
//   tile.
// * The kv head is (b * H + h) / group, as the TPU kernel's index map reads
//   it: repeated KV is never formed.
// * Causality is aligned to the real ends (diag = Sk - Sq), so decode
//   (Sq = 1, long Sk) is right; the kv loop stops at the causal frontier of
//   the tile's last real q row and at Sk, which halves the causal work.
//   Tiles are taken longest first, so the long diagonal tiles do not trail.
// * The ragged edges are masked here: q rows past Sq load as zeros and are
//   not stored, k/v rows past Sk load as zeros and are masked, so the
//   wrapper pads and copies nothing.
// * Masked scores take NEG_INF = -1e30, as on the TPU, and their
//   probabilities are set to zero, so a row whose keys are all masked comes
//   out as zeros (l == 0 divides by 1), as the TPU kernel's emit does.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kTile = 64;       // q rows per block and kv rows per step
constexpr int kThreads = 256;   // 16 x 16
constexpr float kNegInf = -1e30f;

struct Strides {
  long long q[3], k[3], v[3], o[3];  // (batch, head, seq), in elements
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
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

// -- the tensor-core path (bf16, D <= 256) -------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;        // q rows per block: one warp per 16 rows
constexpr int kThreads = 128;  // 4 warps

template <int D>
__host__ __device__ constexpr int pitch() {
  return D + 8;  // rows of 2 D + 16 bytes: ldmatrix conflict-free
}

// kv rows per step: at D = 256 the O accumulator takes 128 registers a
// thread, so S is kept to 16 (32 rows) and the ring to 101 KB
template <int D>
__host__ __device__ constexpr int kv_rows() {
  return D == 256 ? 32 : 64;
}

// Q as register fragments for the whole tile up to D = 128 (4 * KD
// registers); at D = 256 that would be 64 more beside O's 128, so Q is
// read from shared memory at each depth step instead
template <int D>
__host__ __device__ constexpr bool q_in_registers() {
  return D <= 128;
}

template <int D>
constexpr int smem_bytes() {  // q, then k and v double-buffered
  return (kBQ + 4 * kv_rows<D>()) * pitch<D>() * (int)sizeof(bf16);
}

// 2^x by the special-function unit (ex2.approx: 2 ulp, -inf -> +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     int n_heads, int group, int sq, int sk, int causal,
                     float scale_log2, Strides st) {
  constexpr int P = pitch<D>();
  constexpr int BKV = kv_rows<D>();
  constexpr int KD = D / 16;    // depth steps of Q K^T
  constexpr int ND = D / 8;     // column tiles of O
  constexpr int NS = BKV / 8;   // column tiles of S
  constexpr bool kQRegs = q_in_registers<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ * P;      // [2][BKV][P]
  bf16* vs = ks + 2 * BKV * P;  // [2][BKV][P]

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const int kvh = h / group;  // (b * H + h) / group = b * K + h / group
  const int q0 = qt * kBQ;
  const int diag = sk - sq;

  const bf16* qp = q + b * st.q[0] + h * st.q[1];
  const bf16* kp = k + b * st.k[0] + kvh * st.k[1];
  const bf16* vp = v + b * st.v[0] + kvh * st.v[1];
  bf16* op = o + b * st.o[0] + h * st.o[1];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // rows [row0, row0 + n) of one head into shared memory by 16-byte
  // copies; rows at or past `rows` are zero-filled, not read
  auto load = [&](bf16* dst, const bf16* src, long long seq_stride,
                  int row0, int rows, int n) {
    for (int i = tid; i < n * (D / 8); i += kThreads) {
      const int r = i / (D / 8), c = i % (D / 8) * 8;
      const bool in = row0 + r < rows;
      mma::cp_async_16(mma::smem_addr(dst + r * P + c),
                       in ? src + (long long)(row0 + r) * seq_stride + c : src,
                       in ? 16 : 0);
    }
  };

  int kv_end = sk;
  if (causal) kv_end = min(sk, min(q0 + kBQ - 1, sq - 1) + diag + 1);
  const int n_kv = (kv_end + BKV - 1) / BKV;

  load(qs, qp, st.q[2], q0, sq, kBQ);
  load(ks, kp, st.k[2], 0, sk, BKV);
  load(vs, vp, st.v[2], 0, sk, BKV);
  mma::cp_async_commit();

  const int wq0 = q0 + warp * 16;  // this warp's first q row
  // the A fragment of this warp's 16 q rows at depth step kd
  auto q_frag = [&](int kd) {
    return mma::smem_addr(qs + (warp * 16 + lane % 16) * P + kd * 16 +
                          lane / 16 * 8);
  };
  const bool warp_active = wq0 < sq;
  const int w_last = min(wq0 + 15, sq - 1);
  uint32_t qf[kQRegs ? KD : 1][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g and g + 8

  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * BKV;
    if (j + 1 < n_kv) {  // the next tile into the other buffer
      load(ks + ((j + 1) & 1) * BKV * P, kp, st.k[2], kv0 + BKV, sk, BKV);
      load(vs + ((j + 1) & 1) * BKV * P, vp, st.v[2], kv0 + BKV, sk, BKV);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // this tile (and q) have landed
    __syncthreads();
    if constexpr (kQRegs) {
      if (j == 0 && warp_active) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          mma::ldmatrix_x4(qf[kd], q_frag(kd));
      }
    }
    if (warp_active && !(causal && kv0 > w_last + diag)) {
      const bf16* kb = ks + (j & 1) * BKV * P;
      const bf16* vb = vs + (j & 1) * BKV * P;
      float s[NS][4];
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t qa[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int c = 0; c < 4; ++c) qa[c] = qf[kd][c];
        } else {
          mma::ldmatrix_x4(qa, q_frag(kd));
        }
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {  // kv columns np*16 .. + 15
          uint32_t r[4];
          mma::ldmatrix_x4(r, mma::smem_addr(kb + (np * 16 + lane % 8 +
                                                   lane / 16 * 8) * P +
                                             kd * 16 + (lane / 8) % 2 * 8));
          mma::mma_16816(s[2 * np], qa, r[0], r[1]);
          mma::mma_16816(s[2 * np + 1], qa, r[2], r[3]);
        }
      }
      // scale; mask only a tile that crosses Sk or this warp's causal
      // diagonal; row max over the quad (c / 2 picks row g or g + 8)
      const bool edge = kv0 + BKV > sk ||
                        (causal && kv0 + BKV - 1 > wq0 + diag);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[nt][c] *= scale_log2;
          if (edge) {
            const int qi = wq0 + g + c / 2 * 8;
            const int kj = kv0 + nt * 8 + 2 * t + c % 2;
            if (kj >= sk || (causal && kj > qi + diag)) s[nt][c] = kNegInf;
          }
          mx[c / 2] = fmaxf(mx[c / 2], s[nt][c]);
        }
      // a row with no key kept so far keeps m = NEG_INF; subtracting 0
      // instead sends its masked scores' exp2 to exactly 0
      float alpha[2], base[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        base[i] = m_new == kNegInf ? 0.f : m_new;
        alpha[i] = exp2_approx(m[i] - base[i]);
        m[i] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = exp2_approx(s[nt][c] - base[c / 2]);
          s[nt][c] = p;
          sum[c / 2] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = alpha[i] * l[i] + sum[i];
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        acc[nd][0] *= alpha[0];
        acc[nd][1] *= alpha[0];
        acc[nd][2] *= alpha[1];
        acc[nd][3] *= alpha[1];
      }
      // O += P V: P's accumulator layout is the A fragment of kv depth
      // steps of 16 (column tiles 2 kk and 2 kk + 1), rounded to bf16
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        const uint32_t a[4] = {
            mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t r[4];
          mma::ldmatrix_x4_trans(
              r, mma::smem_addr(vb + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) *
                                         P +
                                np * 16 + lane / 16 * 8));
          mma::mma_16816(acc[2 * np], a, r[0], r[1]);
          mma::mma_16816(acc[2 * np + 1], a, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled by the next step's copies
  }
  if (!warp_active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = wq0 + g + half * 8;
    if (qi >= sq) continue;
    const float inv = 1.0f / (l[half] == 0.0f ? 1.0f : l[half]);
    bf16* row = op + (long long)qi * st.o[2];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(row + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nd][2 * half] * inv,
                                acc[nd][2 * half + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int n_heads, int group, int sq, int sk,
                   int causal, float scale, const Strides& st,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();  // above 48 KB for D >= 128
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * n_heads);
  flash_mma_kernel<D><<<grid, kThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, n_heads,
      group, sq, sk, causal, scale * 1.4426950408889634f, st);
  return cudaGetLastError();
}

}  // namespace tc

// -- the FMA path (f32 and f16) ---------------------------------------------------

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
cudaError_t dispatch_fma(int d, const void* q, const void* k, const void* v,
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

// The tensor-core path copies 16-byte rows: every base 16-byte aligned and
// every stride a multiple of 8 elements (an axis of extent 1 is never
// stepped, so its stride does not matter).
bool aligned_rows(const void* const (&ptrs)[4], const Strides& st,
                  int batch, int n_heads, int n_kv, int sq, int sk) {
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16) return false;
  const long long* all[4] = {st.q, st.k, st.v, st.o};
  for (int t = 0; t < 4; ++t) {
    const int extent[3] = {batch, t == 1 || t == 2 ? n_kv : n_heads,
                           t == 1 || t == 2 ? sk : sq};
    for (int i = 0; i < 3; ++i)
      if (extent[i] > 1 && all[t][i] % 8) return false;
  }
  return true;
}

// The one owner of the rule: bf16 at these head dims runs on the tensor
// cores, everything else on the f32 FMA units.
bool tensor_cores(int dtype, int d) {
  return dtype == 1 &&
         (d == 16 || d == 32 || d == 64 || d == 128 || d == 256);
}

// Returned, with nothing launched, when the tensor-core path is given rows
// that are not 16-byte aligned (negative: no cudaError_t has this value).
constexpr int kUnalignedRows = -1;

int dispatch_bf16(int d, const void* q, const void* k, const void* v,
                  void* o, int batch, int n_heads, int group, int sq, int sk,
                  int causal, float scale, const Strides& st,
                  cudaStream_t s) {
  if (!tensor_cores(1, d)) return cudaErrorInvalidValue;
  const void* const ptrs[4] = {q, k, v, o};
  if (!aligned_rows(ptrs, st, batch, n_heads, n_heads / group, sq, sk))
    return kUnalignedRows;
  switch (d) {
    case 16: return tc::launch<16>(q, k, v, o, batch, n_heads, group, sq, sk, causal, scale, st, s);
    case 32: return tc::launch<32>(q, k, v, o, batch, n_heads, group, sq, sk, causal, scale, st, s);
    case 64: return tc::launch<64>(q, k, v, o, batch, n_heads, group, sq, sk, causal, scale, st, s);
    case 128: return tc::launch<128>(q, k, v, o, batch, n_heads, group, sq, sk, causal, scale, st, s);
    case 256: return tc::launch<256>(q, k, v, o, batch, n_heads, group, sq, sk, causal, scale, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (batch, n_heads, sq, d) and k, v: (batch, n_heads / group, sk, d),
// o like q, each addressed by the 12 strides in `strides` (batch, head, seq
// of q, k, v, o, in elements; the d axis is contiguous).  dtype: 0 = float32,
// 1 = bfloat16, 2 = float16; bf16 on the tensor cores
// (flash_attention_tensor_cores)
// needs 16-byte aligned rows (else kUnalignedRows, nothing launched).
// Returns the cudaGetLastError() code of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int n_heads, int group, int sq, int sk,
                                      int d, int causal, float scale,
                                      int dtype, const long long* strides,
                                      int device, void* stream) {
  if (dtype < 0 || dtype > 2 || group <= 0 || n_heads % group != 0 ||
      batch <= 0 || sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch_fma<float>(d, q, k, v, o, batch, n_heads, group, sq,
                                    sk, causal, scale, st, s);
  if (dtype == 2)
    return (int)dispatch_fma<__half>(d, q, k, v, o, batch, n_heads, group,
                                     sq, sk, causal, scale, st, s);
  return dispatch_bf16(d, q, k, v, o, batch, n_heads, group, sq, sk, causal,
                       scale, st, s);
}

// 1 when a call of this dtype (as in flash_attention_launch) and head dim
// runs on the tensor cores, else 0 (the FMA kernel).
extern "C" int flash_attention_tensor_cores(int dtype, int d) {
  return tensor_cores(dtype, d);
}

// The code flash_attention_launch returns for rows it cannot copy.
extern "C" int flash_attention_unaligned_rows() { return kUnalignedRows; }

extern "C" const char* flash_attention_error_string(int err) {
  return err == kUnalignedRows
             ? "the bf16 tensor-core kernel copies 16-byte rows: each of q, "
               "k, v, o must be 16-byte aligned with its batch, head and seq "
               "strides multiples of 8 elements"
             : cudaGetErrorString((cudaError_t)err);
}
