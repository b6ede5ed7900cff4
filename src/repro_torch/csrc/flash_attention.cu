// GQA attention forward with an online softmax: the port of the Pallas
// kernel src/repro/kernels/flash_attention.py :: flash_attention (body
// `_kernel`), which the port's attention layer runs for every cache-free
// prefill.
//
// What it computes (the same as the Pallas kernel): q (B, H, Sq, d),
// k/v (B, K, Skv, d), H = K*G; query head h reads KV head h / G.  Scores
// are (q * 1/sqrt(d)) . k in fp32; key j is visible to query i when
// j < Skv, and j <= i if causal, and i - j < window if a window is given.
// Positions count from 0 in both q and k, also when Sq != Skv.  Masked
// scores are NEG_INF = -1e30, a finite number: a query row whose first
// streamed block is wholly masked gathers exp(0) terms there, and the
// first block with a visible key wipes them out through
// alpha = exp(m_old - m_new) = 0, exactly as in the Pallas kernel (with
// -inf the rescale would be exp(-inf + inf) = NaN).  The output is
// acc / max(l, 1e-30), in q's type.
//
// What bounds it on an H100: at the serve path's prefill (B 8, H 16,
// K 8, S 512, d 64, causal, bf16) the work is 4*B*H*Sq*Skv*d / 2 =
// 4.3 GFLOP over 25 MB of q, k, v and o: 4.3 us at the 989 TFLOP/s bf16
// tensor-core peak, 7.5 us at 3.35 TB/s, so bytes bound the card.  This
// first version does its products in fp32 on the CUDA cores (bf16
// products are exact in fp32), so its own ceiling is 67 TFLOP/s, ~64 us;
// tensor cores (mma/wgmma) are later work.
//
// Design: one 256-thread block per (q block of 64 rows, h, b).  The
// block stages its q rows (scaled, fp32) in shared memory once, then
// streams 64-row K/V blocks of KV head h / G through shared memory.
// Thread (ty, tx) of a 16 x 16 grid owns query rows 4*ty .. 4*ty+3 and
// key columns tx + 16*j (j < 4) of the 64 x 64 score tile, and output
// columns tx + 16*c (c < d/16) of those rows.  Row max and row sum run
// over the 16 threads of a row group with shuffles (they share a warp),
// so every thread holds the same running max m and denominator l of its
// rows.  P goes through shared memory for the P.V product.  Blocks of
// keys wholly above the diagonal (causal) or wholly before the window of
// the block's first query are skipped: their terms would be wiped out by
// a zero rescale, so skipping them gives the same result.  Padding of
// every shared row stride keeps the accesses free of bank conflicts.
//
// Head dims: one template per d in {16, 32, 64, 128, 256}.  The tiles stay
// 64 x 64 at every d; shared memory is 4 * (64 (d + 4) + 64 (d + 1) +
// 64 d + 64 * 68) bytes, 215,296 at d 256 (recurrentgemma-9b's MQA heads):
// under the 232,448-byte opt-in limit, one block per SM.  A thread then
// holds 4 x 16 fp32 accumulators; ptxas's register and spill report for
// every d is printed by chip_smoke.py's build phase (PERF.md records it).
// At recurrentgemma's prefill (B 8, H 16, K 1, S 512, d 256, causal,
// window 2048, bf16) the work is 17.2 GFLOP over 71 MB: 21 us of bytes at
// 3.35 TB/s, 17 us at the bf16 tensor-core peak, 0.26 ms at the fp32
// CUDA-core peak this version runs at.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;        // key rows per streamed block
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kLDP = kBK + 4;  // shared stride of the P tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Element strides of the batch, head and sequence axes (the last axis is
// contiguous).
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 4) + kBK * (D + 1) + kBK * D + kBQ * kLDP;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int H, int G, int Sq, int Skv, Strides st, float scale,
          int causal, int window) {
  constexpr int LDQ = D + 4;  // two row groups of a warp land 16 banks apart
  constexpr int LDK = D + 1;  // 16 key rows of one column on 16 banks
  constexpr int C = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // kBQ x LDQ
  float* ks = qs + kBQ * LDQ;   // kBK x LDK
  float* vs = ks + kBK * LDK;   // kBK x D
  float* ps = vs + kBK * D;     // kBQ x kLDP

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / G;
  const T* qp = q + b * st.q[0] + h * st.q[1];
  const T* kp = k + b * st.k[0] + kh * st.k[1];
  const T* vp = v + b * st.v[0] + kh * st.v[1];
  T* op = o + b * st.o[0] + h * st.o[1];

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int pos = q0 + r;
    qs[r * LDQ + c] = pos < Sq ? to_f(qp[pos * st.q[2] + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = kv_begin / kBK * kBK; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // q is staged; the previous K/V/P tiles are consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int pos = k0 + r;
      const bool ok = pos < Skv;  // the ragged tail reads as zeros
      ks[r * LDK + c] = ok ? to_f(kp[pos * st.k[2] + c]) : 0.f;
      vs[r * D + c] = ok ? to_f(vp[pos * st.v[2] + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * LDQ + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LDK + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * kLDP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kLDP + j];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float vv = vs[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos < Sq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < C; ++c) op[qpos * st.o[2] + tx + 16 * c] = from_f<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int K, int Sq, int Skv, const Strides& st, int causal, int window,
                   cudaStream_t s) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, H / K, Sq, Skv, st,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))),  // as the Pallas kernel's
      causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, void* o, int B,
                       int H, int K, int Sq, int Skv, const Strides& st, int causal,
                       int window, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, K, Sq, Skv, st, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, K, Sq, Skv, st, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, K, Sq, Skv, st, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, K, Sq, Skv, st, causal, window, s);
    case 256: return launch<T, 256>(q, k, v, o, B, H, K, Sq, Skv, st, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, H, Sq, d); k, v: (B, K, Skv, d); all bf16 if bf16 else fp32,
// each with a contiguous last axis and the element strides of its first
// three axes in `strides` (a host array of 12: q, k, v, o).  d is 16, 32,
// 64, 128 or 256 (the head dims of the configs and of their reduced
// versions); window <= 0 means none.  Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int K, int Sq, int Skv, int d,
                                      const long long* strides, int causal, int window,
                                      int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Sq <= 0) return cudaSuccess;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  return bf16 ? dispatch_d<__nv_bfloat16>(d, q, k, v, o, B, H, K, Sq, Skv, st, causal, window, s)
              : dispatch_d<float>(d, q, k, v, o, B, H, K, Sq, Skv, st, causal, window, s);
}
