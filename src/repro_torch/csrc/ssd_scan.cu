// Mamba-2 SSD scan from a zero state: the port of the Pallas kernel
// src/repro/kernels/ssd_scan.py :: ssd_scan (body `_kernel`), which the
// port's SSD layer runs for every prefill.
//
// What it computes: x (B, S, H, P), dt (B, S, H) after softplus, A (H,)
// negative, Bm and Cm (B, S, N), one group shared by the H heads.  Per
// (b, h) the (P, N) state starts at zero and, per step t,
//   state = state * exp(dt_t * A) + (x_t * dt_t) (outer) B_t,
//   y_t   = state . C_t,
// all in fp32 (x, B and C are read as bf16 or fp32).  That is the function
// the Pallas kernel computes by chunks.  Where this kernel departs from it,
// on purpose:
//   * y is written in fp32 (B, S, H, P) contiguous: the layer adds the
//     D * x skip term in fp32 before it rounds to the model's type, as the
//     JAX layer does; parity with the Pallas kernel is judged on y cast to
//     x's type;
//   * the final (B, H, P, N) fp32 state is written as well: the layer's
//     prefill needs it for the decode cache, and the Pallas kernel drops it;
//   * x, dt, Bm and Cm are read through the strides they come with (x is a
//     view into the conv output, a row stride of d_inner + 2N), so the
//     layer makes no copy;
//   * any S: the chunk length is the kernel's own choice, and the function
//     does not depend on it, so a ragged S needs no padding.
//
// What bounds it on an H100: at the mamba2 path's prefill (B 8, S 512,
// H 48, P 64, N 128, bf16 x, B and C) the chunked SSD at the layer's chunk
// 256 does 2(QN + QP)Q + 4QNP flops per (b, h, chunk), 25.8 GFLOP per call:
// 26 us at the 989 TFLOP/s bf16 tensor-core peak.  The kernel moves x, B,
// C and dt in (28 MB) and y and the state out (63 MB), 27 us at
// 3.35 TB/s.  This first version runs the recurrence step by step on the
// CUDA cores instead, 5 flops per state element and step, 8.1 GFLOP:
// 0.12 ms at the 67 TFLOP/s fp32 peak.  Tensor cores (the chunked form
// with mma/wgmma) are later work.
//
// Design: the chunk length is 1.  One block per (h, b) walks time, with
// the (P, N) state in registers: thread (p, g) of 4 * ceil8(P) threads
// owns row p and the NS = N/4 (rounded up to 8, 16 or 32) columns
// [g*NS, g*NS + NS) of it.  The four lanes of one row are neighbours in a
// warp, so the sum over N of y_t[p] is two shuffles.  The block stages
// kT = 32 steps of x (its head), dt, exp(dt*A), B and C in shared memory
// as fp32 (coalesced loads), walks them, keeps the 32 rows of y in shared
// memory and writes them back coalesced.  Each column group of B and C is
// padded by 4 floats in shared memory, so the four groups that one
// quarter-warp reads as float4s land on distinct banks.  C.B^T and the
// decay mask of the chunked form are not formed at all; B and C are
// re-read by each of the H heads of a batch row (from L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kG = 4;    // lanes sharing one row p of the state
constexpr int kT = 32;   // steps staged in shared memory per pass
constexpr int kMaxP = 128;
constexpr int kMaxThreads = kG * kMaxP;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Element strides: x (b, s, h), dt (b, s, h), Bm and Cm (b, s); the last
// axis of x, Bm and Cm is contiguous.
struct Strides {
  long long x[3], dt[3], bm[2], cm[2];
};

__host__ __device__ constexpr int ldn(int ns) { return kG * (ns + 4); }
__host__ __device__ constexpr int ceil8(int p) { return (p + 7) / 8 * 8; }

template <int NS>
constexpr int smem_floats_for(int p_pad) {
  return kT * (2 * ldn(NS) + 2 * p_pad + 2);
}

template <typename T, int NS>
__global__ void __launch_bounds__(kMaxThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ bm,
                const T* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int N, Strides st) {
  constexpr int LDN = ldn(NS);
  const int p_pad = ceil8(P);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* bs = smem;                 // kT x LDN
  float* cs = bs + kT * LDN;        // kT x LDN
  float* xs = cs + kT * LDN;        // kT x p_pad
  float* ys = xs + kT * p_pad;      // kT x p_pad
  float* dts = ys + kT * p_pad;     // kT
  float* das = dts + kT;            // kT

  const int tid = threadIdx.x;
  const int p = tid >> 2;
  const int g = tid & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float a_h = A[h];
  const T* xb = x + b * st.x[0] + h * st.x[2];
  const float* db = dt + b * st.dt[0] + h * st.dt[2];
  const T* bb = bm + b * st.bm[0];
  const T* cb = cm + b * st.cm[0];
  float* yb = y + (static_cast<long long>(b) * S * H + h) * P;

  // padding columns of B/C and rows p >= P of x stay zero: their state
  // entries stay zero and add nothing to y
  for (int i = tid; i < kT * (2 * LDN + p_pad); i += blockDim.x) smem[i] = 0.f;

  float s[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int tc = min(kT, S - t0);
    __syncthreads();  // the previous pass is consumed (and the zeroing done)
    for (int e = tid; e < tc * N; e += blockDim.x) {
      const int tt = e / N, n = e - tt * N;
      const int at = tt * LDN + (n / NS) * (NS + 4) + n % NS;
      bs[at] = to_f(bb[(t0 + tt) * st.bm[1] + n]);
      cs[at] = to_f(cb[(t0 + tt) * st.cm[1] + n]);
    }
    for (int e = tid; e < tc * P; e += blockDim.x) {
      const int tt = e / P, pp = e - tt * P;
      xs[tt * p_pad + pp] = to_f(xb[(t0 + tt) * st.x[1] + pp]);
    }
    for (int tt = tid; tt < tc; tt += blockDim.x) {
      const float d = db[(t0 + tt) * st.dt[1]];
      dts[tt] = d;
      das[tt] = expf(d * a_h);
    }
    __syncthreads();

    for (int tt = 0; tt < tc; ++tt) {
      const float da = das[tt];
      const float xd = xs[tt * p_pad + p] * dts[tt];
      const float4* b4 = reinterpret_cast<const float4*>(bs + tt * LDN + g * (NS + 4));
      const float4* c4 = reinterpret_cast<const float4*>(cs + tt * LDN + g * (NS + 4));
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
        const float4 bv = b4[j];
        const float4 cv = c4[j];
        s[4 * j + 0] = fmaf(xd, bv.x, s[4 * j + 0] * da);
        s[4 * j + 1] = fmaf(xd, bv.y, s[4 * j + 1] * da);
        s[4 * j + 2] = fmaf(xd, bv.z, s[4 * j + 2] * da);
        s[4 * j + 3] = fmaf(xd, bv.w, s[4 * j + 3] * da);
        acc = fmaf(s[4 * j + 0], cv.x, acc);
        acc = fmaf(s[4 * j + 1], cv.y, acc);
        acc = fmaf(s[4 * j + 2], cv.z, acc);
        acc = fmaf(s[4 * j + 3], cv.w, acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (g == 0) ys[tt * p_pad + p] = acc;
    }
    __syncthreads();
    for (int e = tid; e < tc * P; e += blockDim.x) {
      const int tt = e / P, pp = e - tt * P;
      yb[static_cast<long long>(t0 + tt) * H * P + pp] = ys[tt * p_pad + pp];
    }
  }

  if (p < P) {
    float* so = state_out + ((static_cast<long long>(b) * H + h) * P + p) * N;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int n = g * NS + j;
      if (n < N) so[n] = s[j];
    }
  }
}

template <typename T, int NS>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* bm,
                   const void* cm, float* y, float* state, int B, int S, int H, int P, int N,
                   const Strides& st, cudaStream_t s) {
  const int p_pad = ceil8(P);
  const int smem = smem_floats_for<NS>(p_pad) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  ssd_scan_kernel<T, NS><<<grid, kG * p_pad, smem, s>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(bm), static_cast<const T*>(cm),
      y, state, S, H, P, N, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* x, const float* dt, const float* A, const void* bm,
                       const void* cm, float* y, float* state, int B, int S, int H, int P,
                       int N, const Strides& st, cudaStream_t s) {
  if (N <= kG * 8) return launch<T, 8>(x, dt, A, bm, cm, y, state, B, S, H, P, N, st, s);
  if (N <= kG * 16) return launch<T, 16>(x, dt, A, bm, cm, y, state, B, S, H, P, N, st, s);
  if (N <= kG * 32) return launch<T, 32>(x, dt, A, bm, cm, y, state, B, S, H, P, N, st, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (B, S, H, P), bm and cm: (B, S, N), each bf16 if bf16 else fp32, with
// a contiguous last axis; dt: (B, S, H) fp32; A: (H,) fp32 contiguous.
// strides: a host array of 10 element strides, x (b, s, h), dt (b, s, h),
// bm (b, s), cm (b, s).  y: (B, S, H, P) fp32 and state: (B, H, P, N) fp32,
// both contiguous.  1 <= P <= 128, 1 <= N <= 128.  Returns a cudaError_t.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* bm,
                               const void* cm, void* y, void* state, int B, int S, int H, int P,
                               int N, const long long* strides, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (P < 1 || P > kMaxP || N < 1 || N > kG * 32) return cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.dt[i] = strides[3 + i];
  }
  for (int i = 0; i < 2; ++i) {
    st.bm[i] = strides[6 + i];
    st.cm[i] = strides[8 + i];
  }
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  return bf16 ? dispatch_n<__nv_bfloat16>(x, dtf, Af, bm, cm, yf, sf, B, S, H, P, N, st, s)
              : dispatch_n<float>(x, dtf, Af, bm, cm, yf, sf, B, S, H, P, N, st, s);
}
