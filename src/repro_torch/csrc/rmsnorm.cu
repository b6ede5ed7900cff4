// RMSNorm over the last dimension: the port of the Pallas kernel
// src/repro/kernels/rmsnorm.py :: rmsnorm (body `_kernel`), which every LM
// block runs four times (ln1, ln2 and the per-head q/k norms) and the final
// norm once.
//
// What it computes: y = x * (1 / sqrt(mean(x^2) + eps)) * float(scale), in
// fp32, written in x's type.  x is bf16 or fp32, scale bf16 or fp32.  The
// reciprocal is 1/sqrt (correctly rounded under nvcc's default -prec-div
// and -prec-sqrt), as in the JAX layer the model uses
// (repro/layers/norms.py); the Pallas kernel's rsqrt differs from it by an
// ulp or so.
//
// What bounds it on an H100: memory.  Each row is read twice (the second
// read of a row a warp has just read comes from L1/L2) and written once;
// the bound counts one read of x, one write of y and one read of scale,
// over 3.35 TB/s.  For 4096 rows x 1024 bf16: 16.8 MB, ~5 us.
//
// Design: one warp per row, eight rows per 256-thread block.  A lane
// reads 16 bytes at a time (8 bf16 or 4 fp32 values) where the row allows
// it, neighbouring lanes on neighbouring addresses; the warp sums the
// squares with shuffles, then makes a second pass that scales and writes.
// One design serves every width from the 64-wide q/k-norm rows to 6144.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as PyTorch's cast
}

// 16 bytes of T.
template <typename T>
struct alignas(16) Pack {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename TX, typename TS, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_rows(const TX* __restrict__ x, const TS* __restrict__ scale,
             TX* __restrict__ y, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + row * d;
  TX* yr = y + row * d;
  constexpr int N = Pack<TX>::N;

  float ss = 0.f;
  if (kVec) {
    const Pack<TX>* xp = reinterpret_cast<const Pack<TX>*>(xr);
    for (int i = lane; i < d / N; i += 32) {
      const Pack<TX> p = xp[i];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float f = to_f(p.v[e]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      const float f = to_f(xr[j]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = 1.f / sqrtf(ss / static_cast<float>(d) + eps);

  if (kVec) {
    const Pack<TX>* xp = reinterpret_cast<const Pack<TX>*>(xr);
    Pack<TX>* yp = reinterpret_cast<Pack<TX>*>(yr);
    for (int i = lane; i < d / N; i += 32) {
      const Pack<TX> p = xp[i];
      Pack<TX> out;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        out.v[e] = from_f<TX>((to_f(p.v[e]) * inv) * to_f(scale[i * N + e]));
      }
      yp[i] = out;
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      yr[j] = from_f<TX>((to_f(xr[j]) * inv) * to_f(scale[j]));
    }
  }
}

template <typename TX, typename TS>
cudaError_t launch(const void* x, const void* scale, void* y, long long rows, int d,
                   bool vec, float eps, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const TX* xt = static_cast<const TX*>(x);
  const TS* st = static_cast<const TS*>(scale);
  TX* yt = static_cast<TX*>(y);
  if (vec) {
    rmsnorm_rows<TX, TS, true><<<blocks, kWarps * 32, 0, s>>>(xt, st, yt, rows, d, eps);
  } else {
    rmsnorm_rows<TX, TS, false><<<blocks, kWarps * 32, 0, s>>>(xt, st, yt, rows, d, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: (rows, d) contiguous, bf16 if x_bf16 else fp32; scale: (d,), bf16
// if scale_bf16 else fp32.  vec: rows are 16-byte aligned and d fills
// whole 16-byte packs (the wrapper checks).  Returns a cudaError_t.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y, long long rows,
                              int d, int x_bf16, int scale_bf16, int vec, float eps,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  if (x_bf16) {
    return scale_bf16
        ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d, vec, eps, s)
        : launch<__nv_bfloat16, float>(x, scale, y, rows, d, vec, eps, s);
  }
  return scale_bf16 ? launch<float, __nv_bfloat16>(x, scale, y, rows, d, vec, eps, s)
                    : launch<float, float>(x, scale, y, rows, d, vec, eps, s);
}
