// RG-LRU linear recurrence h_t = exp(log_a_t) * h_{t-1} + b_t: the port
// of the Pallas kernel src/repro/kernels/rglru_scan.py :: rglru_scan
// (body `_kernel`), which the port's RG-LRU layer runs for every prefill.
//
// What it computes (the same as the Pallas kernel): log_a, b (B, S, R),
// each bf16 or fp32; h0 (B, R) fp32 or absent (zeros).  The state h is
// fp32; per step a = expf(float(log_a)), h = fmaf(a, h, float(b)), and
// y[t] = h rounded to b's type.  h_T (B, R) is written in fp32.  Any R:
// the ragged channel block is masked, nothing is padded.
//
// What bounds it on an H100: memory.  The recurrence is elementwise over
// the R channels, so there is no product to feed the tensor cores: each
// element of log_a and b is read once and each of y written once.  At the
// hybrid path's prefill (B 8, S 512, R 4096, fp32 log_a, b and y) that is
// 3 x 16.8M elements x 4 bytes = 201 MB, 60 us at 3.35 TB/s; the 2 flops
// and one exp per element are noise beside it.
//
// Design: one thread per (batch, channel), 128 threads per block along the
// channels, so a warp reads 32 neighbouring channels of one step: 128
// coalesced bytes per fp32 load.  The thread walks time with h in a
// register.  The time loop is cut into groups of kUnroll steps: the group's
// 2 x kUnroll loads are issued before the first of its steps needs one, so
// each thread keeps that many loads in flight while the dependent chain of
// fmas runs on data that has already arrived.  At the path shape the grid
// is 32 x 8 = 256 blocks, about two per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

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

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const TA* __restrict__ log_a, const TB* __restrict__ b,
                  const float* __restrict__ h0, TB* __restrict__ y,
                  float* __restrict__ h_last, int S, int R) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (r >= R) return;
  const long long base = static_cast<long long>(bi) * S * R + r;
  const TA* la = log_a + base;
  const TB* bb = b + base;
  TB* yy = y + base;
  float h = h0 != nullptr ? h0[static_cast<long long>(bi) * R + r] : 0.f;

  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float a[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = static_cast<long long>(t + u) * R;
      a[u] = to_f(la[off]);
      v[u] = to_f(bb[off]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = fmaf(expf(a[u]), h, v[u]);
      yy[static_cast<long long>(t + u) * R] = from_f<TB>(h);
    }
  }
  for (; t < S; ++t) {
    const long long off = static_cast<long long>(t) * R;
    h = fmaf(expf(to_f(la[off])), h, to_f(bb[off]));
    yy[off] = from_f<TB>(h);
  }
  h_last[static_cast<long long>(bi) * R + r] = h;
}

template <typename TA, typename TB>
cudaError_t launch(const void* log_a, const void* b, const float* h0, void* y, float* h_last,
                   int B, int S, int R, cudaStream_t s) {
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<TA, TB><<<grid, kThreads, 0, s>>>(
      static_cast<const TA*>(log_a), static_cast<const TB*>(b), h0, static_cast<TB*>(y),
      h_last, S, R);
  return cudaGetLastError();
}

}  // namespace

// log_a, b, y: (B, S, R) contiguous; log_a bf16 if a_bf16 else fp32, b and
// y bf16 if b_bf16 else fp32.  h0: (B, R) contiguous fp32, or null for a
// zero state.  h_last: (B, R) fp32.  Returns a cudaError_t.
extern "C" int rglru_scan_launch(const void* log_a, const void* b, const void* h0, void* y,
                                 void* h_last, int B, int S, int R, int a_bf16, int b_bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || R <= 0) return cudaSuccess;
  const float* h0f = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  if (a_bf16) {
    return b_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(log_a, b, h0f, y, hl, B, S, R, s)
                  : launch<__nv_bfloat16, float>(log_a, b, h0f, y, hl, B, S, R, s);
  }
  return b_bf16 ? launch<float, __nv_bfloat16>(log_a, b, h0f, y, hl, B, S, R, s)
                : launch<float, float>(log_a, b, h0f, y, hl, B, S, R, s);
}
