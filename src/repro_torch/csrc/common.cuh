// Shared helpers of the port's hand-written kernels (plain C interface,
// bound from Python with ctypes; see repro_torch/kernels/_build.py).
#pragma once

#include <cuda_runtime.h>

namespace repro {

// Row stride, in floats, of a (rows, d) tile staged in shared memory: d
// rounded up to a multiple of 4 (rows are read as float4), then kept an
// odd number of float4s.  With an odd float4 stride the 8 threads of one
// LDS.128 phase, each reading its own row, land on 8 distinct 4-bank
// groups: no bank conflicts.  The padding columns hold zeros, which leave
// every dot product unchanged.
__host__ __device__ inline int padded_ld(int d) {
  int ld = (d + 3) / 4 * 4;
  if ((ld / 4) % 2 == 0) ld += 4;
  return ld;
}

// Copy rows [r0, r0 + rows) of a row-major (*, d) matrix into a shared
// tile with row stride ld, reading global memory in one coalesced sweep.
// Columns d..ld-1 of the tile are not touched (they stay zero).
__device__ inline void stage_rows(float* __restrict__ tile,
                                  const float* __restrict__ src, long r0,
                                  int rows, int d, int ld) {
  const float* base = src + r0 * d;
  const int total = rows * d;
  for (int g = threadIdx.x; g < total; g += blockDim.x) {
    const int r = g / d;
    tile[r * ld + (g - r * d)] = base[g];
  }
}

// |row|^2 of one zero-padded shared row, read as float4s (conflict-free
// across threads reading their own rows, see padded_ld).
__device__ __forceinline__ float row_sqnorm(const float4* __restrict__ row, int ld4) {
  float s = 0.f;
  for (int j4 = 0; j4 < ld4; ++j4) {
    const float4 v = row[j4];
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
  return s;
}

// Zero a shared buffer of `count` floats.
__device__ inline void zero_shared(float* buf, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) buf[i] = 0.f;
}

}  // namespace repro
