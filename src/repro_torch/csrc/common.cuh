// Shared helpers of the port's hand-written kernels (plain C interface,
// bound from Python with ctypes; see repro_torch/kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

// ------------------------------------ copies and tensor-core fragments

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; zero-filled where !ok (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
// 4 bytes global -> shared; zero-filled where !ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8 x 8 b16 matrices from shared memory, one row address per lane
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c += a . b on one 16 x 8 tile, k 16: bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a . b on one 16 x 8 tile, k 8: TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> hi = their bf16 pair, lo = the bf16 pair of what hi misses
// (x - hi is exact in fp32); x0 in the low half, as the fragments want
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// v = hi + lo + (what neither keeps), hi and lo TF32, each rounded to
// nearest with ties away from zero, as `cvt.rna.tf32.f32` rounds a finite
// value: half of the 13 dropped bits is added to the magnitude.  The
// tensor core reads only the top 19 bits of a TF32 operand, so the low
// bits are cleared only where hi's value is needed (v - hi, exact in
// fp32).  Four integer and float operations per value, where `cvt.rna`
// compiles to seven with its Inf/NaN guard; the inputs are finite.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) + 0x1000u;
  lo = __float_as_uint(v - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

// ---------------------------------------------------- fp32 row helpers

// |row|^2 of one zero-padded shared row, read as float4s.
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

// ------------------------------------------ fp32 dot-product tiles, any d

constexpr int kDotRows = 64;      // rows of A and of B in one tile
constexpr int kDotDepth = 16;     // depth of one shared slice
constexpr int kDotThreads = 256;  // threads of a block that calls dot_tile

// One depth slice of each operand, transposed (stride 65: the stores of
// a slice meet at most two lanes per bank), and the rows' squared norms.
struct DotTileSmem {
  float a[kDotDepth][kDotRows + 1];
  float b[kDotDepth][kDotRows + 1];
  float asq[kDotRows];
  float bsq[kDotRows];
};

// The 64 x 64 dot products a_r . b_c of rows A[0..a_rows) and B[0..b_rows)
// (row-major, d floats each) over any depth d, by fp32 FMAs in depth
// order; shared memory holds one 16-deep slice of each, whatever d is.
// Thread t of the 256 owns rows t / 16 + 16 i and columns t % 16 + 16 j
// (i, j < 4) in acc; rows past a_rows / b_rows read as zero.  On return
// s.asq[r] = |a_r|^2 and s.bsq[c] = |b_c|^2 (fmaf in depth order), visible
// to every thread.  Every thread of the block must call it.
__device__ inline void dot_tile(const float* __restrict__ A, int a_rows,
                                const float* __restrict__ B, int b_rows, int d,
                                DotTileSmem& s, float (&acc)[4][4]) {
  const int t = threadIdx.x;
  const int tr = t >> 4, tc = t & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float sq = 0.f;  // |a_t|^2 (t < 64) or |b_{t-64}|^2 (t < 128)
  for (int j0 = 0; j0 < d; j0 += kDotDepth) {
    __syncthreads();  // the previous slice (or the caller's reads of asq/bsq) is done
#pragma unroll
    for (int q = 0; q < kDotRows * kDotDepth / kDotThreads; ++q) {
      const int e = t + kDotThreads * q;
      const int r = e >> 4, jj = e & 15;
      const bool in_d = j0 + jj < d;
      s.a[jj][r] = r < a_rows && in_d ? A[static_cast<long>(r) * d + j0 + jj] : 0.f;
      s.b[jj][r] = r < b_rows && in_d ? B[static_cast<long>(r) * d + j0 + jj] : 0.f;
    }
    __syncthreads();
    if (t < 2 * kDotRows) {
      const float* col = t < kDotRows ? &s.a[0][t] : &s.b[0][t - kDotRows];
#pragma unroll
      for (int jj = 0; jj < kDotDepth; ++jj) {
        const float v = col[jj * (kDotRows + 1)];
        sq = fmaf(v, v, sq);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kDotDepth; ++jj) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = s.a[jj][tr + 16 * i];
        b[i] = s.b[jj][tc + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();  // every read of the last slice and of the old norms is done
  if (t < kDotRows) {
    s.asq[t] = sq;
  } else if (t < 2 * kDotRows) {
    s.bsq[t - kDotRows] = sq;
  }
  __syncthreads();
}

}  // namespace repro
