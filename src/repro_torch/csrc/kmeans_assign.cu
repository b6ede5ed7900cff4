// Fused K-means assignment + per-cluster partial sums: the port of the
// Pallas kernel src/repro/kernels/kmeans_assign.py :: kmeans_assign (body
// `_kernel`), which carries the paper's partial_sum task.
//
// What it computes (the same as the Pallas kernel): each point x goes to
// argmax_c (x.c - |c|^2 / 2) in fp32, the first index on ties; the outputs
// are the per-cluster sums of the assigned points (k, d), their counts
// (k,), and sse = sum over points of |x|^2 - 2 * best.
//
// What bounds it on an H100: memory.  One call reads n*d floats of points
// and does ~2*n*k*d flops, e.g. n=500,000, d=50, k=16: 100 MB (~0.03 ms
// at 3.35 TB/s) against 8e8 flops (~0.012 ms at 67 TFLOP/s).
//
// Design, deterministic by construction (no atomics, so a replayed task
// gives the same bits — lineage recovery depends on that):
//  * kernel 1, `grid` persistent blocks of 128 threads: the centroids and
//    |c|^2/2 are staged once in shared memory; the block walks tiles
//    blockIdx.x, blockIdx.x + grid, ... of 128 points.  Each tile is
//    loaded coalesced into shared memory, and one thread per point scores
//    4 centroids per pass (one float4 load of x reused 4 times) and keeps
//    the first strict maximum.  Then thread q of the block owns the
//    (cluster, dim) sums q, q + 128, ... and adds the tile's points
//    assigned to that cluster in point order; counts likewise per
//    cluster, and the tile's sse by a fixed-shape tree.  The running
//    per-block partials live in shared memory and are written once.
//  * kernel 2 adds the `grid` partials of each output in block order.
// The per-(cluster, dim) pass reads shared memory twice per point and
// output, which costs more than the assignment at these shapes; a
// one-hot tensor-core contraction (the Pallas kernel's second MXU matmul)
// is later work.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // threads per block = points per tile
constexpr int kGroup = 4;      // centroids a thread scores per pass

__global__ void __launch_bounds__(kThreads)
kmeans_block_partials(const float* __restrict__ x, const float* __restrict__ c,
                      int n, int k, int d, int ld,
                      float* __restrict__ part_sums, int* __restrict__ part_counts,
                      float* __restrict__ part_sse) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);  // k x ld centroids
  float* xs = cs + k * ld;                      // kThreads x ld points
  float* hc = xs + kThreads * ld;               // k: |c|^2 / 2
  float* sacc = hc + k;                         // k x d running sums
  float* red = sacc + k * d;                    // kThreads: sse per point
  int* asg = reinterpret_cast<int*>(red + kThreads);  // kThreads: cluster or -1
  int* cnt = asg + kThreads;                    // k running counts

  const int tid = threadIdx.x;
  const int kd = k * d;
  const int ld4 = ld / 4;

  repro::zero_shared(cs, (k + kThreads) * ld + k + kd);
  for (int i = tid; i < k; i += kThreads) cnt[i] = 0;
  __syncthreads();
  repro::stage_rows(cs, c, 0, k, d, ld);
  __syncthreads();
  for (int i = tid; i < k; i += kThreads) {
    hc[i] = 0.5f * repro::row_sqnorm(reinterpret_cast<const float4*>(cs + i * ld), ld4);
  }
  float sse = 0.f;  // this block's running sse (thread 0's copy counts)

  const int n_tiles = (n + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * kThreads;
    const int rows = min(kThreads, n - p0);
    __syncthreads();  // the previous tile is consumed (and hc is ready)
    repro::stage_rows(xs, x, p0, rows, d, ld);
    __syncthreads();

    const float4* xr = reinterpret_cast<const float4*>(xs + tid * ld);
    float best = -CUDART_INF_F;
    int arg = 0;
    for (int c0 = 0; c0 < k; c0 += kGroup) {
      float acc[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) acc[g] = 0.f;
      for (int j4 = 0; j4 < ld4; ++j4) {
        const float4 xv = xr[j4];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (c0 + g < k) {
            const float4 cv = reinterpret_cast<const float4*>(cs + (c0 + g) * ld)[j4];
            acc[g] = fmaf(xv.x, cv.x, acc[g]);
            acc[g] = fmaf(xv.y, cv.y, acc[g]);
            acc[g] = fmaf(xv.z, cv.z, acc[g]);
            acc[g] = fmaf(xv.w, cv.w, acc[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (c0 + g < k) {
          const float v = acc[g] - hc[c0 + g];
          if (v > best) {  // strict: the first index keeps a tie
            best = v;
            arg = c0 + g;
          }
        }
      }
    }
    const bool valid = tid < rows;
    asg[tid] = valid ? arg : -1;
    red[tid] = valid ? repro::row_sqnorm(xr, ld4) - 2.f * best : 0.f;
    __syncthreads();

    for (int q = tid; q < kd; q += kThreads) {
      const int cl = q / d;
      const int j = q - cl * d;
      float s = sacc[q];
      for (int p = 0; p < rows; ++p) {
        if (asg[p] == cl) s += xs[p * ld + j];
      }
      sacc[q] = s;
    }
    for (int cl = tid; cl < k; cl += kThreads) {
      int s = 0;
      for (int p = 0; p < rows; ++p) s += asg[p] == cl;
      cnt[cl] += s;
    }
    for (int half = kThreads / 2; half > 0; half /= 2) {
      if (tid < half) red[tid] += red[tid + half];
      __syncthreads();
    }
    if (tid == 0) sse += red[0];
  }
  __syncthreads();

  float* out_sums = part_sums + static_cast<long>(blockIdx.x) * kd;
  for (int q = tid; q < kd; q += kThreads) out_sums[q] = sacc[q];
  for (int cl = tid; cl < k; cl += kThreads) part_counts[static_cast<long>(blockIdx.x) * k + cl] = cnt[cl];
  if (tid == 0) part_sse[blockIdx.x] = sse;
}

// One thread per output element: sum the per-block partials in block order.
__global__ void kmeans_reduce_blocks(const float* __restrict__ part_sums,
                                     const int* __restrict__ part_counts,
                                     const float* __restrict__ part_sse,
                                     int blocks, int k, int d,
                                     float* __restrict__ sums,
                                     int* __restrict__ counts,
                                     float* __restrict__ sse) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int kd = k * d;
  if (q < kd) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += part_sums[static_cast<long>(b) * kd + q];
    sums[q] = s;
  } else if (q < kd + k) {
    const int cl = q - kd;
    int s = 0;
    for (int b = 0; b < blocks; ++b) s += part_counts[static_cast<long>(b) * k + cl];
    counts[cl] = s;
  } else if (q == kd + k) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += part_sse[b];
    *sse = s;
  }
}

}  // namespace

// `blocks` persistent blocks; part_* hold blocks x (k*d, k, 1) scratch.
// Returns a cudaError_t.
extern "C" int kmeans_assign_launch(const float* x, const float* c, int n,
                                    int k, int d, int blocks, float* part_sums,
                                    int* part_counts, float* part_sse,
                                    float* sums, int* counts, float* sse,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ld = repro::padded_ld(d);
  const size_t smem = (static_cast<size_t>(k + kThreads) * ld + k + k * d + kThreads) *
                          sizeof(float) +
                      static_cast<size_t>(kThreads + k) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      kmeans_block_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kmeans_block_partials<<<blocks, kThreads, smem, s>>>(
      x, c, n, k, d, ld, part_sums, part_counts, part_sse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int outputs = k * d + k + 1;
  kmeans_reduce_blocks<<<(outputs + 127) / 128, 128, 0, s>>>(
      part_sums, part_counts, part_sse, blocks, k, d, sums, counts, sse);
  return cudaGetLastError();
}
