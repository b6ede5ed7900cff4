// Fused squared distance + running top-k: the port of the Pallas kernel
// src/repro/kernels/knn_topk.py :: knn_topk (body `_kernel`), which carries
// the paper's KNN_frag task.
//
// What it computes (the same as the Pallas kernel): for every test row x
// and training row y, d2 = (|x|^2 - 2 x.y) + |y|^2 in fp32, and per test
// row the k smallest d2 in ascending order with the labels of their
// training rows.  Equal distances keep the lower training index first.
//
// What bounds it on an H100: arithmetic.  One call does 2*m*n*d flops on
// m*d + n*d floats, e.g. m=12,500, n=125,000, d=50: 1.6e11 flops against
// 28 MB, ~2.3 ms at the 67 TFLOP/s fp32 (non-tensor-core) peak against
// ~0.01 ms of memory traffic.  So the design keeps the FMA pipes fed:
//
// * One block of 128 threads owns 256 test rows, staged once in shared
//   memory; each thread owns two of them (rows tid and tid + 128) and
//   accumulates their dot products with 16 training rows at once: per
//   float4 of the depth, 2 loads of x and 16 broadcast loads of y feed
//   128 FMAs in 32 independent chains.
// * Training rows stream through a double-buffered shared tile of 64
//   rows: `cp.async` copies the next tile (and its labels and |y|^2,
//   from a pre-pass) while the current one is consumed, so global
//   latency hides behind arithmetic.  The copy walks each thread's
//   (row, column) without integer divisions.
// * Each test row keeps a sorted register top-K (K = 8, 16 or 32, the
//   smallest >= k).  A candidate enters with a strict `<`, so an equal
//   distance from a later training row never displaces an earlier one —
//   the Pallas kernel's tie rule.
// * The training rows are cut into `splits` contiguous chunks (grid.y),
//   chosen by the wrapper so that the grid fills the card in one wave;
//   each chunk leaves a top-K per test row in scratch, and a second small
//   kernel merges the chunks in chunk order with the same strict
//   insertion.  No atomics: the result is bitwise reproducible.
// The cross term uses CUDA cores, not tensor cores (TF32 would not keep
// fp32's distances); a wgmma version is later work.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;                  // threads per block
constexpr int kRowsPerThread = 2;              // test rows per thread
constexpr int kBlockRows = kThreads * kRowsPerThread;
constexpr int kGroup = 16;  // training rows a thread accumulates at once
constexpr int kTile = 64;   // training rows per shared tile (x2 buffers)
constexpr float kBig = 1e30f;  // the Pallas kernel's "no candidate" value

// Insert (dv, lv) into the ascending list bd[0..K): it goes before the
// first entry it is strictly smaller than, the last entry falls off.
// Fully unrolled so the lists stay in registers.
template <int K>
__device__ __forceinline__ void insert_sorted(float (&bd)[K], int (&bl)[K],
                                              float dv, int lv) {
#pragma unroll
  for (int i = K - 1; i > 0; --i) {
    if (dv < bd[i - 1]) {
      bd[i] = bd[i - 1];
      bl[i] = bl[i - 1];
    } else if (dv < bd[i]) {
      bd[i] = dv;
      bl[i] = lv;
    }
  }
  if (dv < bd[0]) {
    bd[0] = dv;
    bl[0] = lv;
  }
}

// Where this thread's elements land in a shared tile of row stride ld:
// element g = tid + i * kThreads of a row-major (rows, d) block sits at
// (g / d, g % d); the walk advances that pair without dividing.
struct Walk {
  int r0, c0, step_r, step_c;
};

__device__ __forceinline__ void copy_rows_async(float* tile, const float* src,
                                                int total, int d, int ld,
                                                Walk w) {
  int r = w.r0, c = w.c0;
  for (int g = threadIdx.x; g < total; g += kThreads) {
    __pipeline_memcpy_async(tile + r * ld + c, src + g, sizeof(float));
    r += w.step_r;
    c += w.step_c;
    if (c >= d) {
      c -= d;
      ++r;
    }
  }
}

// |y|^2 of every training row, summed in column order like row_sqnorm.
__global__ void row_sqnorms(const float* __restrict__ x, int n, int d,
                            float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* row = x + static_cast<long>(i) * d;
  float s = 0.f;
  for (int j = 0; j < d; ++j) s = fmaf(row[j], row[j], s);
  out[i] = s;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_chunk_topk(const float* __restrict__ test, const float* __restrict__ train,
               const int* __restrict__ labels, const float* __restrict__ train_sq,
               int m, int n, int d, int ld, int chunk,
               float* __restrict__ part_d, int* __restrict__ part_l) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // kBlockRows x ld
  float* ys = xs + kBlockRows * ld;             // 2 x kTile x ld
  float* ysq = ys + 2 * kTile * ld;             // 2 x kTile
  int* yl = reinterpret_cast<int*>(ysq + 2 * kTile);  // 2 x kTile

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBlockRows;
  const int n0 = blockIdx.y * chunk;
  const int n1 = min(n, n0 + chunk);
  const int ld4 = ld / 4;
  const Walk walk{tid / d, tid % d, kThreads / d, kThreads % d};

  repro::zero_shared(xs, (kBlockRows + 2 * kTile) * ld);
  __syncthreads();
  copy_rows_async(xs, test + static_cast<long>(row0) * d,
                  min(kBlockRows, m - row0) * d, d, ld, walk);
  __pipeline_commit();

  auto stage = [&](int buf, int t0) {
    const int rows = min(kTile, n1 - t0);
    copy_rows_async(ys + buf * kTile * ld, train + static_cast<long>(t0) * d,
                    rows * d, d, ld, walk);
    if (tid < rows) {
      __pipeline_memcpy_async(ysq + buf * kTile + tid, train_sq + t0 + tid, sizeof(float));
      __pipeline_memcpy_async(yl + buf * kTile + tid, labels + t0 + tid, sizeof(int));
    }
  };
  if (n0 < n1) stage(0, n0);
  __pipeline_commit();
  __pipeline_wait_prior(1);  // the test rows have landed
  __syncthreads();

  const float4* xr[kRowsPerThread];
  float xsq[kRowsPerThread];
  float bd[kRowsPerThread][K];
  int bl[kRowsPerThread][K];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    xr[i] = reinterpret_cast<const float4*>(xs + (tid + i * kThreads) * ld);
    xsq[i] = repro::row_sqnorm(xr[i], ld4);
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[i][s] = kBig;
      bl[i][s] = 0;
    }
  }

  int buf = 0;
  for (int t0 = n0; t0 < n1; t0 += kTile, buf ^= 1) {
    if (t0 + kTile < n1) stage(buf ^ 1, t0 + kTile);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this tile has landed
    __syncthreads();
    const int rows = min(kTile, n1 - t0);
    const float* yt = ys + buf * kTile * ld;
    const float* qt = ysq + buf * kTile;
    const int* lt = yl + buf * kTile;

    for (int g = 0; g < rows; g += kGroup) {
      float acc[kRowsPerThread][kGroup];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int t = 0; t < kGroup; ++t) acc[i][t] = 0.f;
      for (int j4 = 0; j4 < ld4; ++j4) {
        float4 xv[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) xv[i] = xr[i][j4];
#pragma unroll
        for (int t = 0; t < kGroup; ++t) {
          const float4 yv = reinterpret_cast<const float4*>(yt + (g + t) * ld)[j4];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            acc[i][t] = fmaf(xv[i].x, yv.x, acc[i][t]);
            acc[i][t] = fmaf(xv[i].y, yv.y, acc[i][t]);
            acc[i][t] = fmaf(xv[i].z, yv.z, acc[i][t]);
            acc[i][t] = fmaf(xv[i].w, yv.w, acc[i][t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        const int r = g + t;
        if (r < rows) {
          const float q = qt[r];
          const int lab = lt[r];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            const float dist = (xsq[i] - 2.f * acc[i][t]) + q;
            if (dist < bd[i][K - 1]) insert_sorted<K>(bd[i], bl[i], dist, lab);
          }
        }
      }
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + tid + i * kThreads;
    if (row < m) {
      const long base = (static_cast<long>(blockIdx.y) * m + row) * K;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        part_d[base + s] = bd[i][s];
        part_l[base + s] = bl[i][s];
      }
    }
  }
}

// Merge the per-chunk lists in chunk order (lower training indices first),
// keeping the first k of the merged ascending list.
template <int K>
__global__ void knn_merge_chunks(const float* __restrict__ part_d,
                                 const int* __restrict__ part_l, int m,
                                 int splits, int k, float* __restrict__ out_d,
                                 int* __restrict__ out_l) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  float bd[K];
  int bl[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    bd[i] = kBig;
    bl[i] = 0;
  }
  for (int s = 0; s < splits; ++s) {
    const long base = (static_cast<long>(s) * m + row) * K;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float v = part_d[base + i];
      if (v < bd[K - 1]) insert_sorted<K>(bd, bl, v, part_l[base + i]);
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < k) {
      out_d[static_cast<long>(row) * k + i] = bd[i];
      out_l[static_cast<long>(row) * k + i] = bl[i];
    }
  }
}

template <int K>
cudaError_t launch(const float* test, const float* train, const int* labels,
                   int m, int n, int d, int k, int chunk, int splits,
                   float* train_sq, float* part_d, int* part_l, float* out_d,
                   int* out_l, cudaStream_t stream) {
  const int ld = repro::padded_ld(d);
  const size_t smem = static_cast<size_t>(kBlockRows + 2 * kTile) * ld * sizeof(float) +
                      2 * kTile * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      knn_chunk_topk<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  row_sqnorms<<<(n + 255) / 256, 256, 0, stream>>>(train, n, d, train_sq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kBlockRows - 1) / kBlockRows, splits);
  knn_chunk_topk<K><<<grid, kThreads, smem, stream>>>(
      test, train, labels, train_sq, m, n, d, ld, chunk, part_d, part_l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_merge_chunks<K><<<(m + 127) / 128, 128, 0, stream>>>(
      part_d, part_l, m, splits, k, out_d, out_l);
  return cudaGetLastError();
}

}  // namespace

// kb is the register list length (8, 16 or 32, >= k); train_sq holds n
// floats of scratch, part_d / part_l splits x m x kb.  Returns a
// cudaError_t.
extern "C" int knn_topk_launch(const float* test, const float* train,
                               const int* labels, int m, int n, int d, int k,
                               int kb, int chunk, int splits, float* train_sq,
                               float* part_d, int* part_l, float* out_d,
                               int* out_l, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kb) {
    case 8:
      return launch<8>(test, train, labels, m, n, d, k, chunk, splits, train_sq,
                       part_d, part_l, out_d, out_l, s);
    case 16:
      return launch<16>(test, train, labels, m, n, d, k, chunk, splits, train_sq,
                        part_d, part_l, out_d, out_l, s);
    case 32:
      return launch<32>(test, train, labels, m, n, d, k, chunk, splits, train_sq,
                        part_d, part_l, out_d, out_l, s);
    default:
      return cudaErrorInvalidValue;
  }
}
