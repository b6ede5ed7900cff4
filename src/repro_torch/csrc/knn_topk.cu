// Fused squared distance + running top-k: the port of the Pallas kernel
// src/repro/kernels/knn_topk.py :: knn_topk (line 86, body `_kernel`),
// which carries the paper's KNN_frag task.
//
// What it computes (the same as the Pallas kernel): for every test row x
// and training row y, d2 = (|x|^2 - 2 x.y) + |y|^2 in fp32, and per test
// row the k smallest d2 in ascending order with the labels of their
// training rows.  Equal distances keep the lower training index first.
//
// What bounds it on an H100: arithmetic.  One call does 2*m*n*d flops of
// cross term on m*d + n*d floats, e.g. m 12,500, n 125,000, d 50: 1.6e11
// flops against 28 MB of bytes (8 us at 3.35 TB/s).  On the fp32 CUDA
// cores (67 TFLOP/s) that is 2.33 ms.  This kernel runs the cross term on
// the tensor cores in 3xTF32, three TF32 products per pair, whose least
// time is 3 * 2mnd / 495 TFLOP/s = 0.947 ms.
//
// Why 3xTF32.  A TF32 operand keeps 10 of fp32's 23 mantissa bits, so a
// single TF32 product is off by ~1e-3 relative: at d 50 a distance moves
// by ~0.03, far outside the rtol 1e-5 / atol 1e-3 it is held to.  Each
// value is split as hi = tf32(v) and lo = tf32(v - hi) (rounded to
// nearest, ties away, as `cvt.rna` rounds; v - hi is exact in fp32) and
// x.y is taken as x_lo y_hi + x_hi y_lo + x_hi y_hi with fp32
// accumulation; what it drops, x_lo y_lo, is ~2^-22 of |x||y|.  Integer
// values in [-3, 3] are exact in TF32 (lo = 0), so integer-valued inputs
// keep their exact distances.  tests/test_torch_kernels.py emulates both
// roundings on the CPU.
//
// Design:
//
// * One block of 128 threads (4 warps) owns 128 test rows, staged once in
//   shared memory as fp32; thread tid owns test row tid for the top-k, and
//   warp w computes the cross terms of its own 32 rows, so a warp only
//   ever waits for itself between the products and the top-k.
// * Training rows stream through a double-buffered shared tile of 32 rows:
//   `cp.async` copies the next tile (with its labels and |y|^2, from a
//   pre-pass) while the current one is consumed.  Rows sit at a stride of
//   d rounded up to 8, plus 4 floats, zero-padded: `ldmatrix` then reads
//   8 rows without bank conflicts.  32-row tiles keep a block at 65 KB at
//   d 50 (three per SM; 64-row tiles ran 8% slower at two per SM) and
//   under the 227 KB limit up to d 272.
// * Per 8-column step of the depth, each warp loads its A fragments (2 x
//   m16) and the B fragments of the tile's rows (4 x n8) with `ldmatrix`
//   (a b16 8 x 8 matrix is 8 rows of 4 floats, and lane l receives row
//   l / 4, float l % 4: the TF32 fragment layout), splits each value into
//   hi and lo in registers, and issues `mma.sync.m16n8k8` (TF32 in, fp32
//   accumulate) three times per 16 x 8 tile.  The split is done where a
//   fragment is loaded rather than stored split: hi/lo tiles of the test
//   rows or of the training tile cost a block per SM or an extra barrier
//   per tile, and both ran slower on the H100 (PERF.md).
// * The warp writes its 32 x 32 cross-term tile to shared memory in fp32,
//   transposed (a column per training row, stride 36: conflict-free both
//   ways).  Each thread then walks its row's columns in training-index
//   order: dist = (|x|^2 - 2 acc) + |y|^2, a test against the current
//   k-th distance, and a sorted insertion into its register top-K (K = 8,
//   16 or 32, the smallest >= k) with a strict `<`, so an equal distance
//   from a later training row never displaces an earlier one (the Pallas
//   kernel's tie rule) and no index is carried.  Columns go 8 at a time
//   behind one test of their least distance: after the first tiles almost
//   none enters, and the 8 then cost one branch.
// * The training rows are cut into `splits` contiguous chunks (grid.y),
//   chosen by the wrapper so that the grid fills the card in one wave of
//   resident blocks; each chunk leaves a top-K per test row in scratch, and a second
//   small kernel merges the chunks in chunk order with the same strict
//   insertion.  No atomics: the result is bitwise reproducible.
// Limits of this route: k <= 32 (the register lists) and d <= 272 (the
// block's shared memory grows with d).
//
// The wide route (knn_wide_launch) takes every other k <= n and d; the
// wrapper picks the route by shape before launch (knn_topk.route) and
// neither hands work to the other.  Speed is not its goal: it exists so
// that no k or d is refused.  Test rows go in groups of at most 8192 and
// training rows in chunks of at most 4096, and per group and chunk:
//  * knn_wide_dists writes the chunk's fp32 distances to global scratch,
//    each 64 x 64 block of them from repro::dot_tile (fp32 FMAs in depth
//    order over 16-deep shared slices: shared memory does not grow with
//    d), dist = (|x|^2 - 2 x.y) + |y|^2 as above.
//  * knn_wide_select, one block per test row, keeps the row's k best as
//    64-bit keys, (order-preserving bits of the distance) << 32 | training
//    index, sorted ascending in global memory.  Keys are unique and their
//    order is the tie rule (equal distances: lower index first), so the k
//    smallest keys are the answer whatever order they are found in.  The
//    block gathers the chunk's keys below the row's k-th key into shared
//    memory (32 KB), sorts them (bitonic), and merges them with the row's
//    list: an element's place is its index in its own list plus the count
//    of smaller keys in the other, found by binary search; places below k
//    are written to the other of two lists.
//  * knn_wide_finish decodes the final keys into distances and labels.
// Scratch: groups x 4096 floats of distances (at most 128 MiB) and two
// lists of m x k keys.  Integer-valued inputs give exact distances, so
// the result equals the plain version's bit for bit; two launches are
// bitwise equal (no float atomics; the gather's order is undone by the sort).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;                  // threads per block
constexpr int kBlockRows = kThreads;           // test rows per block, one per thread
constexpr int kWarpRows = 32;                  // test rows of one warp's products
constexpr int kTile = 32;   // training rows per shared tile (x2 buffers)
constexpr int kSlices = kTile / 8;             // n8 slices of a tile
constexpr int kLDC = kWarpRows + 4;  // column stride of a warp's cross-term tile
constexpr float kBig = 1e30f;  // the Pallas kernel's "no candidate" value

// Shared row stride, in floats, of a (rows, d) tile: d rounded up to 8
// (the depth of one TF32 step), plus 4 (an odd number of float4s, as
// repro::row_sqnorm wants, and 8 rows on distinct 4-bank groups).
__host__ __device__ inline int tile_ld(int d) { return (d + 7) / 8 * 8 + 4; }

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

// One block per SM as the floor of the bound, as in csrc/flash_attention.cu.
template <int K>
__global__ void __launch_bounds__(kThreads, 1)
knn_chunk_topk(const float* __restrict__ test, const float* __restrict__ train,
               const int* __restrict__ labels, const float* __restrict__ train_sq,
               int m, int n, int d, int ld, int chunk,
               float* __restrict__ part_d, int* __restrict__ part_l) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // kBlockRows x ld
  float* ys = xs + kBlockRows * ld;             // 2 x kTile x ld
  float* cross = ys + 2 * kTile * ld;           // 4 warps x kTile x kLDC
  float* ysq = cross + 4 * kTile * kLDC;        // 2 x kTile
  int* yl = reinterpret_cast<int*>(ysq + 2 * kTile);  // 2 x kTile

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // fragment row group, column in it
  const int row0 = blockIdx.x * kBlockRows;
  const int n0 = blockIdx.y * chunk;
  const int n1 = min(n, n0 + chunk);
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

  const float xsq = repro::row_sqnorm(reinterpret_cast<const float4*>(xs + tid * ld), ld / 4);
  float bd[K];
  int bl[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kBig;
    bl[s] = 0;
  }
  const int steps = (d + 7) / 8;
  // ldmatrix row addresses.  A, m-tile i: lane l feeds test row
  // 16 i + (l & 7) + 8 ((l >> 3) & 1) at column 4 (l >> 4), giving
  // a0..a3; B, slices j and j + 1: training row 8 j + (l & 7) + 8 (l >> 4)
  // at column 4 ((l >> 3) & 1), giving b0, b1 of slice j, then of j + 1
  const uint32_t xa = repro::smem_addr(
      xs + (warp * kWarpRows + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 4 * (lane >> 4));
  const int yoff = ((lane & 7) + 8 * (lane >> 4)) * ld + 4 * ((lane >> 3) & 1);
  float* cw = cross + warp * kTile * kLDC;                 // this warp's cross terms

  int buf = 0;
  for (int t0 = n0; t0 < n1; t0 += kTile, buf ^= 1) {
    if (t0 + kTile < n1) stage(buf ^ 1, t0 + kTile);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this tile has landed
    __syncthreads();
    const int rows = min(kTile, n1 - t0);
    const uint32_t ya = repro::smem_addr(ys + buf * kTile * ld + yoff);

    float acc[2][kSlices][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kSlices; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int s = 0; s < steps; ++s) {
      const uint32_t col = 8 * s * sizeof(float);
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t raw[4];
        repro::ldsm_x4(raw, xa + 16 * i * ld * sizeof(float) + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) repro::split_tf32(__uint_as_float(raw[e]), ah[i][e], al[i][e]);
      }
#pragma unroll
      for (int j = 0; j < kSlices; j += 2) {
        uint32_t raw[4], bh[4], bl[4];
        repro::ldsm_x4(raw, ya + 8 * j * ld * sizeof(float) + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) repro::split_tf32(__uint_as_float(raw[e]), bh[e], bl[e]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            repro::mma_tf32(acc[i][j + h], al[i], bh[2 * h], bh[2 * h + 1]);
            repro::mma_tf32(acc[i][j + h], ah[i], bl[2 * h], bl[2 * h + 1]);
            repro::mma_tf32(acc[i][j + h], ah[i], bh[2 * h], bh[2 * h + 1]);
          }
      }
    }
    // cross terms to shared, a column per training row: element e of
    // slice j of m-tile i is test row 16 i + g + 8 (e >> 1), training row
    // 8 j + 2 q + (e & 1)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kSlices; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cw[(8 * j + 2 * q + (e & 1)) * kLDC + 16 * i + g + 8 * (e >> 1)] = acc[i][j][e];
    __syncwarp();

    // the walk, 8 columns at a time: one test of their least distance
    // against the k-th skips the 8 unless one of them enters, and then
    // they go in order (fmaf(-2, a, x) rounds as x - 2 a does: 2 a is exact)
    const float* qt = ysq + buf * kTile;
    const int* lt = yl + buf * kTile;
    const float* ct = cw + lane;
    int c = 0;
    for (; c + 8 <= rows; c += 8) {
      float dist[8], least = kBig;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        dist[u] = fmaf(-2.f, ct[(c + u) * kLDC], xsq) + qt[c + u];
        least = fminf(least, dist[u]);
      }
      if (least < bd[K - 1]) {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (dist[u] < bd[K - 1]) insert_sorted<K>(bd, bl, dist[u], lt[c + u]);
      }
    }
    for (; c < rows; ++c) {
      const float dist = fmaf(-2.f, ct[c * kLDC], xsq) + qt[c];
      if (dist < bd[K - 1]) insert_sorted<K>(bd, bl, dist, lt[c]);
    }
    __syncthreads();  // the buffer is refilled two tiles on; the cross tile rewritten
  }

  const int row = row0 + tid;
  if (row < m) {
    const long base = (static_cast<long>(blockIdx.y) * m + row) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      part_d[base + s] = bd[s];
      part_l[base + s] = bl[s];
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

// ----------------------------------------------------------- wide route

constexpr int kSelCap = 4096;  // keys a select block holds: the largest chunk

// Float bits that order as the floats do (negative values reversed).
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_ordered_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Distances of test rows [0, rows) to training rows [0, cols), row-major
// with stride ld, 64 x 64 per block.
__global__ void __launch_bounds__(repro::kDotThreads)
knn_wide_dists(const float* __restrict__ test, int rows, const float* __restrict__ train,
               int cols, int d, float* __restrict__ dist, int ld) {
  __shared__ repro::DotTileSmem s;
  const int r0 = blockIdx.x * repro::kDotRows, c0 = blockIdx.y * repro::kDotRows;
  float acc[4][4];
  repro::dot_tile(test + static_cast<long>(r0) * d, min(repro::kDotRows, rows - r0),
                  train + static_cast<long>(c0) * d, min(repro::kDotRows, cols - c0), d, s, acc);
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + tr + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tc + 16 * j;
      if (r < rows && c < cols) {
        dist[static_cast<long>(r) * ld + c] =
            fmaf(-2.f, acc[i][j], s.asq[tr + 16 * i]) + s.bsq[tc + 16 * j];
      }
    }
  }
}

// How many of a[0..len) (ascending) are smaller than key.
__device__ __forceinline__ int count_below(const unsigned long long* a, int len,
                                           unsigned long long key) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One block per test row: merge the chunk's distances (training rows n0 +
// [0, cols)) into the row's k best keys, best_in -> best_out.  On the
// first chunk best_in is not read (every entry counts as ~0).
__global__ void __launch_bounds__(256)
knn_wide_select(const float* __restrict__ dist, int ld, int cols, int n0, int k, int first,
                const unsigned long long* __restrict__ best_in,
                unsigned long long* __restrict__ best_out) {
  __shared__ unsigned long long buf[kSelCap];
  __shared__ int count;
  const int t = threadIdx.x;
  const float* dr = dist + static_cast<long>(blockIdx.x) * ld;
  const unsigned long long* in = best_in + static_cast<long>(blockIdx.x) * k;
  unsigned long long* out = best_out + static_cast<long>(blockIdx.x) * k;
  const unsigned long long none = ~0ull;
  const unsigned long long kth = first ? none : in[k - 1];
  if (t == 0) count = 0;
  __syncthreads();
  for (int i = t; i < cols; i += blockDim.x) {
    const unsigned long long key =
        static_cast<unsigned long long>(ordered_bits(dr[i])) << 32 | static_cast<uint32_t>(n0 + i);
    if (key < kth) buf[atomicAdd(&count, 1)] = key;
  }
  __syncthreads();
  const int c = count;
  if (c == 0) {  // nothing enters: the list carries over
    for (int i = t; i < k; i += blockDim.x) out[i] = in[i];
    return;
  }
  int len = 1;
  while (len < c) len <<= 1;
  for (int i = c + t; i < len; i += blockDim.x) buf[i] = none;
  __syncthreads();
  for (int size = 2; size <= len; size <<= 1) {      // bitonic sort, ascending
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < len / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = buf[lo], b = buf[hi];
        if ((a > b) == ((lo & size) == 0)) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = t; i < k; i += blockDim.x) {
    const unsigned long long a = first ? none : in[i];
    const int at = i + count_below(buf, c, a);
    if (at < k) out[at] = a;
  }
  for (int j = t; j < c; j += blockDim.x) {
    const unsigned long long b = buf[j];
    const int at = j + (first ? 0 : count_below(in, k, b));
    if (at < k) out[at] = b;
  }
}

__global__ void knn_wide_finish(const unsigned long long* __restrict__ best, long total,
                                const int* __restrict__ labels, float* __restrict__ out_d,
                                int* __restrict__ out_l) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const unsigned long long key = best[i];
  out_d[i] = from_ordered_bits(static_cast<uint32_t>(key >> 32));
  out_l[i] = labels[static_cast<uint32_t>(key)];
}

template <int K>
cudaError_t launch(const float* test, const float* train, const int* labels,
                   int m, int n, int d, int k, int chunk, int splits,
                   float* train_sq, float* part_d, int* part_l, float* out_d,
                   int* out_l, cudaStream_t stream) {
  const int ld = tile_ld(d);
  const size_t smem = (static_cast<size_t>(kBlockRows + 2 * kTile) * ld + 4 * kTile * kLDC) *
                          sizeof(float) +
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

// The wide route: any 1 <= k <= n and d >= 1.  Test rows go in groups of
// `group` rows and training rows in chunks of `chunk` (<= 4096) rows;
// dist holds group x chunk floats of scratch, best_a / best_b m x k keys
// each.  Returns a cudaError_t.
extern "C" int knn_wide_launch(const float* test, const float* train, const int* labels,
                               int m, int n, int d, int k, int group, int chunk, float* dist,
                               unsigned long long* best_a, unsigned long long* best_b,
                               float* out_d, int* out_l, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || d < 1 || k < 1 || k > n || group < 1 || chunk < 1 ||
      chunk > kSelCap) {
    return cudaErrorInvalidValue;
  }
  constexpr int R = repro::kDotRows;
  int lists = 0;  // chunks merged so far in the group: chunk q writes best_a when q is even
  for (int g0 = 0; g0 < m; g0 += group) {
    const int rows = m - g0 < group ? m - g0 : group;
    lists = 0;
    for (int n0 = 0; n0 < n; n0 += chunk, ++lists) {
      const int cols = n - n0 < chunk ? n - n0 : chunk;
      knn_wide_dists<<<dim3((rows + R - 1) / R, (cols + R - 1) / R), repro::kDotThreads, 0, s>>>(
          test + static_cast<long>(g0) * d, rows, train + static_cast<long>(n0) * d, cols, d,
          dist, chunk);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      unsigned long long* in = (lists % 2 == 0 ? best_b : best_a) + static_cast<long>(g0) * k;
      unsigned long long* out = (lists % 2 == 0 ? best_a : best_b) + static_cast<long>(g0) * k;
      knn_wide_select<<<rows, 256, 0, s>>>(dist, chunk, cols, n0, k, n0 == 0, in, out);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  const long total = static_cast<long>(m) * k;
  knn_wide_finish<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      lists % 2 == 1 ? best_a : best_b, total, labels, out_d, out_l);
  return cudaGetLastError();
}
