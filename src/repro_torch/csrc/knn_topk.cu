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
// accumulation, each 8-deep step's three products in a fresh accumulator
// added to the running one in fp32 (repro::mma_3xtf32: the tensor cores
// cut their adds toward zero); what it drops, x_lo y_lo, is ~2^-22 of
// |x||y|.  Integer values in [-3, 3] are exact in TF32 (lo = 0), so
// integer-valued inputs keep their exact distances.  tests/test_torch_kernels.py emulates both
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
// block's shared memory grows with d).  The wrapper gives it d <= 64
// only: past 64 the row stride grows from 68 to 76 floats, an SM holds one
// block fewer, and the wide route is faster at every depth (PERF.md).
//
// The wide route (knn_wide_launch) takes every other k <= n and d; the
// wrapper picks the route by shape before launch (knn_topk.route) and
// neither hands work to the other.  It keeps the narrow route's fusion —
// no distance matrix in device memory, one wave of resident blocks over
// `splits` chunks of training rows, then a merge of the splits in split
// order — and changes what grows with d and k:
//  * depth: a block of 8 warps multiplies its 128 test rows by tiles of
//    128 training rows in 3xTF32 on the tensor cores, both operands
//    streamed in 32-deep slices through a ring of three shared stages
//    (repro::issue_slice / mma_slice_3xtf32), fp32 accumulators in
//    registers across the whole depth: shared memory does not grow with d.
//  * k: each test row keeps its k best as sorted 64-bit keys, (order-
//    preserving bits of the distance) << 32 | training index.  Keys are
//    unique and their order is the tie rule (equal distances: lower index
//    first), so the k smallest keys are the answer whatever order they
//    are found in.  A row's k-th distance sits in a register as its
//    threshold; a distance at or below it is appended to the row's buffer
//    of 32 keys in shared memory, and buffers are merged into the lists
//    by one lane per row (insert_keys), 16 rows side by side.  After the
//    first tiles almost nothing passes the threshold, so merges are rare.
//    The lists are in shared memory where k x 128 keys fit beside the
//    ring (k <= 85), else in global scratch, which stays in L2.
//  * knn_wide_merge merges the splits' lists per row (a warp per row) and
//    decodes keys into distances and labels.
// Scratch: |x|^2 and |y|^2 (m + n floats), splits x m x k keys, and 2 x m
// x k keys for the merge.  Integer-valued inputs give exact distances, so
// the result equals the plain version's bit for bit; two launches are
// bitwise equal (no float atomics; the buffers' order is undone by the
// merges).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

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
// (Bound to three, the K = 32 list's 184 registers would spill.)
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
            repro::mma_3xtf32(acc[i][j + h], ah[i], al[i], bh[2 * h], bh[2 * h + 1], bl[2 * h],
                              bl[2 * h + 1]);
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

constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideRows = 16 * kWideWarps;  // test rows per block, 16 per warp
constexpr int kWideTile = 128;              // training rows per tile (16 n8 tiles)
constexpr int kWideStages = 3;              // slices in the ring
constexpr int kBufKeys = 32;                // candidates buffered per test row
constexpr unsigned long long kNone = ~0ull;  // an empty list entry: after every key

// Float bits that order as the floats do (negative values reversed).
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_ordered_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
__device__ __forceinline__ unsigned long long make_key(float dist, int index) {
  return static_cast<unsigned long long>(ordered_bits(dist)) << 32 | static_cast<uint32_t>(index);
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

// The row's threshold: the distance of its k-th key, +inf while the list
// has fewer than k keys.
__device__ __forceinline__ float list_threshold(const unsigned long long* list, int k) {
  const unsigned long long kth = list[k - 1];
  return kth == kNone ? CUDART_INF_F : from_ordered_bits(static_cast<uint32_t>(kth >> 32));
}

// One lane merges c buffered keys of its row into the row's ascending
// list of k keys, keeping the k smallest: a key below the k-th goes to
// its place (binary search), the entries above it move up one and the
// last falls off.  Keys are unique (the training index is in them) and
// their order is the tie rule, so the list does not depend on the order
// the keys were buffered in.  The lanes of a warp merge their rows side
// by side.
__device__ __forceinline__ void insert_keys(const unsigned long long* buf, int c,
                                            unsigned long long* list, int k) {
  unsigned long long kth = list[k - 1];
  for (int i = 0; i < c; ++i) {
    const unsigned long long key = buf[i];
    if (key >= kth) continue;
    const int at = count_below(list, k - 1, key);
    int j = k - 1;
    for (; j - 4 >= at; j -= 4) {   // four moves per trip: their loads go together
      const unsigned long long a = list[j - 1], b = list[j - 2], c2 = list[j - 3],
                               d = list[j - 4];
      list[j] = a;
      list[j - 1] = b;
      list[j - 2] = c2;
      list[j - 3] = d;
    }
    for (; j > at; --j) list[j] = list[j - 1];
    list[at] = key;
    kth = list[k - 1];
  }
}

// The wide route's block: test rows row0 .. row0 + 127 against training
// rows [n0, n1) of split blockIdx.y, in tiles of 128.  Each tile's 128 x
// 128 cross terms come from the depth-streamed 3xTF32 product
// (repro::mma_slice_3xtf32; warp w owns test rows 16 w .. 16 w + 15 and
// all 128 columns, in registers); the tile's |y|^2 ride in the stage of
// its last slice.  A lane then forms the distances of its 64 entries,
// (|x|^2 - 2 x.y) + |y|^2 as knn_chunk_topk does, and tests each against
// its row's threshold (the distance of the row's k-th key, in a register;
// <= lets through every key that may enter).  The keys that pass are
// appended to the row's buffer (kBufKeys slots in shared memory; a quad's
// lanes find their slots by ballots, so nothing is atomic).  When a row's
// buffer may overflow on the next n8 tile, or the chunk ends, lanes 0-15
// of the warp merge its 16 rows' buffers into their lists (insert_keys)
// and the thresholds are reloaded; before each new tile every warp does
// so at once where a row of the block holds over half a buffer.  Lists:
// k keys per row, in shared memory where the wrapper finds room
// (lists_shared), else in `part`, global scratch that stays in L2.  At
// the end each row's list goes to part[split].
__global__ void __launch_bounds__(kWideThreads, 1)
knn_wide_topk(const float* __restrict__ test, const float* __restrict__ train,
              const float* __restrict__ test_sq, const float* __restrict__ train_sq, int m,
              int n, int d, int k, int chunk, int vec, int lists_shared,
              unsigned long long* __restrict__ part) {
  extern __shared__ float4 smem4[];
  // a stage: a slice of the test rows, one of the training tile, and the
  // tile's |y|^2 (written with its last slice)
  constexpr int stage_floats = (kWideRows + kWideTile) * repro::kSliceLD + kWideTile;
  float* ring = reinterpret_cast<float*>(smem4);
  unsigned long long* bufs = reinterpret_cast<unsigned long long*>(ring + kWideStages * stage_floats);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * kWideRows;
  const int rows = min(kWideRows, m - row0);
  const int n0 = blockIdx.y * chunk;
  const int n1 = min(n, n0 + chunk);
  unsigned long long* out = part + (static_cast<long>(blockIdx.y) * m + row0) * k;
  unsigned long long* lists = lists_shared ? bufs + kWideRows * kBufKeys : out;
  for (int i = tid; i < rows * k; i += kWideThreads) lists[i] = kNone;
  __syncthreads();

  const int slices = (d + repro::kSliceDepth - 1) / repro::kSliceDepth;
  const int tiles = (n1 - n0 + kWideTile - 1) / kWideTile;
  const int steps = tiles * slices;
  auto issue = [&](int s) {
    const int t = s / slices, q = s - t * slices;
    float* st = ring + (s % kWideStages) * stage_floats;
    const int j0 = q * repro::kSliceDepth;
    repro::issue_slice<kWideThreads>(st, kWideRows, test + static_cast<long>(row0) * d, rows, d,
                                     j0, vec);
    const int c0 = n0 + t * kWideTile;
    const int cols = min(kWideTile, n1 - c0);
    repro::issue_slice<kWideThreads>(st + kWideRows * repro::kSliceLD, kWideTile,
                                     train + static_cast<long>(c0) * d, cols, d, j0, vec);
    float* yt = st + (kWideRows + kWideTile) * repro::kSliceLD;
    if (q == slices - 1 && tid < kWideTile) {
      repro::cp_async4(repro::smem_addr(yt + tid), train_sq + (tid < cols ? c0 + tid : 0),
                       tid < cols);
    }
  };
#pragma unroll
  for (int s = 0; s < kWideStages - 1; ++s) {
    if (s < steps) issue(s);
    repro::cp_async_commit();
  }

  // this lane's rows: lo = 16 warp + g, hi = lo + 8 (block-local)
  const int r_lo = 16 * warp + g, r_hi = r_lo + 8;
  const bool ok_lo = r_lo < rows, ok_hi = r_hi < rows;
  const float xsq_lo = ok_lo ? test_sq[row0 + r_lo] : 0.f;
  const float xsq_hi = ok_hi ? test_sq[row0 + r_hi] : 0.f;
  unsigned long long* buf_lo = bufs + r_lo * kBufKeys;
  unsigned long long* buf_hi = bufs + r_hi * kBufKeys;
  float thr_lo = CUDART_INF_F, thr_hi = CUDART_INF_F;
  int cnt_lo = 0, cnt_hi = 0;       // the same in the quad's four lanes
  const unsigned quad = 0xfu << (lane & ~3);
  const unsigned below = (1u << lane) - 1;

  auto flush = [&]() {
    // lane r < 16 merges the warp's row r: rows 0-7 are the quads' lo
    // rows, 8-15 their hi rows
    const int c_lo = __shfl_sync(0xffffffffu, cnt_lo, 4 * (lane & 7));
    const int c_hi = __shfl_sync(0xffffffffu, cnt_hi, 4 * (lane & 7));
    __syncwarp();   // the buffers' appends are visible
    if (lane < 16) {
      const int br = 16 * warp + lane;
      insert_keys(bufs + br * kBufKeys, lane < 8 ? c_lo : c_hi, lists + static_cast<long>(br) * k,
                  k);
    }
    __syncwarp();
    cnt_lo = cnt_hi = 0;
    if (ok_lo) thr_lo = list_threshold(lists + static_cast<long>(r_lo) * k, k);
    if (ok_hi) thr_hi = list_threshold(lists + static_cast<long>(r_hi) * k, k);
  };

  const uint32_t a_off = repro::slice_a_addr(ring, 16 * warp) - repro::smem_addr(ring);
  const uint32_t b_off = repro::slice_b_addr(ring + kWideRows * repro::kSliceLD) -
                         repro::smem_addr(ring);
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float unused[2];

  for (int s = 0; s < steps; ++s) {
    const int t = s / slices, q = s - t * slices;
    repro::cp_async_wait<kWideStages - 2>();
    // slice s landed; every warp is done with slice s - 1.  Before a new
    // tile, every warp merges at once where a row of the block holds
    // over half a buffer: the warps wait for each other at these
    // barriers, so one warp's merge alone would hold up the other seven
    if (q == 0 && t > 0) {
      if (__syncthreads_or(cnt_lo > kBufKeys / 2 || cnt_hi > kBufKeys / 2)) flush();
    } else {
      __syncthreads();
    }
    if (s + kWideStages - 1 < steps) issue(s + kWideStages - 1);
    repro::cp_async_commit();
    const float* stf = ring + (s % kWideStages) * stage_floats;
    const uint32_t st = repro::smem_addr(stf);
    const int ksteps = min(4, (d - q * repro::kSliceDepth + 7) / 8);
    repro::mma_slice_3xtf32<16, false>(acc, st + a_off, st + b_off, ksteps, 16, unused);
    if (q != slices - 1) continue;

    // the tile's distances against the thresholds, one n8 tile at a time
    const int c0 = n0 + t * kWideTile;
    const int cols = min(kWideTile, n1 - c0);
    const float* yt = stf + (kWideRows + kWideTile) * repro::kSliceLD;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t4;
      const bool in0 = col < cols, in1 = col + 1 < cols;
      const float2 y = *reinterpret_cast<const float2*>(yt + col);
      const float d0 = fmaf(-2.f, acc[j][0], xsq_lo) + y.x;
      const float d1 = fmaf(-2.f, acc[j][1], xsq_lo) + y.y;
      const float d2 = fmaf(-2.f, acc[j][2], xsq_hi) + y.x;
      const float d3 = fmaf(-2.f, acc[j][3], xsq_hi) + y.y;
      const bool p0 = ok_lo && in0 && d0 <= thr_lo;
      const bool p1 = ok_lo && in1 && d1 <= thr_lo;
      const bool p2 = ok_hi && in0 && d2 <= thr_hi;
      const bool p3 = ok_hi && in1 && d3 <= thr_hi;
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      if (!__any_sync(0xffffffffu, p0 || p1 || p2 || p3)) continue;
      const unsigned b0 = __ballot_sync(0xffffffffu, p0), b1 = __ballot_sync(0xffffffffu, p1);
      const unsigned b2 = __ballot_sync(0xffffffffu, p2), b3 = __ballot_sync(0xffffffffu, p3);
      const int at_lo = cnt_lo + __popc(b0 & quad & below) + __popc(b1 & quad & below);
      if (p0) buf_lo[at_lo] = make_key(d0, c0 + col);
      if (p1) buf_lo[at_lo + p0] = make_key(d1, c0 + col + 1);
      const int at_hi = cnt_hi + __popc(b2 & quad & below) + __popc(b3 & quad & below);
      if (p2) buf_hi[at_hi] = make_key(d2, c0 + col);
      if (p3) buf_hi[at_hi + p2] = make_key(d3, c0 + col + 1);
      cnt_lo += __popc(b0 & quad) + __popc(b1 & quad);
      cnt_hi += __popc(b2 & quad) + __popc(b3 & quad);
      // the next n8 tile adds at most 8 keys to a row
      if (__any_sync(0xffffffffu, cnt_lo > kBufKeys - 8 || cnt_hi > kBufKeys - 8)) flush();
    }
  }
  flush();
  if (lists_shared) {
    const long first = static_cast<long>(16 * warp) * k;
    const long last = static_cast<long>(min(16 * warp + 16, rows)) * k;
    for (long i = first + lane; i < last; i += 32) out[i] = lists[i];
  }
}

// One warp per test row: the splits' lists merged in split order (each
// pass keeps the k smallest of the running list and the next split's, by
// place rule: a_i goes to i + (b's keys below it), b_i to i + (a's keys
// below it), the places below k kept, between two scratch lists), then the
// keys decoded into distances and the labels of their training rows.
__global__ void knn_wide_merge(const unsigned long long* __restrict__ part, int m, int k,
                               int splits, unsigned long long* __restrict__ tmp,
                               const int* __restrict__ labels, float* __restrict__ out_d,
                               int* __restrict__ out_l) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const unsigned long long* a = part + static_cast<long>(row) * k;
  for (int s = 1; s < splits; ++s) {
    const unsigned long long* b = part + (static_cast<long>(s) * m + row) * k;
    unsigned long long* o = tmp + (static_cast<long>(s & 1) * m + row) * k;
    for (int i = lane; i < k; i += 32) {
      const unsigned long long ka = a[i], kb = b[i];
      const int ta = i + count_below(b, k, ka), tb = i + count_below(a, k, kb);
      if (ta < k) o[ta] = ka;
      if (tb < k) o[tb] = kb;
    }
    __syncwarp();
    a = o;
  }
  for (int i = lane; i < k; i += 32) {
    const unsigned long long key = a[i];
    out_d[static_cast<long>(row) * k + i] = from_ordered_bits(static_cast<uint32_t>(key >> 32));
    out_l[static_cast<long>(row) * k + i] = labels[static_cast<uint32_t>(key)];
  }
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

// The wide route: any 1 <= k <= n and d >= 1.  Training rows go in
// `splits` chunks of `chunk` rows (whole tiles; grid.y), `vec` floats per
// copy (4, 2 or 1; d % vec == 0, test and train 4 vec bytes aligned);
// lists_shared: the rows' lists fit the block's shared memory (smem bytes
// in all).  Scratch: test_sq m and train_sq n floats, part splits x m x k
// keys, tmp 2 x m x k keys (read only when splits > 1).  Returns a
// cudaError_t.
extern "C" int knn_wide_launch(const float* test, const float* train, const int* labels,
                               int m, int n, int d, int k, int chunk, int splits, int vec,
                               int lists_shared, int smem, float* test_sq, float* train_sq,
                               unsigned long long* part, unsigned long long* tmp, float* out_d,
                               int* out_l, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || d < 1 || k < 1 || k > n || splits < 1 || chunk < 1 ||
      chunk % kWideTile != 0 || static_cast<long>(splits) * chunk < n ||
      (vec != 1 && vec != 2 && vec != 4) || d % vec != 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(knn_wide_topk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  row_sqnorms<<<(m + 255) / 256, 256, 0, s>>>(test, m, d, test_sq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  row_sqnorms<<<(n + 255) / 256, 256, 0, s>>>(train, n, d, train_sq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_wide_topk<<<dim3((m + kWideRows - 1) / kWideRows, splits), kWideThreads, smem, s>>>(
      test, train, test_sq, train_sq, m, n, d, k, chunk, vec, lists_shared, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_wide_merge<<<(m + 7) / 8, 256, 0, s>>>(part, m, k, splits, tmp, labels, out_d, out_l);
  return cudaGetLastError();
}
