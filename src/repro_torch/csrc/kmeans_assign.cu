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
// at 3.35 TB/s) against 8e8 flops (~0.012 ms at 67 TFLOP/s; the tensor-core
// route below does 3 + 2 TF32 products of that size, 4e9 flops, ~0.008 ms
// at 495 TFLOP/s).
//
// Design, deterministic by construction (no float atomics, so a replayed
// task gives the same bits — lineage recovery depends on that):
//  * kernel 1: two persistent blocks of 8 warps per SM walk tiles
//    blockIdx.x, blockIdx.x + grid, ... of T points (T = 256 while two
//    blocks fit an SM, up to d 53 at k 16; fewer for wider points, see
//    tile_points in kernels/kmeans_assign.py).  A tile is T*d contiguous
//    floats, so it streams into a ring of two shared stages as 16-byte
//    `cp.async` pieces of the flat array (4-byte pieces at the ragged
//    ends, zero-filled past n): the next tile loads while the block works
//    on this one, and the SM's other block fills the gaps of this one's
//    barriers.
//  * The assignment runs on the tensor cores too: warp w scores points
//    32w .. 32w + 31 of the tile against 16 centroids per pass as 3xTF32
//    `mma.sync.m16n8k8` products (x_lo c_hi + x_hi c_lo + x_hi c_hi, each
//    operand split into TF32 hi + lo: fp32-grade dot products, exact on
//    small integers); the centroids' fragments are split once per block
//    into shared memory.  The argmax of x.c - |c|^2/2 keeps the first
//    strict maximum: a lane's four clusters in order, then its quad by
//    shuffles with the lower index on ties.  |x|^2 comes from the same
//    fragments.  (On the fp32 CUDA cores, two points per thread, the
//    assignment cost as much as the sums.)
//  * The sums are the Pallas kernel's second matmul, on the tensor cores:
//    sums (k x d) += onehot^T (k x T) . X (T x d) by `mma.sync.m16n8k8`
//    in TF32 with fp32 accumulators.  The one-hot A fragment is built in
//    registers from the tile's assignments (1.0 is exact in TF32; they
//    are stored permuted so that a lane's four points of a 16-point step
//    are one 16-byte load), and each X value is split into TF32 hi + lo
//    (x - hi is exact in fp32): hi + lo keep 22 of fp32's 24 bits, within
//    ~2^-22 of x, and every product with 1.0 is exact.  (Three bf16 terms
//    would carry all 24 bits; their split cost 5.5 instructions a value
//    against 4, and the pass is instruction-bound.)  k is padded to 16
//    and d to 8: columns past d read neighbouring values and land in sums
//    columns that are never stored.  Warp w owns the 8-dim column slices
//    w, w + 8, ... of the sums for all clusters and keeps them in fp32
//    accumulators across the block's tiles: one chain per term and 8-point
//    half (4 independent mma chains where a warp owns one 16 x 8 tile, as
//    at d 50, k 16), added in order at the end.
//  * Counts: the lanes of one cluster found by `match_any`, added by
//    their leader with a shared integer atomic (the same total in any
//    order); the sse by a warp shuffle tree, kept per warp and summed in
//    warp order.
//  * kernel 2 sums the per-block partials: one warp per output, lanes
//    striding over the blocks, then a fixed shuffle tree.
// The tensor-core route takes k <= 64 and d <= 256 (the accumulators of a
// warp stay in registers).
//
// The wide route (kmeans_wide_launch) takes every other k and d; the
// wrapper picks the route by shape before launch (kmeans_assign.route)
// and neither hands work to the other.  Both give the same function:
//  * persistent blocks of 8 warps walk tiles of 128 points; the scores
//    are 3xTF32 on the tensor cores over centroid tiles of 16 (k 65 pads
//    to 80), in passes of up to 128 centroids, both operands streamed in
//    32-deep slices through a ring of three shared stages (repro::
//    issue_slice / mma_slice_3xtf32), fp32 accumulators in registers
//    across the depth: shared memory does not grow with d.  The running
//    argmax keeps the first strict maximum, lower index on ties, as above.
//  * the sums: each tile's points sorted stably by cluster and each
//    cluster's segment added in point order by one thread per (cluster,
//    dim), on the CUDA cores: the tile's d adds per point and no one-hot
//    products, whatever k is.  The partials are those of the in-order
//    sums, bit for bit; counts are segment lengths, in integers.
//  * per-block partials (in shared memory where k x d fits beside the
//    ring, else in global scratch) reduced in block order by
//    kmeans_reduce_blocks, as above.
// Scratch: |c|^2/2 (k floats) and blocks x (k*d + k + 1) partials, the
// blocks chosen so that the partials stay within 2^22 floats (16 MiB)
// unless one alone is larger.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::mma_tf32;
using repro::smem_addr;
using repro::split_tf32;

// Position of point p of a tile in the permuted assignment array: lane
// (g, t4) of a warp finds the points t4, t4 + 4, t4 + 8 and t4 + 12 of a
// 16-point step, its four A-fragment columns, in one 16-byte load.
__device__ __forceinline__ int asg_slot(int p) {
  return (p & ~15) + 4 * (p & 3) + ((p & 15) >> 2);
}

// Queue one tile (floats [g0, g_end) of x, at most `floats` - 4 of them)
// into a stage whose float `a` matches g0, a = (address of x[g0] / 4) % 4,
// so that the 16-byte pieces of the flat array land 16-byte aligned.
// Whole pieces inside the tile are one 16-byte copy each; the two ragged
// ends go by 4-byte copies, and the stage past the tile reads as zero.
__device__ __forceinline__ void issue_tile(float* stage, int floats, const float* x, long g0,
                                           long g_end, int a) {
  const float* base = x + g0 - a;
  const int valid = a + static_cast<int>(g_end - g0);  // stage floats [a, valid) hold the tile
  const int first = (a + 3) / 4;                        // the whole pieces: [first, last)
  const int last = valid / 4;
  const uint32_t dst0 = smem_addr(stage);
  for (int i = first + threadIdx.x; i < last; i += kThreads) {
    cp_async16(dst0 + 16 * i, base + 4 * i, true);
  }
  for (int i = last + (valid % 4 != 0) + threadIdx.x; i < floats / 4; i += kThreads) {
    cp_async16(dst0 + 16 * i, x, false);
  }
  // the ragged ends: piece 0 (when a > 0) and piece `last` (when valid % 4)
  if (threadIdx.x < 8) {
    const bool head = threadIdx.x < 4;
    const int i = head ? 0 : last;
    if (head ? a > 0 : valid % 4 != 0 && (last > 0 || a == 0)) {
      const int f = 4 * i + (threadIdx.x & 3);
      const bool ok = f >= a && f < valid;
      cp_async4(dst0 + 4 * f, ok ? base + f : x, ok);
    }
  }
}

// MT m-tiles of 16 clusters, NTW 8-dim column slices per warp
template <int MT, int NTW>
__global__ void __launch_bounds__(kThreads, 1)
kmeans_tc_partials(const float* __restrict__ x, const float* __restrict__ c, int n, int k,
                   int d, int T, int stage_floats, float* __restrict__ part_sums,
                   int* __restrict__ part_counts, float* __restrict__ part_sse) {
  constexpr int KP = 16 * MT;  // clusters padded to the m-tiles
  const int kd8 = (d + 7) / 8;  // 8-dim k-steps of the scores
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);       // kStages x stage_floats
  uint4* ctab = reinterpret_cast<uint4*>(ring + kStages * stage_floats);
  float* hc = reinterpret_cast<float*>(ctab + MT * kd8 * 64);  // KP: |c|^2 / 2
  int* asg = reinterpret_cast<int*>(hc + KP);          // T: cluster or -1, permuted
  int* cnt = asg + T;                                  // KP: the block's counts
  float* red = reinterpret_cast<float*>(cnt + KP);     // kWarps: sse per warp

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  // the centroids as B fragments of the scores, split into TF32 hi + lo:
  // entry ((m kd8 + ks) 2 + nt) 32 + lane holds, for b0 = c[16 m + 8 nt +
  // g][8 ks + t4] and b1 four dims on, {hi b0, hi b1, lo b0, lo b1} (zero
  // past k and d)
  for (int i = tid; i < MT * kd8 * 64; i += kThreads) {
    const int ln = i & 31, nt = (i >> 5) & 1, mk = i >> 6;
    const int cl = 16 * (mk / kd8) + 8 * nt + (ln >> 2);
    const int j = 8 * (mk % kd8) + (ln & 3);
    const float* cr = c + static_cast<long>(cl) * d;
    const float v0 = cl < k && j < d ? cr[j] : 0.f;
    const float v1 = cl < k && j + 4 < d ? cr[j + 4] : 0.f;
    uint4 e;
    split_tf32(v0, e.x, e.z);
    split_tf32(v1, e.y, e.w);
    ctab[i] = e;
  }
  for (int cl = tid; cl < KP; cl += kThreads) {
    float s = 0.f;
    for (int j = 0; cl < k && j < d; ++j) s = fmaf(c[cl * d + j], c[cl * d + j], s);
    hc[cl] = 0.5f * s;
    cnt[cl] = 0;
  }

  const int n_tiles = (n + T - 1) / T;
  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int xmis = static_cast<int>((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
  auto issue = [&](int it) {
    const long p0 = static_cast<long>(blockIdx.x + it * gridDim.x) * T;
    const long g0 = p0 * d;
    const long g_end = min(p0 + T, static_cast<long>(n)) * d;
    issue_tile(ring + (it % kStages) * stage_floats, stage_floats, x, g0, g_end,
               static_cast<int>((xmis + g0) & 3));
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < my_tiles) issue(s);
    cp_async_commit();
  }

  // kChains independent accumulators per output tile, so that an mma need
  // not wait for the last: one per term and k-step parity where a warp
  // owns one tile, one per term where it owns two or three
  constexpr int kChains = MT * NTW >= 4 ? 1 : (MT * NTW >= 2 ? 2 : 4);
  float acc[MT][NTW][kChains][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int q = 0; q < NTW; ++q)
#pragma unroll
      for (int ch = 0; ch < kChains; ++ch)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][q][ch][e] = 0.f;
  float sse = 0.f;        // this warp's running sse (every lane holds it)
  const int ntd = (d + 7) / 8;

  for (int it = 0; it < my_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` landed; the stage and asg of tile it-1 are free
    if (it + kStages - 1 < my_tiles) issue(it + kStages - 1);
    cp_async_commit();

    const long p0 = static_cast<long>(blockIdx.x + it * gridDim.x) * T;
    const int rows = static_cast<int>(min(static_cast<long>(T), n - p0));
    const float* xs = ring + (it % kStages) * stage_floats +
                      static_cast<int>((xmis + p0 * d) & 3);

    // assignment: warp w scores points 32w .. 32w + 31 of the tile, x . c
    // in 3xTF32 on the tensor cores (x_lo c_hi + x_hi c_lo + x_hi c_hi),
    // 16 clusters per pass; columns of x past d meet zero centroid columns
    if (warp * 32 < T) {
      const float* xw = xs + 32 * warp * d;
      float best[2][2], xsq[2][2];   // [16-point half][row g | g + 8]
      int arg[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          best[mt][r] = -CUDART_INF_F;
          arg[mt][r] = 0;
          xsq[mt][r] = 0.f;
        }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float sc[2][2][4];           // [half][8-cluster slice][fragment]
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[mt][nt][e] = 0.f;
        for (int ks = 0; ks < kd8; ++ks) {
          const uint4 b0 = ctab[((m * kd8 + ks) * 2) * 32 + lane];
          const uint4 b1 = ctab[((m * kd8 + ks) * 2 + 1) * 32 + lane];
          const int j = 8 * ks + t4;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            // a0 (row g, dim j), a1 (row g + 8, j), a2 (g, j + 4), a3 (g + 8, j + 4)
            const float* xr = xw + (16 * mt + g) * d + j;
            const float v[4] = {xr[0], xr[8 * d], xr[4], xr[8 * d + 4]};
            if (m == 0) {
              xsq[mt][0] += (j < d ? v[0] * v[0] : 0.f) + (j + 4 < d ? v[2] * v[2] : 0.f);
              xsq[mt][1] += (j < d ? v[1] * v[1] : 0.f) + (j + 4 < d ? v[3] * v[3] : 0.f);
            }
            uint32_t ah[4], al[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) split_tf32(v[q], ah[q], al[q]);
            mma_tf32(sc[mt][0], al, b0.x, b0.y);
            mma_tf32(sc[mt][1], al, b1.x, b1.y);
            mma_tf32(sc[mt][0], ah, b0.z, b0.w);
            mma_tf32(sc[mt][1], ah, b1.z, b1.w);
            mma_tf32(sc[mt][0], ah, b0.x, b0.y);
            mma_tf32(sc[mt][1], ah, b1.x, b1.y);
          }
        }
        // the first strict maximum of the pass: a lane's 4 clusters in
        // order, then its quad, lower index on ties; then the running one
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float lb = -CUDART_INF_F;
            int la = 0x7fffffff;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int cl = 16 * m + 8 * nt + 2 * t4 + e;
                const float v = sc[mt][nt][2 * r + e] - hc[cl];
                if (cl < k && v > lb) {
                  lb = v;
                  la = cl;
                }
              }
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1) {
              const float ob = __shfl_xor_sync(0xffffffffu, lb, off);
              const int oa = __shfl_xor_sync(0xffffffffu, la, off);
              if (ob > lb || (ob == lb && oa < la)) {
                lb = ob;
                la = oa;
              }
            }
            if (lb > best[mt][r]) {  // strict: the earlier pass keeps a tie
              best[mt][r] = lb;
              arg[mt][r] = la;
            }
          }
      }
      float e = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float q = xsq[mt][r];
          q += __shfl_xor_sync(0xffffffffu, q, 1);
          q += __shfl_xor_sync(0xffffffffu, q, 2);
          const int p = 32 * warp + 16 * mt + g + 8 * r;
          const bool ok = p < rows;
          if (t4 == 0) {
            asg[asg_slot(p)] = ok ? arg[mt][r] : -1;
            if (ok) e += q - 2.f * best[mt][r];
          }
        }
      // the sse of the warp's points by a fixed shuffle tree
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(0xffffffffu, e, off);
      sse += e;
    }
    __syncthreads();  // asg is complete

    // counts: lanes of one cluster found by match_any, their leader adds
    // them (integer atomics: the same total in any order)
    if (warp * 32 < T) {
      const int cl = asg[tid];
      const unsigned same = __match_any_sync(0xffffffffu, cl);
      if (cl >= 0 && lane == __ffs(same) - 1) atomicAdd(cnt + cl, __popc(same));
    }

    // sums += onehot^T . X on the tensor cores: two k-steps of 8 points
    // per 16, each with TF32 hi and lo terms of X
    for (int ks = 0; ks < T / 16; ++ks) {
      const int4 pa = *reinterpret_cast<const int4*>(asg + 16 * ks + 4 * t4);
      const int pts[4] = {pa.x, pa.y, pa.z, pa.w};   // points t4 + 4r of the step
      const float* xrow = xs + (16 * ks + t4) * d;
#pragma unroll
      for (int half = 0; half < 2; ++half) {     // points 8 half + {t4, t4 + 4}
        uint32_t fa[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int c_lo = 16 * m + g, c_hi = c_lo + 8;
          const int p0 = pts[2 * half], p1 = pts[2 * half + 1];
          fa[m][0] = p0 == c_lo ? 0x3F800000u : 0u;
          fa[m][1] = p0 == c_hi ? 0x3F800000u : 0u;
          fa[m][2] = p1 == c_lo ? 0x3F800000u : 0u;
          fa[m][3] = p1 == c_hi ? 0x3F800000u : 0u;
        }
#pragma unroll
        for (int q = 0; q < NTW; ++q) {
          const int nt = warp + kWarps * q;
          if (nt < ntd) {
            // columns past d read the next point's values (or the stage's
            // zero tail): they land in sums columns that are never stored
            const float* col = xrow + (8 * half) * d + 8 * nt + g;
            uint32_t h0, l0, h1, l1;
            split_tf32(col[0], h0, l0);
            split_tf32(col[4 * d], h1, l1);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              mma_tf32(acc[m][q][kChains == 4 ? 2 * half : 0], fa[m], l0, l1);
              mma_tf32(acc[m][q][kChains == 4 ? 2 * half + 1 : (kChains == 2 ? 1 : 0)], fa[m], h0,
                       h1);
            }
          }
        }
      }
    }
  }

  // per-block partials: the sums straight from the accumulators (each
  // (cluster, dim) belongs to one warp), the chains added lo first;
  // counts and sse in warp order
  float* out = part_sums + static_cast<long>(blockIdx.x) * k * d;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int q = 0; q < NTW; ++q) {
      const int nt = warp + kWarps * q;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // the chains added in order: lo and hi of the first 8 points of a
        // step, then of the second 8
        float v = acc[m][q][0][e];
#pragma unroll
        for (int ch = 1; ch < kChains; ++ch) v += acc[m][q][ch][e];
        const int cl = 16 * m + g + 8 * (e >> 1);
        const int j = 8 * nt + 2 * t4 + (e & 1);
        if (nt < ntd && cl < k && j < d) out[cl * d + j] = v;
      }
    }
  if (lane == 0) red[warp] = sse;
  __syncthreads();
  if (tid < k) part_counts[static_cast<long>(blockIdx.x) * k + tid] = cnt[tid];
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    part_sse[blockIdx.x] = s;
  }
}

// One warp per output: lanes add the per-block partials b = lane,
// lane + 32, ... in order, then a fixed shuffle tree adds the lanes.
__global__ void kmeans_reduce_blocks(const float* __restrict__ part_sums,
                                     const int* __restrict__ part_counts,
                                     const float* __restrict__ part_sse, int blocks, int k,
                                     int d, float* __restrict__ sums, int* __restrict__ counts,
                                     float* __restrict__ sse) {
  const int q = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int kd = k * d;
  if (q < kd) {
    float s = 0.f;
    for (int b = lane; b < blocks; b += 32) s += part_sums[static_cast<long>(b) * kd + q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) sums[q] = s;
  } else if (q < kd + k) {
    const int cl = q - kd;
    int s = 0;
    for (int b = lane; b < blocks; b += 32) s += part_counts[static_cast<long>(b) * k + cl];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) counts[cl] = s;
  } else if (q == kd + k) {
    float s = 0.f;
    for (int b = lane; b < blocks; b += 32) s += part_sse[b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) *sse = s;
  }
}

// ----------------------------------------------------------- wide route

constexpr int kWidePoints = 16 * kWarps;  // points per tile, 16 per warp
constexpr int kWideStages = 3;            // slices in the ring

// |c|^2 / 2 of every centroid, fmaf in column order as kmeans_tc_partials.
__global__ void half_sqnorms(const float* __restrict__ c, int k, int d, float* __restrict__ hc) {
  const int cl = blockIdx.x * blockDim.x + threadIdx.x;
  if (cl >= k) return;
  const float* row = c + static_cast<long>(cl) * d;
  float s = 0.f;
  for (int j = 0; j < d; ++j) s = fmaf(row[j], row[j], s);
  hc[cl] = 0.5f * s;
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

// The wide route's persistent block: tiles blockIdx.x, blockIdx.x + grid,
// ... of 128 points (16 per warp).  Each tile takes passes x slices steps
// of assignment, then (d > 64) `slices` steps of sums, all through one
// ring of three shared stages filled by cp.async.
//  * Assignment: the tile's points times the centroids in passes of 8 NT
//    (k rounded up to 16, at most 128: k 65 takes 80 columns, not 128),
//    each pass over the whole depth in 32-deep slices of both operands,
//    3xTF32 on the tensor cores (repro::mma_slice_3xtf32); a last, short
//    pass multiplies only its 16-centroid tiles that hold a centroid.
//    Up to 96 centroids a pass, two blocks share an SM; past that the
//    accumulators take one SM's registers for one block.  The pass's |c|^2/2 ride in the stage of its last
//    slice.  A lane keeps the first strict maximum of x.c - |c|^2/2 over
//    its clusters in order, its quad merges by shuffles (lower index on
//    ties), and a later pass replaces the running best only when strictly
//    greater.  |x|^2 comes from the first pass's fragments.
//  * Then the tile's points are sorted by cluster, stably (key cluster <<
//    7 | point: four warps sort 32 keys each, then each key's place is its
//    index plus the keys below it in the other three runs); counts add
//    each cluster's segment length, in integers.
//  * Sums: for each of the tile's slices one thread per (cluster, dim)
//    adds the cluster's segment in point order into the block's partial,
//    reading the points from shared memory: the partial sees the adds
//    the in-order sums make, bit for bit, and no one-hot product is
//    formed whatever k is.  Where the tile's slices all fit the ring (d
//    <= 64) they are read there after the last assignment step, the
//    next slice's copy waiting for them; else they stream in once more.
//  * Partials (k x d sums, k counts) in shared memory where they fit
//    (shared_partials), else the block's slice of global scratch.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 12 ? 2 : 1)
kmeans_wide_partials(const float* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ hc, int n, int k, int d, int vec,
                     int shared_partials, float* __restrict__ part_sums,
                     int* __restrict__ part_counts, float* __restrict__ part_sse) {
  constexpr int PW = 8 * NT;  // centroids per pass: k rounded up to 16, at most 128
  constexpr int TP = kWidePoints;
  constexpr int LD = repro::kSliceLD;
  constexpr int nb = PW;      // centroid rows staged per pass
  // a stage: a slice of the points, one of the pass's centroids, and the
  // pass's |c|^2/2 (written with its last slice)
  const int stage_floats = (TP + nb) * LD + nb;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(ring + kWideStages * stage_floats);
  int* asg = reinterpret_cast<int*>(keys + TP);  // TP: cluster, k past the points
  int* seg = asg + TP;                           // TP + 1: segment starts, then the end
  int* wseg = seg + TP + 4;                      // 4: heads per sorting warp
  float* red = reinterpret_cast<float*>(wseg + 4);   // kWarps: sse per warp
  const long kd = static_cast<long>(k) * d;
  float* S = shared_partials ? red + kWarps : part_sums + blockIdx.x * kd;
  int* C = shared_partials ? reinterpret_cast<int*>(red + kWarps + kd)
                           : part_counts + static_cast<long>(blockIdx.x) * k;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  for (long i = tid; i < kd; i += kThreads) S[i] = 0.f;
  for (int i = tid; i < k; i += kThreads) C[i] = 0;

  const int slices = (d + repro::kSliceDepth - 1) / repro::kSliceDepth;
  const int passes = (k + PW - 1) / PW;
  const int assign_steps = passes * slices;
  // where a tile's slices all fit the ring (d <= 64), the sums read them
  // there after the last assignment step; else they stream in once more
  const bool in_ring = slices < kWideStages;
  const int per_tile = assign_steps + (in_ring ? 0 : slices);
  const int n_tiles = (n + TP - 1) / TP;
  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int steps = my_tiles * per_tile;
  auto issue = [&](int s) {
    const int it = s / per_tile, r = s - it * per_tile;
    const long p0 = static_cast<long>(blockIdx.x + it * gridDim.x) * TP;
    float* st = ring + (s % kWideStages) * stage_floats;
    const int pts = static_cast<int>(min(static_cast<long>(TP), n - p0));
    if (r >= assign_steps) {   // a slice of the tile again, for the sums
      repro::issue_slice<kThreads>(st, TP, x + p0 * d, pts, d,
                                   (r - assign_steps) * repro::kSliceDepth, vec);
      return;
    }
    const int pass = r / slices, q = r - pass * slices;
    const int j0 = q * repro::kSliceDepth;
    repro::issue_slice<kThreads>(st, TP, x + p0 * d, pts, d, j0, vec);
    const int c0 = pass * PW;
    const int pc = min(PW, k - c0);
    repro::issue_slice<kThreads>(st + TP * LD, nb, c + static_cast<long>(c0) * d, pc, d, j0, vec);
    if (q == slices - 1 && tid < nb) {
      cp_async4(smem_addr(st + (TP + nb) * LD + tid), hc + (tid < pc ? c0 + tid : 0), tid < pc);
    }
  };
#pragma unroll
  for (int s = 0; s < kWideStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  const uint32_t a_off = repro::slice_a_addr(ring, 16 * warp) - smem_addr(ring);
  const uint32_t b_off = repro::slice_b_addr(ring + TP * LD) - smem_addr(ring);
  const int r_lo = 16 * warp + g, r_hi = r_lo + 8;   // this lane's points in the tile
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float sq[2] = {0.f, 0.f};
  float best_lo = -CUDART_INF_F, best_hi = -CUDART_INF_F;
  int arg_lo = 0, arg_hi = 0;
  float sse = 0.f;   // this warp's (every lane holds it)
  int ns = 0;        // the tile's segments

  // the sums of slice q's dims, xs a stage holding the tile's slice q:
  // each cluster's segment in point order, its values loaded 8 at a
  // time, then added in order
  auto add_slice = [&](const float* xs, int q) {
    const int j0 = q * repro::kSliceDepth;
    for (int item = tid; item < ns * 32; item += kThreads) {
      const int si = item >> 5, jj = item & 31;
      if (j0 + jj >= d) continue;
      const int s0 = seg[si], s1 = seg[si + 1];
      const long at = static_cast<long>(keys[s0] >> 7) * d + j0 + jj;
      float a = S[at];
      for (int i0 = s0; i0 < s1; i0 += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          v[u] = i0 + u < s1 ? xs[static_cast<int>(keys[i0 + u] & 127) * LD + jj] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (i0 + u < s1) a += v[u];
        }
      }
      S[at] = a;
    }
  };

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kWideStages - 2>();
    __syncthreads();  // slice s landed; every warp is done with slice s - 1
    const int it = s / per_tile, r = s - it * per_tile;
    // a tile's last assignment step keeps its slices in the ring for the
    // sums: the next issue waits for them
    const bool keep = in_ring && r == assign_steps - 1;
    if (!keep) {
      if (s + kWideStages - 1 < steps) issue(s + kWideStages - 1);
      cp_async_commit();
    }
    const float* stf = ring + (s % kWideStages) * stage_floats;

    if (r >= assign_steps) {
      add_slice(stf, r - assign_steps);
      continue;
    }

    const int pass = r / slices, q = r - pass * slices;
    const uint32_t st = smem_addr(stf);
    const int ksteps = min(4, (d - q * repro::kSliceDepth + 7) / 8);
    const int c0 = pass * PW;
    const int nt_active = (min(PW, k - c0) + 15) / 16 * 2;
    if (pass == 0) {
      repro::mma_slice_3xtf32<NT, true>(acc, st + a_off, st + b_off, ksteps, nt_active, sq);
    } else {
      repro::mma_slice_3xtf32<NT, false>(acc, st + a_off, st + b_off, ksteps, nt_active, sq);
    }
    if (q != slices - 1) continue;

    // the first strict maximum of the pass: a lane's clusters in order,
    // then its quad, lower index on ties; then the running one
    const float* hs = stf + (TP + nb) * LD;   // the pass's |c|^2 / 2
    float lb_lo = -CUDART_INF_F, lb_hi = -CUDART_INF_F;
    int la_lo = 0x7fffffff, la_hi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = 8 * j + 2 * t4 + e;
        if (c0 + cc < k) {
          const float h = hs[cc];
          const float v_lo = acc[j][e] - h, v_hi = acc[j][2 + e] - h;
          if (v_lo > lb_lo) {
            lb_lo = v_lo;
            la_lo = c0 + cc;
          }
          if (v_hi > lb_hi) {
            lb_hi = v_hi;
            la_hi = c0 + cc;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ob_lo = __shfl_xor_sync(0xffffffffu, lb_lo, off);
      const int oa_lo = __shfl_xor_sync(0xffffffffu, la_lo, off);
      const float ob_hi = __shfl_xor_sync(0xffffffffu, lb_hi, off);
      const int oa_hi = __shfl_xor_sync(0xffffffffu, la_hi, off);
      if (ob_lo > lb_lo || (ob_lo == lb_lo && oa_lo < la_lo)) {
        lb_lo = ob_lo;
        la_lo = oa_lo;
      }
      if (ob_hi > lb_hi || (ob_hi == lb_hi && oa_hi < la_hi)) {
        lb_hi = ob_hi;
        la_hi = oa_hi;
      }
    }
    if (lb_lo > best_lo) {  // strict: the earlier pass keeps a tie
      best_lo = lb_lo;
      arg_lo = la_lo;
    }
    if (lb_hi > best_hi) {
      best_hi = lb_hi;
      arg_hi = la_hi;
    }
    if (pass != passes - 1) continue;

    // ---- the tile is assigned: its sse terms, then the sort by cluster
    const long p0 = static_cast<long>(blockIdx.x + it * gridDim.x) * TP;
    const int pts = static_cast<int>(min(static_cast<long>(TP), n - p0));
    float q_lo = sq[0] + __shfl_xor_sync(0xffffffffu, sq[0], 1);
    q_lo += __shfl_xor_sync(0xffffffffu, q_lo, 2);
    float q_hi = sq[1] + __shfl_xor_sync(0xffffffffu, sq[1], 1);
    q_hi += __shfl_xor_sync(0xffffffffu, q_hi, 2);
    float e = 0.f;
    if (t4 == 0) {
      asg[r_lo] = r_lo < pts ? arg_lo : k;
      asg[r_hi] = r_hi < pts ? arg_hi : k;
      if (r_lo < pts) e += q_lo - 2.f * best_lo;
      if (r_hi < pts) e += q_hi - 2.f * best_hi;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(0xffffffffu, e, off);
    sse += e;
    sq[0] = sq[1] = 0.f;
    best_lo = best_hi = -CUDART_INF_F;
    arg_lo = arg_hi = 0;
    __syncthreads();  // asg is complete; the last tile's sums are done

    // stable sort by cluster: four runs of 32 keys, bitonic across lanes
    unsigned long long key = 0;
    if (tid < TP) {
      key = static_cast<unsigned long long>(asg[tid]) << 7 | static_cast<unsigned>(tid);
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, stride);
          const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
          key = keep_min ? (key < other ? key : other) : (key < other ? other : key);
        }
      }
      keys[tid] = key;
    }
    __syncthreads();
    int place = lane;
    if (tid < TP) {
#pragma unroll
      for (int o = 0; o < 4; ++o)
        if (o != warp) place += count_below(keys + 32 * o, 32, key);
    }
    __syncthreads();  // every run is read
    if (tid < TP) keys[place] = key;
    __syncthreads();
    // segment heads: the first key of each cluster
    bool head = false;
    unsigned heads = 0;
    if (tid < TP) {
      const int cl = static_cast<int>(keys[tid] >> 7);
      head = cl < k && (tid == 0 || static_cast<int>(keys[tid - 1] >> 7) != cl);
      heads = __ballot_sync(0xffffffffu, head);
      if (lane == 0) wseg[warp] = __popc(heads);
    }
    __syncthreads();
    if (tid < TP) {
      int at = __popc(heads & ((1u << lane) - 1));
      for (int o = 0; o < warp; ++o) at += wseg[o];
      if (head) seg[at] = tid;
      if (tid == 0) seg[wseg[0] + wseg[1] + wseg[2] + wseg[3]] = pts;
    }
    __syncthreads();
    ns = wseg[0] + wseg[1] + wseg[2] + wseg[3];
    for (int i = tid; i < ns; i += kThreads) {
      C[keys[seg[i]] >> 7] += seg[i + 1] - seg[i];
    }
    if (keep) {
      for (int q2 = 0; q2 < slices; ++q2) {
        add_slice(ring + ((s - slices + 1 + q2) % kWideStages) * stage_floats, q2);
      }
      __syncthreads();  // the slices are read before the ring refills
      if (s + kWideStages - 1 < steps) issue(s + kWideStages - 1);
      cp_async_commit();
    }
  }

  __syncthreads();
  if (shared_partials) {
    for (long i = tid; i < kd; i += kThreads) part_sums[blockIdx.x * kd + i] = S[i];
    for (int i = tid; i < k; i += kThreads) part_counts[static_cast<long>(blockIdx.x) * k + i] = C[i];
  }
  if (lane == 0) red[warp] = sse;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w];
    part_sse[blockIdx.x] = t;
  }
}

template <int MT, int NTW>
cudaError_t launch_partials(const float* x, const float* c, int n, int k, int d, int T,
                            int blocks, float* part_sums, int* part_counts, float* part_sse,
                            cudaStream_t s) {
  constexpr int KP = 16 * MT;
  const int stage_floats = (T * d + 12 + 3) / 4 * 4;  // 8 floats past the tile
  const size_t smem = (static_cast<size_t>(kStages) * stage_floats + KP + T + KP + kWarps) *
                          sizeof(float) +
                      static_cast<size_t>(MT) * ((d + 7) / 8) * 64 * sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(kmeans_tc_partials<MT, NTW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kmeans_tc_partials<MT, NTW><<<blocks, kThreads, smem, s>>>(
      x, c, n, k, d, T, stage_floats, part_sums, part_counts, part_sse);
  return cudaGetLastError();
}

template <int MT>
cudaError_t dispatch_d(const float* x, const float* c, int n, int k, int d, int T, int blocks,
                       float* ps, int* pc, float* pe, cudaStream_t s) {
  const int ntw = ((d + 7) / 8 + kWarps - 1) / kWarps;
  if (ntw <= 1) return launch_partials<MT, 1>(x, c, n, k, d, T, blocks, ps, pc, pe, s);
  if (ntw <= 2) return launch_partials<MT, 2>(x, c, n, k, d, T, blocks, ps, pc, pe, s);
  if (ntw <= 4) return launch_partials<MT, 4>(x, c, n, k, d, T, blocks, ps, pc, pe, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// `blocks` persistent blocks of tiles of T points (T a multiple of 32, at
// most 256); part_* hold blocks x (k*d, k, 1) scratch.  1 <= k <= 64,
// 1 <= d <= 256.  Returns a cudaError_t.
extern "C" int kmeans_assign_launch(const float* x, const float* c, int n, int k, int d, int T,
                                    int blocks, float* part_sums, int* part_counts,
                                    float* part_sse, float* sums, int* counts, float* sse,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 64 || d < 1 || d > 256 || T < 32 || T > kThreads || T % 32) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (k <= 16) {
    err = dispatch_d<1>(x, c, n, k, d, T, blocks, part_sums, part_counts, part_sse, s);
  } else if (k <= 32) {
    err = dispatch_d<2>(x, c, n, k, d, T, blocks, part_sums, part_counts, part_sse, s);
  } else {
    err = dispatch_d<4>(x, c, n, k, d, T, blocks, part_sums, part_counts, part_sse, s);
  }
  if (err != cudaSuccess) return err;
  const int outputs = k * d + k + 1;
  kmeans_reduce_blocks<<<(outputs + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      part_sums, part_counts, part_sse, blocks, k, d, sums, counts, sse);
  return cudaGetLastError();
}

// The wide route: any k >= 1 and d >= 1.  `blocks` persistent blocks of
// tiles of 128 points; `vec` floats per copy (4, 2 or 1; d % vec == 0, x
// and c 4 vec bytes aligned); shared_partials: the partials live in the
// block's shared memory (smem bytes in all).  Scratch: hc k floats, part_*
// blocks x (k*d, k, 1).  Returns a cudaError_t.
extern "C" int kmeans_wide_launch(const float* x, const float* c, int n, int k, int d, int vec,
                                  int blocks, int shared_partials, int smem, float* hc,
                                  float* part_sums, int* part_counts, float* part_sse,
                                  float* sums, int* counts, float* sse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 1 || d < 1 || blocks < 1 || (vec != 1 && vec != 2 && vec != 4) ||
      d % vec != 0 || static_cast<long>(blocks - 1) * kWidePoints >= n) {
    return cudaErrorInvalidValue;
  }
  half_sqnorms<<<(k + 255) / 256, 256, 0, s>>>(c, k, d, hc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto run = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<blocks, kThreads, smem, s>>>(x, c, hc, n, k, d, vec, shared_partials, part_sums,
                                          part_counts, part_sse);
    return cudaGetLastError();
  };
  switch (k >= 128 ? 16 : (k + 15) / 16 * 2) {   // a pass's n8 tiles
    case 2: err = run(kmeans_wide_partials<2>); break;
    case 4: err = run(kmeans_wide_partials<4>); break;
    case 6: err = run(kmeans_wide_partials<6>); break;
    case 8: err = run(kmeans_wide_partials<8>); break;
    case 10: err = run(kmeans_wide_partials<10>); break;
    case 12: err = run(kmeans_wide_partials<12>); break;
    case 14: err = run(kmeans_wide_partials<14>); break;
    default: err = run(kmeans_wide_partials<16>); break;
  }
  if (err != cudaSuccess) return err;
  const long outputs = static_cast<long>(k) * d + k + 1;
  kmeans_reduce_blocks<<<static_cast<unsigned>((outputs + kWarps - 1) / kWarps), kThreads, 0, s>>>(
      part_sums, part_counts, part_sse, blocks, k, d, sums, counts, sse);
  return cudaGetLastError();
}
