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
//  * kernel 1 (kmeans_wide_assign): a block owns 64 points and walks the
//    centroids in tiles of 64, each tile's scores x.c formed by fp32 FMAs
//    in depth order over 16-deep slices of points and centroids staged
//    in shared memory (repro::dot_tile: 8.8 KB whatever k and d are).  A
//    thread keeps the first strict maximum of x.c - |c|^2/2 over its 4
//    clusters in order, its 16 lanes merge by shuffles (lower index on
//    ties), and a later tile replaces the running best only when strictly
//    greater.  It writes each point's cluster and |x|^2 - 2 best.
//  * kernel 2 (kmeans_wide_sums): the points are cut into S contiguous
//    splits; thread (split, dim) adds its split's points in order into
//    its own (cluster, dim) partials, and one thread per split counts (in
//    integers) and adds the sse terms in order.  No atomics.
//  * kmeans_reduce_blocks merges the S partials as above (split order per
//    lane, then a fixed shuffle tree), so two launches are bitwise equal.
// Scratch: 8 bytes per point, and S x (k*d + k + 1) partials with S chosen
// from k*d so that they stay within 2^22 floats (16 MiB); where k*d + k + 1
// alone exceeds that, S = 1, one partial the size of the outputs.
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

// Kernel 1: 64 points per block against every centroid, 64 at a time.
__global__ void __launch_bounds__(repro::kDotThreads)
kmeans_wide_assign(const float* __restrict__ x, const float* __restrict__ c, int n, int k,
                   int d, int* __restrict__ asg, float* __restrict__ err) {
  __shared__ repro::DotTileSmem s;
  __shared__ float xsq[repro::kDotRows];
  const int t = threadIdx.x;
  const int tr = t >> 4, tc = t & 15;
  const long p0 = static_cast<long>(blockIdx.x) * repro::kDotRows;
  const int rows = static_cast<int>(min(static_cast<long>(repro::kDotRows), n - p0));
  float best[4];
  int arg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = -CUDART_INF_F;
    arg[i] = 0;
  }
  for (int c0 = 0; c0 < k; c0 += repro::kDotRows) {
    float acc[4][4];
    repro::dot_tile(x + p0 * d, rows, c + static_cast<long>(c0) * d,
                    min(repro::kDotRows, k - c0), d, s, acc);
    if (c0 == 0 && t < repro::kDotRows) xsq[t] = s.asq[t];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // the thread's clusters in order, then its 16 lanes, lower index on ties
      float lb = -CUDART_INF_F;
      int la = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = c0 + tc + 16 * j;
        const float v = acc[i][j] - 0.5f * s.bsq[tc + 16 * j];
        if (cl < k && v > lb) {
          lb = v;
          la = cl;
        }
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, lb, off);
        const int oa = __shfl_xor_sync(0xffffffffu, la, off);
        if (ob > lb || (ob == lb && oa < la)) {
          lb = ob;
          la = oa;
        }
      }
      if (lb > best[i]) {  // strict: the earlier tile keeps a tie
        best[i] = lb;
        arg[i] = la;
      }
    }
  }
  __syncthreads();  // xsq is complete
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      if (r < rows) {
        asg[p0 + r] = arg[i];
        err[p0 + r] = xsq[r] - 2.f * best[i];
      }
    }
  }
}

// Kernel 2: thread (split, dim j) adds the split's points in order into
// the split's (cluster, j) partials; thread 0 of column block 0 counts and
// adds the split's sse terms in order.
__global__ void kmeans_wide_sums(const float* __restrict__ x, const int* __restrict__ asg,
                                 const float* __restrict__ err, int n, int k, int d, int chunk,
                                 float* __restrict__ part_sums, int* __restrict__ part_counts,
                                 float* __restrict__ part_sse) {
  const int split = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  const long p_begin = static_cast<long>(split) * chunk;
  const long p_end = min(static_cast<long>(n), p_begin + chunk);
  if (j < d) {
    float* ps = part_sums + static_cast<long>(split) * k * d + j;
    for (int cl = 0; cl < k; ++cl) ps[static_cast<long>(cl) * d] = 0.f;
    for (long p = p_begin; p < p_end; ++p) ps[static_cast<long>(asg[p]) * d] += x[p * d + j];
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    int* pc = part_counts + static_cast<long>(split) * k;
    for (int cl = 0; cl < k; ++cl) pc[cl] = 0;
    float e = 0.f;
    for (long p = p_begin; p < p_end; ++p) {
      pc[asg[p]] += 1;
      e += err[p];
    }
    part_sse[split] = e;
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

// The wide route: any k >= 1 and d >= 1.  asg / err hold n ints / floats
// of scratch, part_* splits x (k*d, k, 1); each split is `chunk`
// contiguous points (the last may be short).  Returns a cudaError_t.
extern "C" int kmeans_wide_launch(const float* x, const float* c, int n, int k, int d,
                                  int splits, int chunk, int* asg, float* err, float* part_sums,
                                  int* part_counts, float* part_sse, float* sums, int* counts,
                                  float* sse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 1 || d < 1 || splits < 1 || chunk < 1 ||
      static_cast<long>(splits) * chunk < n) {
    return cudaErrorInvalidValue;
  }
  kmeans_wide_assign<<<(n + repro::kDotRows - 1) / repro::kDotRows, repro::kDotThreads, 0, s>>>(
      x, c, n, k, d, asg, err);
  cudaError_t err_ = cudaGetLastError();
  if (err_ != cudaSuccess) return err_;
  const int cols = d < 128 ? (d + 31) / 32 * 32 : 128;  // dims per block of kernel 2
  kmeans_wide_sums<<<dim3(splits, (d + cols - 1) / cols), cols, 0, s>>>(
      x, asg, err, n, k, d, chunk, part_sums, part_counts, part_sse);
  err_ = cudaGetLastError();
  if (err_ != cudaSuccess) return err_;
  const long outputs = static_cast<long>(k) * d + k + 1;
  kmeans_reduce_blocks<<<static_cast<unsigned>((outputs + kWarps - 1) / kWarps), kThreads, 0, s>>>(
      part_sums, part_counts, part_sse, splits, k, d, sums, counts, sse);
  return cudaGetLastError();
}
