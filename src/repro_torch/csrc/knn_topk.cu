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
// cross term on m*d + n*d floats, e.g. m 12,700, n 76,800, d 50 (one
// KNN_frag task of the bulk benchmark): 9.8e10 flops against 16 MB (5 us
// at 3.35 TB/s).  On the fp32 CUDA cores (67 TFLOP/s) that is 1.46 ms.
// This kernel runs the cross term on the tensor cores in 3xTF32, three
// TF32 products per pair, whose least time is 3 * 2mnd / 495 TFLOP/s =
// 0.591 ms.
//
// Why 3xTF32.  A TF32 operand keeps 10 of fp32's 23 mantissa bits, so a
// single TF32 product is off by ~1e-3 relative: at d 50 a distance moves
// by ~0.03, far outside the rtol 1e-5 / atol 1e-3 it is held to.  Each
// value is split as hi = tf32(v) and lo = tf32(v - hi) (rounded to
// nearest, ties away, as `cvt.rna` rounds; v - hi is exact in fp32) and
// x.y is taken as x_lo y_hi + x_hi y_lo + x_hi y_hi with fp32
// accumulation, each 8-deep step's three products in a fresh accumulator
// added to the running one in fp32 in step order (the tensor cores cut
// their adds toward zero, so a carried accumulator drifts; see
// repro::mma_3xtf32); what it drops, x_lo y_lo, is ~2^-22 of |x||y|.
// Integer values in [-3, 3] are exact in TF32 (lo = 0), so integer-valued
// inputs keep their exact distances.  tests/test_torch_kernels.py
// emulates both roundings on the CPU.
//
// The tensor-core route (k <= 32, d <= 64): knn_chunk_topk<KS>, KS =
// ceil(d / 8) steps of depth, one persistent block of 512 threads per SM,
// four warpgroups with one role each.
//
// * Work.  The test rows are cut into slabs of 128, the training rows
//   into tiles of 64; a work unit is (slab, tile), and the slab-major list
//   of all units is cut into one contiguous run per block (gridDim.x =
//   min(SMs, units)), so every block does the same number of units to
//   within one.  A run covers whole slabs and parts of at most two more:
//   each maximal piece of it on one slab is a segment, which leaves a list
//   of k keys per test row in `part` at index blockIdx.x + slab (unique:
//   along the list, block and slab never decrease and one of them rises at
//   each new segment).  knn_topk.partition mirrors this.  A 12,700-row
//   call is 100 slabs x 1,200 tiles over 132 blocks, 909 or 910 units
//   each, where one wave of the pre-Hopper grid filled 75.8% of its slots.
// * Producer (warpgroup 2, 56 registers).  Its first thread copies each
//   tile's 64 rows with one bulk copy (cp.async.bulk, completion counted
//   on an mbarrier) into a ring of 3 raw stages: TMA tensor maps need
//   16-byte row strides, which d 50 does not have, but a tile's rows are
//   contiguous, so one copy takes them all (the at most 3 floats before
//   the first 16-byte boundary and after the last go by plain loads); the
//   tile's |y|^2 (a row_sqnorms pre-pass) rides along.  All 128 threads
//   then split the tile once into TF32 hi and lo planes in wgmma's K-major
//   layout without swizzle (8 x 4 core matrices of 128 bytes, 256 bytes
//   between groups of 8 rows, 2 KB per 8-deep step, zero past d and past
//   n; |y|^2 NaN past n), into a ring of 3 split stages (full / empty
//   mbarriers).  The split loop stays rolled: unrolled, 56 registers spill.
// * Consumers (warpgroups 0, 1, 192 registers).  Each owns 64 test rows of
//   the slab, whose hi and lo fragments it splits once per segment into
//   registers (wgmma's A from registers: 8 KS of them).  Per tile and
//   8-deep step, six wgmma.m64n32k8 as one group: the three products
//   x_lo y_hi, x_hi y_lo, x_hi y_hi of each half tile of 32 columns into
//   fresh step accumulators; two steps in flight, each added to the
//   running sum in fp32 in step order once awaited (the tensor cores cut
//   their adds toward zero, so a carried accumulator drifts; see
//   repro::mma_3xtf32).  Then d2 = fmaf(-2, acc, |x|^2) + |y|^2 from the
//   accumulator registers, and each row's least.  A warp whose 16 rows'
//   least distances all miss the thresholds the selector publishes writes
//   nothing; otherwise it writes its rows' distances to its warpgroup's
//   distance tile (two per warpgroup where shared memory allows, else
//   one; dist_full / dist_empty mbarriers) and flags them.  A segment's
//   first tiles (one per distance tile) take every row: the thresholds
//   then may still be the last segment's.
// * Selector (warpgroup 3, 72 registers).  Thread st keeps test row st's
//   K best distances and training indices in registers (K = k for k <= 8,
//   16 up to 16), walking each flagged tile's row in training-index order,
//   8 columns behind one test of their least against the K-th, with the
//   pre-Hopper kernel's insertion (strict <: an equal distance never
//   displaces an earlier training row), and publishes the K-th as the
//   row's threshold.  For k 17..32 (lists too long for its registers) the
//   lists are in shared memory and the warp inserts its rows' candidates
//   together, one at a time (tc_select).  At a segment's end each row's
//   list goes to part as 64-bit keys, (order-preserving distance bits) <<
//   32 | training index: unique, and ordered as the tie rule orders them.
// * knn_merge_chunks<K> (K = 8, 16, 32 >= k) merges a row's segments'
//   lists in registers, whatever their order, and decodes keys into
//   distances and labels.
// Why four warpgroups.  Selection in the consumers stalled their whole
//   warpgroup's next wgmma whenever one warp had survivors (~k ln(n / k)
//   a row, most of them early in a segment), and the tensor cores idled;
//   the selector takes them off the multiplying warps, and the flags keep
//   it to the tiles that can change a list.  Why rings of steps and halves
//   rather than deeper ones: a consumer holds 32 sums, 2 x 2 x 16 step
//   accumulators and 8 KS A registers (about 188 at KS 7), within its 192;
//   at 176 ptxas serialises the wgmmas.  Registers are moved by setmaxnreg
//   within the 512 x 128 the block is given (256 x 192 + 128 x (56 + 72)).
// Budgets: shared memory 3 split stages (4 KS KB + 256 B each), 3 raw
//   stages (256 d + 272 B each), 2 or 4 distance tiles of 64 x 68 floats,
//   the kb = 32 lists (2 x 128 x 33 words), thresholds, flags and 17
//   mbarriers: 205,560 bytes at d 50, k 5; 218,360 at d 64, k 32 (one
//   tile per warpgroup), within 232,448.  The build check refuses any
//   spill (chip_smoke.py).  Scratch: |x|^2, |y|^2 (m + n floats, n rounded
//   up to a tile) and (blocks + slabs - 1) x 128 x k keys.  No float
//   atomics: two launches are bitwise equal.
//
// The wide route (knn_wide_launch) takes every other k <= n and d; the
// wrapper picks the route by shape before launch (knn_topk.route) and
// neither hands work to the other.  It keeps the fusion — no distance
// matrix in device memory, one wave of resident blocks over `splits`
// chunks of training rows, then a merge of the splits in split order —
// and changes what grows with d and k:
//  * depth: a block of 8 warps multiplies its 128 test rows by tiles of
//    128 training rows in 3xTF32 on the tensor cores, both operands
//    streamed in 32-deep slices through a ring of three shared stages
//    (repro::issue_slice / mma_slice_3xtf32), fp32 accumulators in
//    registers across the whole depth: shared memory does not grow with d.
//  * k: each test row keeps its k best as sorted 64-bit keys, as above.  A
//    row's k-th distance sits in a register as its threshold; a distance
//    at or below it is appended to the row's buffer of 32 keys in shared
//    memory, and buffers are merged into the lists by one lane per row
//    (insert_keys), 16 rows side by side.  The lists are in shared memory
//    where k x 128 keys fit beside the ring (k <= 85), else in global
//    scratch, which stays in L2.
//  * knn_wide_merge merges the splits' lists per row (a warp per row) and
//    decodes keys into distances and labels.
// Scratch: |x|^2 and |y|^2 (m + n floats), splits x m x k keys, and 2 x m
// x k keys for the merge.  Integer-valued inputs give exact distances, so
// the result equals the plain version's bit for bit; two launches are
// bitwise equal (no float atomics; the buffers' order is undone by the
// merges).
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace {

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

// |y|^2 of every row of a row-major (n, d) matrix, summed in column order.
__global__ void row_sqnorms(const float* __restrict__ x, int n, int d,
                            float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* row = x + static_cast<long>(i) * d;
  float s = 0.f;
  for (int j = 0; j < d; ++j) s = fmaf(row[j], row[j], s);
  out[i] = s;
}

// ---------------------------------------------- tensor-core route (Hopper)

constexpr int kTcRows = 128;      // test rows of a slab: two consumer warpgroups x 64
constexpr int kTcTile = 64;       // training rows of a tile
constexpr int kTcHalf = 32;       // the columns of one wgmma: a tile is two halves
constexpr int kTcThreads = 512;   // warpgroups 0, 1 multiply; 2 produces; 3 selects
constexpr int kSplitStages = 3;   // split tiles ready for the consumers
constexpr int kRawStages = 3;     // bulk-copied tiles in flight
constexpr int kDistLD = kTcTile + 4;  // a distance tile's row stride in floats
constexpr int kStepBytes = kTcTile * 8 * 4;  // one 8-deep step of a TF32 plane: 2 KB
constexpr int kStepRing = 2;      // a consumer's steps in flight, one wgmma group each
// registers: the block is given 512 x 128 at launch, and setmaxnreg moves
// them between warpgroups
constexpr int kConsumerRegs = 192, kProducerRegs = 56, kSelectorRegs = 72;
static_assert(256 * kConsumerRegs + 128 * (kProducerRegs + kSelectorRegs) <= 512 * 128,
              "setmaxnreg pool");
constexpr int kBarProducer = 1;    // the producer warpgroup's named barrier

// Byte offsets of the block's shared memory: the split stages (hi plane,
// lo plane, the tile's |y|^2), the raw stages (the rows as copied, 16
// bytes of room for their misalignment, |y|^2), the two consumer
// warpgroups' distance tiles (64 x kDistLD floats each), the selector's
// lists (distances, then training indices: kb + 1 a row, the + 1 keeping
// a warp's rows on distinct banks), the rows' thresholds (published by
// the selector), a flag per consumer warp and distance tile (its rows'
// distances were written) and the mbarriers: raw, full, empty (per stage),
// dist_full, dist_empty (per distance tile).
struct TcLayout {
  int dist_bufs, split_stage, raw_stage, raw, dist, lists, thr, flags, bars, total;
};
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may have
__host__ __device__ inline TcLayout tc_layout(int ks, int d, int kb) {
  TcLayout l;
  l.split_stage = 2 * ks * kStepBytes + kTcTile * 4;
  l.raw_stage = (kTcTile * d * 4 + 16 + 15) / 16 * 16 + kTcTile * 4;
  l.raw = kSplitStages * l.split_stage;
  l.dist = l.raw + kRawStages * l.raw_stage;
  for (l.dist_bufs = 2;; --l.dist_bufs) {  // two distance tiles a warpgroup where they fit
    l.lists = l.dist + 2 * l.dist_bufs * 64 * kDistLD * 4;
    l.thr = l.lists + 2 * kTcRows * (kb + 1) * 4;
    l.flags = l.thr + kTcRows * 4;
    l.bars = l.flags + 2 * 2 * 4 * 4;
    l.total = l.bars + (kRawStages + 2 * kSplitStages + 2 * 2 * 2) * 8;
    if (l.total <= kSmemLimit || l.dist_bufs == 1) return l;
  }
}

// The awaited step accumulator s into the running sum a, in fp32.
template <bool FIRST, int OFF>
__device__ __forceinline__ void add_step(float (&a)[32], float (&s)[16]) {
  repro::fence_regs(s);
#pragma unroll
  for (int e = 0; e < 16; ++e) a[OFF + e] = FIRST ? s[e] : a[OFF + e] + s[e];
}

// Step S of a tile, both halves' three products into the fresh step
// accumulators b[S % kStepRing], as one wgmma group.
template <int KS, int S>
__device__ __forceinline__ void issue_step(float (&b)[kStepRing][2][16],
                                           const uint32_t (&ah)[KS][4],
                                           const uint32_t (&al)[KS][4], uint64_t dh,
                                           uint64_t dl) {
  constexpr uint64_t off = S * (kStepBytes >> 4);
  constexpr uint64_t half = kTcHalf / 8 * 256 >> 4;  // 4 groups of 8 rows
  float (&s0)[16] = b[S % kStepRing][0];
  float (&s1)[16] = b[S % kStepRing][1];
  repro::fence_regs(s0);
  repro::fence_regs(s1);
  repro::wgmma_fence();
  repro::wgmma_m64n32k8_tf32<0>(s0, al[S], dh + off);         // x_lo y_hi
  repro::wgmma_m64n32k8_tf32<0>(s1, al[S], dh + off + half);
  repro::wgmma_m64n32k8_tf32<1>(s0, ah[S], dl + off);         // + x_hi y_lo
  repro::wgmma_m64n32k8_tf32<1>(s1, ah[S], dl + off + half);
  repro::wgmma_m64n32k8_tf32<1>(s0, ah[S], dh + off);         // + x_hi y_hi
  repro::wgmma_m64n32k8_tf32<1>(s1, ah[S], dh + off + half);
  repro::wgmma_commit();
}
template <int KS, int S>
__device__ __forceinline__ void start_steps(float (&b)[kStepRing][2][16],
                                            const uint32_t (&ah)[KS][4],
                                            const uint32_t (&al)[KS][4], uint64_t dh,
                                            uint64_t dl) {
  if constexpr (S < kStepRing && S < KS) {
    issue_step<KS, S>(b, ah, al, dh, dl);
    start_steps<KS, S + 1>(b, ah, al, dh, dl);
  }
}
// Step S awaited and added to the running sum in fp32, in step order;
// then step S + kStepRing goes out into the accumulators it leaves.
template <int KS, int S>
__device__ __forceinline__ void run_steps(float (&acc)[32], float (&b)[kStepRing][2][16],
                                          const uint32_t (&ah)[KS][4],
                                          const uint32_t (&al)[KS][4], uint64_t dh,
                                          uint64_t dl) {
  if constexpr (S < KS) {
    constexpr int pending = KS - S < kStepRing ? KS - S : kStepRing;
    repro::wgmma_wait<pending - 1>();
    add_step<S == 0, 0>(acc, b[S % kStepRing][0]);
    add_step<S == 0, 16>(acc, b[S % kStepRing][1]);
    if constexpr (S + kStepRing < KS) issue_step<KS, S + kStepRing>(b, ah, al, dh, dl);
    run_steps<KS, S + 1>(acc, b, ah, al, dh, dl);
  }
}

// The producer warpgroup: bulk copies of the block's tiles into the raw
// ring (thread 0 of the warpgroup), then the split of each into hi and lo
// planes in the split ring (all 128 threads).
template <int KS>
__device__ __forceinline__ void tc_produce(const float* __restrict__ train,
                                           const float* __restrict__ train_sq, int n, int d,
                                           int tiles, long long u0, int count,
                                           unsigned char* smem, const TcLayout& lay,
                                           uint32_t raw_full, uint32_t full, uint32_t empty) {
  const int ptid = static_cast<int>(threadIdx.x) - 2 * 128;
  const uint32_t sbase = repro::smem_addr(smem);
  constexpr int stages = kRawStages;
  // every tile starts 256 d bytes after the last: one misalignment
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(train) & 15);
  const int ysq_at = lay.raw_stage - kTcTile * 4;
  const bool pairs = d % 2 == 0 && off % 8 == 0;
  const int t_first = static_cast<int>(u0 % tiles);
  int t_issue = t_first;  // the next tile to copy
  auto issue = [&](int stage) {
    const int t = t_issue;
    t_issue = t + 1 == tiles ? 0 : t + 1;
    const uint32_t bar = raw_full + 8 * stage;
    const int at = lay.raw + stage * lay.raw_stage;
    const int rows = min(kTcTile, n - t * kTcTile);
    const uintptr_t a = reinterpret_cast<uintptr_t>(train + static_cast<long>(t) * kTcTile * d);
    const uintptr_t b = a + static_cast<uintptr_t>(rows) * d * 4;
    const uintptr_t a16 = (a + 15) & ~static_cast<uintptr_t>(15);
    const uintptr_t b16 = b & ~static_cast<uintptr_t>(15);
    unsigned char* dst = smem + at + off;
    // the at most 3 floats before the first 16-byte boundary and after the
    // last go by plain copies, before the arrival that releases them
    for (uintptr_t p = a; p < (a16 < b ? a16 : b); p += 4) {
      *reinterpret_cast<float*>(dst + (p - a)) = *reinterpret_cast<const float*>(p);
    }
    for (uintptr_t p = (a16 > b16 ? a16 : b16); p < b; p += 4) {
      *reinterpret_cast<float*>(dst + (p - a)) = *reinterpret_cast<const float*>(p);
    }
    const uint32_t body = a16 < b16 ? static_cast<uint32_t>(b16 - a16) : 0u;
    repro::mbar_arrive_expect_tx(bar, body + kTcTile * 4);
    if (body) {
      repro::bulk_copy_g2s(sbase + at + off + static_cast<uint32_t>(a16 - a),
                           reinterpret_cast<const void*>(a16), body, bar);
    }
    repro::bulk_copy_g2s(sbase + at + ysq_at, train_sq + static_cast<long>(t) * kTcTile,
                         kTcTile * 4, bar);
  };
  if (ptid == 0) {
    for (int i = 0; i < stages && i < count; ++i) issue(i);
  }
  int t = t_first, rs = 0, ss = 0;
  uint32_t raw_phase = 0, split_phase = 0;
  for (int i = 0; i < count; ++i) {
    const int rows = min(kTcTile, n - t * kTcTile);
    const unsigned char* rawp = smem + lay.raw + rs * lay.raw_stage;
    const float* raw = reinterpret_cast<const float*>(rawp + off);
    unsigned char* st = smem + ss * lay.split_stage;
    repro::mbar_wait(raw_full + 8 * rs, raw_phase);
    repro::mbar_wait(empty + 8 * ss, split_phase ^ 1);
    // thread ptid splits row r = ptid % 64, depths 4 c4 .. 4 c4 + 3 for c4
    // = ptid / 64 + 2 q: 8 lanes write one 128-byte core matrix, a warp four
    {
      const int r = ptid & (kTcTile - 1);
      const float* row = raw + r * d;
      const bool live = r < rows;
#pragma unroll 1  // unrolled, the producer's 56 registers spill
      for (int q = 0; q < KS; ++q) {
        const int c4 = (ptid >> 6) + 2 * q, c = 4 * c4;
        float v[4];
        if (pairs) {  // d even and the rows 8-byte aligned: two 8-byte loads
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 p2 = (live && c + 2 * h < d)
                                  ? *reinterpret_cast<const float2*>(row + c + 2 * h)
                                  : make_float2(0.f, 0.f);
            v[2 * h] = p2.x;
            v[2 * h + 1] = p2.y;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = (live && c + j < d) ? row[c + j] : 0.f;
        }
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) repro::split_tf32(v[j], hi[j], lo[j]);
        const int at = (c4 >> 1) * kStepBytes + (r >> 3) * 256 + (c4 & 1) * 128 + (r & 7) * 16;
        *reinterpret_cast<uint4*>(st + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(st + KS * kStepBytes + at) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    if (ptid < kTcTile) {  // |y|^2, NaN past n: such a column is never the least, never passes
      reinterpret_cast<float*>(st + 2 * KS * kStepBytes)[ptid] =
          ptid < rows ? reinterpret_cast<const float*>(rawp + ysq_at)[ptid]
                      : __int_as_float(0x7fffffff);
    }
    repro::fence_proxy_async_shared();  // the planes are read by wgmma
    repro::mbar_arrive(full + 8 * ss);
    repro::named_bar_sync(kBarProducer, 128);  // raw stage rs is read
    if (ptid == 0 && i + stages < count) issue(rs);
    t = t + 1 == tiles ? 0 : t + 1;
    if (++rs == stages) {
      rs = 0;
      raw_phase ^= 1;
    }
    if (++ss == kSplitStages) {
      ss = 0;
      split_phase ^= 1;
    }
  }
}

// A consumer warpgroup (wg 0 or 1): its 64 rows of each slab against every
// tile of the block's run; each tile's distances go to the selector.
template <int KS>
__device__ __forceinline__ void tc_consume(const float* __restrict__ test,
                                           const float* __restrict__ test_sq, int m, int d,
                                           int tiles, long long u0, long long u1,
                                           unsigned char* smem, const TcLayout& lay,
                                           uint32_t full, uint32_t empty, uint32_t dist_full,
                                           uint32_t dist_empty) {
  // warp-uniform to the compiler (a shuffle's result), so that the wgmma
  // pipeline below is not seen as divergent and serialised
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 7, 0);
  const int wq = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int nb = lay.dist_bufs;
  float* out0 = reinterpret_cast<float*>(smem + lay.dist) +
                (wg * nb * 64 + 16 * wq + g) * kDistLD + 2 * t4;
  const volatile float* thr = reinterpret_cast<const float*>(smem + lay.thr) + wg * 64 + 16 * wq + g;
  volatile int* flag_out = reinterpret_cast<int*>(smem + lay.flags) + wg * 8 + wq;
  dist_full += 16 * wg;
  dist_empty += 16 * wg;

  float acc[32], ring[kStepRing][2][16];
#pragma unroll
  for (int b = 0; b < kStepRing; ++b)
#pragma unroll
    for (int e = 0; e < 16; ++e) ring[b][0][e] = ring[b][1][e] = 0.f;
  uint32_t ah[KS][4], al[KS][4];
  int ss = 0, db = 0;
  uint32_t phase = 0, dphase = 0;
  for (long long u = u0; u < u1;) {
    const int slab = static_cast<int>(u / tiles);
    const long long seg_end = min(u1, static_cast<long long>(slab + 1) * tiles);
    const int r_lo = slab * kTcRows + 64 * wg + 16 * wq + g, r_hi = r_lo + 8;
    const bool active = slab * kTcRows + 64 * wg < m;  // the warpgroup has rows here
    // A: element e of step s is row (e & 1 ? hi : lo), column 8 s + t4 + 4 (e >> 1)
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e & 1) ? r_hi : r_lo, col = 8 * s + t4 + 4 * (e >> 1);
        const float v = (row < m && col < d) ? test[static_cast<long>(row) * d + col] : 0.f;
        repro::split_tf32(v, ah[s][e], al[s][e]);
      }
    }
    const float xsq_lo = r_lo < m ? test_sq[r_lo] : 0.f;
    const float xsq_hi = r_hi < m ? test_sq[r_hi] : 0.f;
    const long long seg_first = u;

    for (; u < seg_end; ++u) {
      const unsigned char* stg = smem + ss * lay.split_stage;
      repro::mbar_wait(full + 8 * ss, phase);
      float least_lo = CUDART_INF_F, least_hi = CUDART_INF_F;
      if (active) {
        // the cross terms, step by step: both halves' three products in
        // fresh step accumulators, added to the running sum in fp32 in step
        // order, kStepRing steps in flight
        const uint32_t hb = repro::smem_addr(stg);
        const uint64_t dh = repro::gmma_desc_kmajor(hb, 128, 256);
        const uint64_t dl = repro::gmma_desc_kmajor(hb + KS * kStepBytes, 128, 256);
        start_steps<KS, 0>(ring, ah, al, dh, dl);
        run_steps<KS, 0>(acc, ring, ah, al, dh, dl);
        // the distances (a column past n has a NaN |y|^2)
        const float* yt = reinterpret_cast<const float*>(stg + 2 * KS * kStepBytes);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 y = *reinterpret_cast<const float2*>(yt + 8 * j + 2 * t4);
          acc[4 * j] = fmaf(-2.f, acc[4 * j], xsq_lo) + y.x;
          acc[4 * j + 1] = fmaf(-2.f, acc[4 * j + 1], xsq_lo) + y.y;
          acc[4 * j + 2] = fmaf(-2.f, acc[4 * j + 2], xsq_hi) + y.x;
          acc[4 * j + 3] = fmaf(-2.f, acc[4 * j + 3], xsq_hi) + y.y;
          least_lo = fminf(least_lo, fminf(acc[4 * j], acc[4 * j + 1]));
          least_hi = fminf(least_hi, fminf(acc[4 * j + 2], acc[4 * j + 3]));
        }
      }
      __syncwarp();
      if (lane == 0) repro::mbar_arrive(empty + 8 * ss);  // the stage is read
      if (++ss == kSplitStages) {
        ss = 0;
        phase ^= 1;
      }
      if (active) {
        // the tile to the selector (row r of it at r * kDistLD), once it has
        // taken the last: then the thresholds it publishes are this
        // segment's (a segment's first tile takes every row).  A warp whose
        // rows' least distances all miss their thresholds writes nothing
        repro::mbar_wait(dist_empty + 8 * db, dphase ^ 1);
        const bool first = u < seg_first + nb;
        const float t_lo = first ? CUDART_INF_F : thr[0];
        const float t_hi = first ? CUDART_INF_F : thr[8];
        const bool flag = __any_sync(0xffffffffu, (r_lo < m && least_lo < t_lo) ||
                                                      (r_hi < m && least_hi < t_hi));
        if (flag) {
          float* out = out0 + db * 64 * kDistLD;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
            *reinterpret_cast<float2*>(out + 8 * kDistLD + 8 * j) =
                make_float2(acc[4 * j + 2], acc[4 * j + 3]);
          }
        }
        __syncwarp();
        if (lane == 0) {
          flag_out[4 * db] = flag;
          repro::mbar_arrive(dist_full + 8 * db);
        }
        if (++db == nb) {
          db = 0;
          dphase ^= 1;
        }
      }
    }
  }
}

// Insert (dv, lv) into the ascending list bd[0..K): it goes before the
// first entry it is strictly smaller than, the last entry falls off.
// Fully unrolled so the lists stay in registers.
template <int K>
__device__ __forceinline__ void insert_sorted(float (&bd)[K], int (&bl)[K], float dv, int lv) {
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

// The selector warpgroup for k <= 16: thread st keeps the K best of test
// row st of the slab in registers (K = k for k <= 8, so that its test is
// against the k-th; else 16), walking each distance tile its consumer warp
// flagged, in training-index order, 8 columns behind one test of their
// least against the K-th, inserting with a strict < (an equal distance
// never displaces an earlier training row), and publishes the K-th for
// the consumers' test.  At a segment's end the first k go to part as keys.
template <int K>
__device__ __forceinline__ void tc_select_regs(int m, int k, int tiles, long long u0,
                                               long long u1, unsigned char* smem,
                                               const TcLayout& lay, uint32_t dist_full,
                                               uint32_t dist_empty,
                                               unsigned long long* __restrict__ part) {
  const int st = static_cast<int>(threadIdx.x) - 3 * 128;
  const int wgc = st >> 6;  // the consumer warpgroup whose rows these are
  const int lane = threadIdx.x & 31;
  const int nb = lay.dist_bufs;
  const float* row0 = reinterpret_cast<const float*>(smem + lay.dist) +
                      (wgc * nb * 64 + (st & 63)) * kDistLD;
  volatile float* thr_out = reinterpret_cast<float*>(smem + lay.thr) + st;
  const volatile int* flag = reinterpret_cast<const int*>(smem + lay.flags) + wgc * 8 + ((st & 63) >> 4);
  dist_full += 16 * wgc;
  dist_empty += 16 * wgc;
  int db = 0;
  uint32_t dphase = 0;
  float bd[K];
  int bl[K];
  for (long long u = u0; u < u1;) {
    const int slab = static_cast<int>(u / tiles);
    const long long seg_end = min(u1, static_cast<long long>(slab + 1) * tiles);
    const bool active = slab * kTcRows + 64 * wgc < m;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      bd[i] = CUDART_INF_F;
      bl[i] = -1;
    }
    int c0 = static_cast<int>(u - static_cast<long long>(slab) * tiles) * kTcTile;
    for (; u < seg_end; ++u, c0 += kTcTile) {
      if (!active) continue;
      repro::mbar_wait(dist_full + 8 * db, dphase);
      const float* row = row0 + db * 64 * kDistLD;
      if (flag[4 * db]) {
#pragma unroll 2
        for (int c = 0; c < kTcTile; c += 8) {
          const float4 a = *reinterpret_cast<const float4*>(row + c);
          const float4 b = *reinterpret_cast<const float4*>(row + c + 4);
          const float dist[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
          // fminf passes over a NaN (a column past n): it never enters
          const float least = fminf(fminf(fminf(a.x, a.y), fminf(a.z, a.w)),
                                    fminf(fminf(b.x, b.y), fminf(b.z, b.w)));
          if (least < bd[K - 1]) {
#pragma unroll
            for (int v = 0; v < 8; ++v) {
              if (dist[v] < bd[K - 1]) insert_sorted<K>(bd, bl, dist[v], c0 + c + v);
            }
          }
        }
      }
      *thr_out = bd[K - 1];
      __syncwarp();
      if (lane == 0) repro::mbar_arrive(dist_empty + 8 * db);
      if (++db == nb) {
        db = 0;
        dphase ^= 1;
      }
    }
    const int r = slab * kTcRows + st;
    if (r < m) {
      unsigned long long* out = part + (static_cast<long>(blockIdx.x + slab) * kTcRows + st) * k;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (i < k) out[i] = bl[i] < 0 ? kNone : make_key(bd[i], bl[i]);
      }
    }
  }
}

// The selector warpgroup for kb = 32 (lists too long for its registers):
// thread st keeps the k best of test row st of
// the slab.  It walks each distance tile's row in training-index order, 8
// columns behind one test of their least against the row's kb-th distance
// (kb = 8, 16 or 32 >= k, in a register); the warp then inserts its rows'
// candidates one at a time, lowest row and column first, into their lists
// in shared memory, all 32 lanes at once (lane i holds entry i): a
// candidate goes after every entry it does not undercut (strict <: an
// equal distance never displaces an earlier training row), the rest move
// up one, the last falls off, and the row's owner takes the new kb-th
// distance.  At a segment's end each list goes to part as keys.
__device__ __forceinline__ void tc_select(int m, int k, int kb, int tiles, long long u0,
                                          long long u1, unsigned char* smem,
                                          const TcLayout& lay, uint32_t dist_full,
                                          uint32_t dist_empty,
                                          unsigned long long* __restrict__ part) {
  const int st = static_cast<int>(threadIdx.x) - 3 * 128;
  const int wgc = st >> 6;  // the consumer warpgroup whose rows these are
  const int lane = threadIdx.x & 31;
  const int nb = lay.dist_bufs;
  const float* row0 = reinterpret_cast<const float*>(smem + lay.dist) +
                      (wgc * nb * 64 + (st & 63)) * kDistLD;
  volatile float* thr_out = reinterpret_cast<float*>(smem + lay.thr) + st;
  const volatile int* flag = reinterpret_cast<const int*>(smem + lay.flags) + wgc * 8 + ((st & 63) >> 4);
  // the warp's lists: row r (of its 32) at r * (kb + 1)
  float* wld = reinterpret_cast<float*>(smem + lay.lists) + (st - lane) * (kb + 1);
  int* wli = reinterpret_cast<int*>(smem + lay.lists) + (kTcRows + st - lane) * (kb + 1);
  dist_full += 16 * wgc;
  dist_empty += 16 * wgc;
  int db = 0;
  uint32_t dphase = 0;
  for (long long u = u0; u < u1;) {
    const int slab = static_cast<int>(u / tiles);
    const long long seg_end = min(u1, static_cast<long long>(slab + 1) * tiles);
    const bool active = slab * kTcRows + 64 * wgc < m;
    for (int i = 0; i < kb; ++i) {
      wld[lane * (kb + 1) + i] = CUDART_INF_F;
      wli[lane * (kb + 1) + i] = -1;
    }
    __syncwarp();
    float thr = CUDART_INF_F;  // this thread's row's kb-th distance
    int c0 = static_cast<int>(u - static_cast<long long>(slab) * tiles) * kTcTile;
    for (; u < seg_end; ++u, c0 += kTcTile) {
      if (!active) continue;
      repro::mbar_wait(dist_full + 8 * db, dphase);
      const float* row = row0 + db * 64 * kDistLD;
      const bool walk = flag[4 * db];  // this row's consumer warp wrote its distances
#pragma unroll 2
      for (int c = 0; c < kTcTile; c += 8) {
        const float4 a = *reinterpret_cast<const float4*>(row + c);
        const float4 b = *reinterpret_cast<const float4*>(row + c + 4);
        const float dist[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        // fminf passes over a NaN (a column past n): it never enters
        const float least = fminf(fminf(fminf(a.x, a.y), fminf(a.z, a.w)),
                                  fminf(fminf(b.x, b.y), fminf(b.z, b.w)));
        unsigned bits = 0;
        if (walk && least < thr) {
#pragma unroll
          for (int v = 0; v < 8; ++v) bits |= static_cast<unsigned>(dist[v] < thr) << v;
        }
        unsigned rows_left = __ballot_sync(0xffffffffu, bits != 0);
        while (rows_left) {
          const int src = __ffs(rows_left) - 1;
          // the candidate: the source row's lowest column still below its kb-th
          const int v = __ffs(bits) - 1;  // meaningful in lane src
          float mine = dist[0];
#pragma unroll
          for (int w = 1; w < 8; ++w) mine = v == w ? dist[w] : mine;
          const float dv = __shfl_sync(0xffffffffu, mine, src);
          const int at_col = c0 + c + __shfl_sync(0xffffffffu, v, src);
          const float* ld = wld + src * (kb + 1);
          const int* li = wli + src * (kb + 1);
          const float cur_d = lane < kb ? ld[lane] : CUDART_INF_F;
          const int cur_i = lane < kb ? li[lane] : -1;
          const int at = __popc(__ballot_sync(0xffffffffu, lane < kb && cur_d <= dv));
          const float up_d = __shfl_up_sync(0xffffffffu, cur_d, 1);
          const int up_i = __shfl_up_sync(0xffffffffu, cur_i, 1);
          if (at < kb && lane >= at && lane < kb) {
            wld[src * (kb + 1) + lane] = lane == at ? dv : up_d;
            wli[src * (kb + 1) + lane] = lane == at ? at_col : up_i;
          }
          const float kth = __shfl_sync(0xffffffffu, lane == at ? dv : (lane > at ? up_d : cur_d),
                                        kb - 1);
          __syncwarp();
          if (lane == src) {
            if (at < kb) thr = kth;
            bits &= bits - 1;  // this column is done
#pragma unroll
            for (int w = 0; w < 8; ++w) {
              if (!(dist[w] < thr)) bits &= ~(1u << w);
            }
          }
          rows_left = __ballot_sync(0xffffffffu, bits != 0);
        }
      }
      *thr_out = thr;
      __syncwarp();
      if (lane == 0) repro::mbar_arrive(dist_empty + 8 * db);
      if (++db == nb) {
        db = 0;
        dphase ^= 1;
      }
    }
    const int r = slab * kTcRows + st;
    if (r < m) {
      const float* ld = wld + lane * (kb + 1);
      const int* li = wli + lane * (kb + 1);
      unsigned long long* out = part + (static_cast<long>(blockIdx.x + slab) * kTcRows + st) * k;
      for (int i = 0; i < k; ++i) out[i] = li[i] < 0 ? kNone : make_key(ld[i], li[i]);
    }
    __syncwarp();
  }
}

// One persistent block per SM over units [u0, u1) of (slab, tile); see the
// note at the head of this file.  kb: the selector's list length.
template <int KS>
__global__ void __launch_bounds__(kTcThreads, 1)
knn_chunk_topk(const float* __restrict__ test, const float* __restrict__ train,
               const float* __restrict__ test_sq, const float* __restrict__ train_sq, int m,
               int n, int d, int k, int kb, int tiles, long long units,
               unsigned long long* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const TcLayout lay = tc_layout(KS, d, kb);
  const uint32_t raw_full = repro::smem_addr(tc_smem + lay.bars);
  const uint32_t full = raw_full + 8 * kRawStages;
  const uint32_t empty = full + 8 * kSplitStages;
  const uint32_t dist_full = empty + 8 * kSplitStages;  // [warpgroup][tile], 2 x 2
  const uint32_t dist_empty = dist_full + 8 * 4;
  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRawStages; ++s) repro::mbar_init(raw_full + 8 * s, 1);
    for (int s = 0; s < kSplitStages; ++s) {
      repro::mbar_init(full + 8 * s, 128);  // the producer's threads
      repro::mbar_init(empty + 8 * s, 8);   // the consumers' warps
    }
    for (int s = 0; s < 4; ++s) {
      repro::mbar_init(dist_full + 8 * s, 4);   // a consumer warpgroup's warps
      repro::mbar_init(dist_empty + 8 * s, 2);  // the selector's warps of its rows
    }
    repro::fence_mbarrier_init();
  }
  __syncthreads();
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 7, 0);
  if (role == 2) {
    repro::setmaxnreg_dec<kProducerRegs>();
    tc_produce<KS>(train, train_sq, n, d, tiles, u0, static_cast<int>(u1 - u0), tc_smem, lay,
                   raw_full, full, empty);
  } else if (role == 3) {
    repro::setmaxnreg_dec<kSelectorRegs>();
    switch (k) {
#define KNN_SELECT(K)                                                                   \
  case K:                                                                               \
    tc_select_regs<K>(m, k, tiles, u0, u1, tc_smem, lay, dist_full, dist_empty, part); \
    break;
      KNN_SELECT(1) KNN_SELECT(2) KNN_SELECT(3) KNN_SELECT(4)
      KNN_SELECT(5) KNN_SELECT(6) KNN_SELECT(7) KNN_SELECT(8)
#undef KNN_SELECT
      default:
        if (kb == 16) {
          tc_select_regs<16>(m, k, tiles, u0, u1, tc_smem, lay, dist_full, dist_empty, part);
        } else {
          tc_select(m, k, kb, tiles, u0, u1, tc_smem, lay, dist_full, dist_empty, part);
        }
    }
  } else {
    repro::setmaxnreg_inc<kConsumerRegs>();
    tc_consume<KS>(test, test_sq, m, d, tiles, u0, u1, tc_smem, lay, full, empty, dist_full,
                   dist_empty);
  }
}

// Insert key into the ascending list l[0..K) (it is below l[K - 1]): it
// goes before the first larger entry, the last falls off.  Unrolled, so
// the list stays in registers.
template <int K>
__device__ __forceinline__ void insert_key_sorted(unsigned long long (&l)[K],
                                                  unsigned long long key) {
#pragma unroll
  for (int i = K - 1; i > 0; --i) {
    if (key < l[i - 1]) {
      l[i] = l[i - 1];
    } else if (key < l[i]) {
      l[i] = key;
    }
  }
  if (key < l[0]) l[0] = key;
}

// The block that holds unit p of `units` split over `blocks` runs
// (run b starts at floor(b units / blocks)).
__device__ __forceinline__ int block_of(long long p, long long units, int blocks) {
  return static_cast<int>(((p + 1) * blocks + units - 1) / units) - 1;
}

// One thread per test row: the lists of every segment of its slab, k keys
// each, merged into the k smallest (keys: the order does not matter), then
// decoded into distances and the labels of their training rows.
template <int K>
__global__ void knn_merge_chunks(const unsigned long long* __restrict__ part, int m, int k,
                                 int tiles, long long units, int blocks,
                                 const int* __restrict__ labels, float* __restrict__ out_d,
                                 int* __restrict__ out_l) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const int slab = row / kTcRows;
  const long long first = static_cast<long long>(slab) * tiles;
  unsigned long long best[K];
#pragma unroll
  for (int i = 0; i < K; ++i) best[i] = kNone;
  const int b1 = block_of(first + tiles - 1, units, blocks);
  for (int b = block_of(first, units, blocks); b <= b1; ++b) {
    const unsigned long long* l =
        part + (static_cast<long>(b + slab) * kTcRows + row % kTcRows) * k;
    for (int i = 0; i < k; ++i) {
      const unsigned long long key = l[i];
      if (key >= best[K - 1]) break;  // the list ascends
      insert_key_sorted<K>(best, key);
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < k) {
      out_d[static_cast<long>(row) * k + i] =
          from_ordered_bits(static_cast<uint32_t>(best[i] >> 32));
      out_l[static_cast<long>(row) * k + i] = labels[static_cast<uint32_t>(best[i])];
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

template <int KS>
cudaError_t launch_tc(const float* test, const float* train, const int* labels, int m, int n,
                      int d, int k, int kb, int blocks, float* test_sq, float* train_sq,
                      unsigned long long* part, float* out_d, int* out_l, cudaStream_t stream) {
  const TcLayout lay = tc_layout(KS, d, kb);
  const int tiles = (n + kTcTile - 1) / kTcTile;
  const long long units = static_cast<long long>((m + kTcRows - 1) / kTcRows) * tiles;
  if (blocks < 1 || blocks > units) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      knn_chunk_topk<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err != cudaSuccess) return err;
  row_sqnorms<<<(m + 255) / 256, 256, 0, stream>>>(test, m, d, test_sq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  row_sqnorms<<<(n + 255) / 256, 256, 0, stream>>>(train, n, d, train_sq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_chunk_topk<KS><<<blocks, kTcThreads, lay.total, stream>>>(
      test, train, test_sq, train_sq, m, n, d, k, kb, tiles, units, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int grid = (m + 127) / 128;
  switch (kb) {
    case 8:
      knn_merge_chunks<8><<<grid, 128, 0, stream>>>(part, m, k, tiles, units, blocks, labels,
                                                    out_d, out_l);
      break;
    case 16:
      knn_merge_chunks<16><<<grid, 128, 0, stream>>>(part, m, k, tiles, units, blocks, labels,
                                                     out_d, out_l);
      break;
    default:
      knn_merge_chunks<32><<<grid, 128, 0, stream>>>(part, m, k, tiles, units, blocks, labels,
                                                     out_d, out_l);
  }
  return cudaGetLastError();
}

}  // namespace

// The tensor-core route: 1 <= k <= kb (8, 16 or 32, the merge's list
// length), 1 <= d <= 64, `blocks` persistent blocks (at most one per SM and
// at most the units: knn_topk.partition).  Scratch: test_sq m floats,
// train_sq ceil(n / 64) x 64 floats (16-byte aligned), part (blocks +
// ceil(m / 128) - 1) x 128 x k keys.  train must be 4-byte aligned.
// Returns a cudaError_t.
extern "C" int knn_topk_launch(const float* test, const float* train, const int* labels, int m,
                               int n, int d, int k, int kb, int blocks, float* test_sq,
                               float* train_sq, unsigned long long* part, float* out_d,
                               int* out_l, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || d < 1 || d > 64 || k < 1 || k > kb || k > n ||
      (kb != 8 && kb != 16 && kb != 32) || reinterpret_cast<uintptr_t>(train_sq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(train) % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  switch ((d + 7) / 8) {
    case 1:
      return launch_tc<1>(test, train, labels, m, n, d, k, kb, blocks, test_sq, train_sq, part,
                          out_d, out_l, s);
    case 2:
      return launch_tc<2>(test, train, labels, m, n, d, k, kb, blocks, test_sq, train_sq, part,
                          out_d, out_l, s);
    case 3:
      return launch_tc<3>(test, train, labels, m, n, d, k, kb, blocks, test_sq, train_sq, part,
                          out_d, out_l, s);
    case 4:
      return launch_tc<4>(test, train, labels, m, n, d, k, kb, blocks, test_sq, train_sq, part,
                          out_d, out_l, s);
    case 5:
      return launch_tc<5>(test, train, labels, m, n, d, k, kb, blocks, test_sq, train_sq, part,
                          out_d, out_l, s);
    case 6:
      return launch_tc<6>(test, train, labels, m, n, d, k, kb, blocks, test_sq, train_sq, part,
                          out_d, out_l, s);
    case 7:
      return launch_tc<7>(test, train, labels, m, n, d, k, kb, blocks, test_sq, train_sq, part,
                          out_d, out_l, s);
    default:
      return launch_tc<8>(test, train, labels, m, n, d, k, kb, blocks, test_sq, train_sq, part,
                          out_d, out_l, s);
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
