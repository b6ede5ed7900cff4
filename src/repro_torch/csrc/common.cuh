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
// 8 bytes global -> shared; zero-filled where !ok
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 8 : 0) : "memory");
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

// acc += a . b on one 16 x 8 tile, k 8, in 3xTF32: the products x_lo
// y_hi, x_hi y_lo, x_hi y_hi, in that order, gathered in a fresh
// accumulator that an fp32 add carries into acc.  The tensor cores add
// into their fp32 accumulator without rounding to nearest (an mma's sum is
// cut toward zero), so an accumulator carried through every step of a
// product drifts toward zero by about half an ulp of itself a step; the
// fresh one's ulps are those of 8 terms.  On an H100, on points ~5
// sqrt(d) from the origin, a carried accumulator raised kmeans' sse by
// 2.4e-5 relative at d 384 (the wide route) and by 6.6e-5 at d 256, k 64
// (the narrow one), and moved knn distances at d 64 by 4.2e-3.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  float step[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(step, al, bh0, bh1);
  mma_tf32(step, ah, bl0, bl1);
  mma_tf32(step, ah, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += step[e];
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

// ------------------------------- Hopper: mbarriers, bulk copies, wgmma

// An mbarrier in shared memory (its shared address) expecting `count`
// arrivals a phase.  One thread initialises; fence_mbarrier_init and a
// block barrier follow before any thread uses it.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// one arrival that also sets the bytes the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
// `bytes` (a multiple of 16; both addresses 16-byte aligned) global ->
// shared by the copy engine, completion counted on the mbarrier
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma's operand reads)
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// named barrier 1..15 over `count` threads (whole warps)
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Pins registers that an asynchronous wgmma reads or writes: the compiler
// may not move their other uses across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// core matrices of 8 rows x 16 bytes (4 TF32 values a row) stored as 128
// contiguous bytes; `lbo` bytes between the two core matrices of an 8-deep
// step (along K), `sbo` bytes between groups of 8 rows (along N).
__device__ __forceinline__ uint64_t gmma_desc_kmajor(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3ffff) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32;
}

// d (64 x 32 fp32, this thread's 16) = a . b (scale_d 0) or d + a . b
// (scale_d 1) over one 8-deep step: a the warpgroup's 64 rows in TF32 from
// registers (this warp's 16 rows in the m16n8k8 A layout: (g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4)), b 32 K-major rows of TF32 in shared
// memory.  Element 4 j + e of d is row 16 warp + g + 8 (e >> 1), column 8
// j + 2 t + (e & 1).  Asynchronous: wgmma_commit / wgmma_wait around it.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_m64n32k8_tf32(float (&d)[16], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(SCALE_D));
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

// ------------------------------ depth-streamed 3xTF32 tiles, any depth d

// The wide routes of knn_topk and kmeans_assign multiply a block's 16 x
// (warps) rows of A by up to 128 rows of B over any depth d.  Neither
// operand is held at full depth: fixed 32-deep slices of both go through
// a ring of shared stages by cp.async, and each warp keeps its fp32
// accumulators in registers across the whole depth, so shared memory does
// not grow with d.  The products are 3xTF32 (x_lo y_hi + x_hi y_lo + x_hi
// y_hi, split where the fragments are loaded), as in knn_chunk_topk.
// Each 8-deep step gathers its three products in a fresh accumulator and
// adds it to the running one with an fp32 add (mma_3xtf32, above).

constexpr int kSliceDepth = 32;            // depth of one shared slice: 4 TF32 k-steps
constexpr int kSliceLD = kSliceDepth + 4;  // its row stride in floats: 8 ldmatrix rows
                                           // (144 bytes apart) meet distinct banks

// Queue rows [0, cap) x depth [j0, j0 + 32) of a row-major (rows, d) fp32
// matrix into a shared slice of row stride kSliceLD; rows past `rows` and
// depth past d read as zero.  VEC floats go per copy (4, 2 or 1: d % VEC
// == 0 and src 4 VEC bytes aligned); a thread's copies share one column,
// so its addresses advance by a constant.  Every thread of the block
// (THREADS of them) calls it with the same arguments.
template <int THREADS, int VEC>
__device__ __forceinline__ void issue_slice_vec(float* dst, int cap, const float* __restrict__ src,
                                                int rows, int d, int j0) {
  constexpr int kPer = kSliceDepth / VEC;  // copies per row
  constexpr int kStep = THREADS / kPer;    // rows per pass of the block
  const int r0 = static_cast<int>(threadIdx.x) / kPer;
  const int c = (static_cast<int>(threadIdx.x) % kPer) * VEC;
  const bool in_d = j0 + c < d;
  const float* p = src + static_cast<long>(r0) * d + j0 + c;
  uint32_t a = smem_addr(dst) + (r0 * kSliceLD + c) * 4;
  for (int r = r0; r < cap; r += kStep) {
    const bool ok = in_d && r < rows;
    if (VEC == 4) {
      cp_async16(a, ok ? p : src, ok);
    } else if (VEC == 2) {
      cp_async8(a, ok ? p : src, ok);
    } else {
      cp_async4(a, ok ? p : src, ok);
    }
    p += static_cast<long>(kStep) * d;
    a += kStep * kSliceLD * 4;
  }
}
template <int THREADS>
__device__ __forceinline__ void issue_slice(float* dst, int cap, const float* __restrict__ src,
                                            int rows, int d, int j0, int vec) {
  if (vec == 4) {
    issue_slice_vec<THREADS, 4>(dst, cap, src, rows, d, j0);
  } else if (vec == 2) {
    issue_slice_vec<THREADS, 2>(dst, cap, src, rows, d, j0);
  } else {
    issue_slice_vec<THREADS, 1>(dst, cap, src, rows, d, j0);
  }
}

// This lane's ldmatrix row address into a slice: for A, rows row0 .. row0
// + 15 (lane l feeds row row0 + (l & 7) + 8 ((l >> 3) & 1) at column 4 (l
// >> 4), giving a0..a3 of the m16 x k8 fragment); for B, the rows of n8
// tiles 0 and 1 (lane l feeds row (l & 7) + 8 (l >> 4) at column 4 ((l >>
// 3) & 1), giving b0, b1 of tile 0, then of tile 1).
__device__ __forceinline__ uint32_t slice_a_addr(const float* slice, int row0) {
  const int l = threadIdx.x & 31;
  return smem_addr(slice + (row0 + (l & 7) + 8 * ((l >> 3) & 1)) * kSliceLD + 4 * (l >> 4));
}
__device__ __forceinline__ uint32_t slice_b_addr(const float* slice) {
  const int l = threadIdx.x & 31;
  return smem_addr(slice + ((l & 7) + 8 * (l >> 4)) * kSliceLD + 4 * ((l >> 3) & 1));
}

// acc[j] += A . B_j^T over the first `ksteps` 8-deep steps of one slice:
// A the 16 rows at a_addr, B_j the 8 rows of n8 tile j at b_addr, j <
// nt_active (even; the tiles past it are not touched), by mma_3xtf32 per
// tile and step.  Element e of acc[j] is
// row g + 8 (e >> 1), column 8 j + 2 t4 + (e & 1) (g = lane / 4, t4 =
// lane % 4).  With SQ, sq[0] and sq[1] gather the squares of the A values
// this lane loads for rows g and g + 8 (a quad's four lanes hold a row).
template <int NT, bool SQ>
__device__ __forceinline__ void mma_slice_3xtf32(float (&acc)[NT][4], uint32_t a_addr,
                                                 uint32_t b_addr, int ksteps, int nt_active,
                                                 float (&sq)[2]) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t raw[4], ah[4], al[4];
    ldsm_x4(raw, a_addr + 32 * ks);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = __uint_as_float(raw[e]);
      if (SQ) sq[e & 1] = fmaf(v, v, sq[e & 1]);
      split_tf32(v, ah[e], al[e]);
    }
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      if (2 * jp < nt_active) {
        uint32_t rb[4], bh[4], bl[4];
        ldsm_x4(rb, b_addr + jp * 16 * kSliceLD * 4 + 32 * ks);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(rb[e]), bh[e], bl[e]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_3xtf32(acc[2 * jp + h], ah, al, bh[2 * h], bh[2 * h + 1], bl[2 * h], bl[2 * h + 1]);
        }
      }
    }
  }
}

}  // namespace repro
