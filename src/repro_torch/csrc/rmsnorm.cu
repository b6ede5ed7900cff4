// RMSNorm over the last dimension: the port of the Pallas kernel
// src/repro/kernels/rmsnorm.py :: rmsnorm (body `_kernel`), which every LM
// block runs four times (ln1, ln2 and the per-head q/k norms) and the final
// norm once.
//
// What it computes: y = x * (1 / sqrt(mean(x^2) + eps)) * float(scale), in
// fp32, written in x's type.  x is bf16 or fp32, scale bf16 or fp32.  The
// reciprocal is 1/sqrt (correctly rounded under nvcc's default -prec-div
// and -prec-sqrt), as in the JAX layer the model uses
// (repro/layers/norms.py); the Pallas kernel's rsqrt differs from it by an
// ulp or so.
//
// What bounds it on an H100: memory.  The bound counts one read of x, one
// write of y and one read of scale, over 3.35 TB/s.  For 4096 rows x 1024
// bf16: 16.8 MB, ~5 us; so too for 65,536 q/k-norm rows of 64.
//
// Design (rows split into 16-byte packs: 8 bf16 or 4 fp32 values):
//  * A row gets the lanes that hold its packs, rounded up to a power of
//    two and at most 32 (LPR): 8 lanes for a 64-wide bf16 row, 16 for a
//    64-wide fp32 row, so 4 or 2 rows share a warp and every lane loads.
//    A row of more than 32 packs takes a whole warp, each lane holding up
//    to PPL = 2, 4, 8 or 16 packs (PPL a template parameter: 4 at 1024
//    bf16, 8 at 1536, 16 at 3072 and 4096).  Lane l of a row holds packs
//    l, l + LPR, ..., so a warp's loads are contiguous.
//  * x is read once: the lane's packs stay in registers from the sum of
//    squares to the scaled write.  The sum runs over the lane's packs in
//    order, then a segmented butterfly (__shfl_xor_sync at offsets below
//    LPR only) adds the lanes of one row.
//  * The block copies scale into shared memory as it starts (`cp.async`,
//    16-byte pieces; 4-byte for a bf16 scale of fp32 x), in flight beside
//    the loads of x; each lane reads its packs' scale from there once,
//    where it writes.
//  * Blocks hold 8 warps where the rows give every SM such a block, fewer
//    (down to one warp) where they do not: a decode step's 8 or 128 rows
//    then spread over as many SMs as they can.
//  * Past 512 packs (bf16 d > 4096, fp32 d > 2048) the packs would not fit
//    the registers: a warp per row reads x twice (the second time from
//    L1/L2), with the same order of sums as PPL = packs / 32.  Rows off
//    16-byte packs (an unaligned address, or d * size % 16 != 0) go element
//    by element the same way.  The wrapper picks the pack path by
//    alignment.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;             // warps per block (the most)
constexpr int kMaxPacksPerLane = 16;  // registers hold a row up to 32 x 16 packs

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as PyTorch's cast
}

// 16 bytes of T.
template <typename T>
struct alignas(16) Pack {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// The values of 32-bit words as floats: fp32 words as they are; bf16
// words hold two values, element 2i in the low half of word i (a bf16 is
// the high half of its fp32).
template <typename T, int N, int K>
__device__ __forceinline__ void unpack(const uint32_t (&w)[K], float (&f)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if constexpr (sizeof(T) == 4) {
      f[e] = __uint_as_float(w[e]);
    } else {
      f[e] = __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
    }
  }
}

// One 16-byte pack of T from N floats (bf16 rounded to nearest even, as
// PyTorch's cast).
template <typename T, int N>
__device__ __forceinline__ uint4 pack16(const float (&f)[N]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(f[i]);
    } else {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The N scale values of pack q as floats, loaded in 16-byte pieces (one
// 8-byte piece for a bf16 scale of fp32 x; scale is 16-byte aligned).
template <typename TS, int N>
__device__ __forceinline__ void load_scale(const TS* __restrict__ scale, int q, float (&f)[N]) {
  constexpr int kWords = N * static_cast<int>(sizeof(TS)) / 4;
  uint32_t w[kWords];
  if constexpr (kWords % 4 == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(scale + q * N);
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 v = src[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(scale + q * N);
    w[0] = v.x;
    w[1] = v.y;
  }
  unpack<TS>(w, f);
}

// LPR lanes per row (32 / LPR rows per warp), PPL packs per lane, held as
// raw 16-byte words in registers; rows of d / N <= LPR * PPL packs.  The
// block copies scale into shared memory first, so that its loads overlap
// those of x: in a serve each layer's scale is cold in L2, and loads
// issued after the row's sum would add a second round trip to memory.
// The bounds ask for two blocks per SM (up to 128 registers a thread; the
// widest instance needs ~90).
template <typename TX, typename TS, int LPR, int PPL>
__global__ void __launch_bounds__(kWarps * 32, 2)
rmsnorm_rows(const TX* __restrict__ x, const TS* __restrict__ scale, TX* __restrict__ y,
             long long rows, int d, float eps) {
  constexpr int N = Pack<TX>::N;
  constexpr int kScaleBytes = N * static_cast<int>(sizeof(TS));  // per pack: 8, 16 or 32
  __shared__ uint4 sc_s[(LPR * PPL * kScaleBytes + 15) / 16];
  const int lane = threadIdx.x & 31;
  const int li = lane & (LPR - 1);  // the lane within its row
  const long long row =
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5)) * (32 / LPR) +
      lane / LPR;
  const bool ok = row < rows;
  const int packs = d / N;

  {  // cp.async: the copies are in flight while x loads
    constexpr int kPiece = kScaleBytes % 16 == 0 ? 16 : 4;
    const uint32_t dst = repro::smem_addr(sc_s);
    const char* src = reinterpret_cast<const char*>(scale);
    for (int i = threadIdx.x; i < packs * kScaleBytes / kPiece; i += blockDim.x) {
      if constexpr (kPiece == 16) {
        repro::cp_async16(dst + 16 * i, src + 16 * i, true);
      } else {
        repro::cp_async4(dst + 4 * i, src + 4 * i, true);
      }
    }
    repro::cp_async_commit();
  }

  const uint4* xp = reinterpret_cast<const uint4*>(x + row * d);
  uint4 p[PPL];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    const int q = li + i * LPR;
    p[i] = ok && q < packs ? xp[q] : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t w[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
    float f[N];
    unpack<TX>(w, f);
#pragma unroll
    for (int e = 0; e < N; ++e) ss = fmaf(f[e], f[e], ss);   // zeros add nothing
  }
  // the lanes of one row: offsets below LPR stay inside its segment
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  repro::cp_async_wait<0>();
  __syncthreads();  // the scale is in shared memory
  if (!ok) return;
  const float inv = 1.f / sqrtf(ss / static_cast<float>(d) + eps);

  const TS* sc_t = reinterpret_cast<const TS*>(sc_s);
  uint4* yp = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    const int q = li + i * LPR;
    if (q < packs) {
      const uint32_t w[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
      float f[N], sc[N];
      unpack<TX>(w, f);
      load_scale<TS, N>(sc_t, q, sc);
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = (f[e] * inv) * sc[e];
      yp[q] = pack16<TX, N>(f);
    }
  }
}

// One warp per row, two passes over x: rows past the registers' 512 packs
// (kVec) and rows off 16-byte packs (element by element).
template <typename TX, typename TS, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_rows_two_pass(const TX* __restrict__ x, const TS* __restrict__ scale,
                      TX* __restrict__ y, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + row * d;
  TX* yr = y + row * d;
  constexpr int N = Pack<TX>::N;

  float ss = 0.f;
  if (kVec) {
    const Pack<TX>* xp = reinterpret_cast<const Pack<TX>*>(xr);
    for (int i = lane; i < d / N; i += 32) {
      const Pack<TX> p = xp[i];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float f = to_f(p.v[e]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      const float f = to_f(xr[j]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = 1.f / sqrtf(ss / static_cast<float>(d) + eps);

  if (kVec) {
    const Pack<TX>* xp = reinterpret_cast<const Pack<TX>*>(xr);
    Pack<TX>* yp = reinterpret_cast<Pack<TX>*>(yr);
    for (int i = lane; i < d / N; i += 32) {
      const Pack<TX> p = xp[i];
      float sc[N];
      load_scale<TS, N>(scale, i, sc);
      Pack<TX> out;
#pragma unroll
      for (int e = 0; e < N; ++e) out.v[e] = from_f<TX>((to_f(p.v[e]) * inv) * sc[e]);
      yp[i] = out;
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      yr[j] = from_f<TX>((to_f(xr[j]) * inv) * to_f(scale[j]));
    }
  }
}

// Warps per block: kWarps where the rows fill every SM with such blocks,
// fewer where they would not (a decode step's few rows), so that small
// launches still spread over the SMs.
template <typename TX, typename TS, int LPR, int PPL>
cudaError_t launch_rows(const TX* x, const TS* scale, TX* y, long long rows, int d, float eps,
                        int sms, cudaStream_t s) {
  const long long warps = (rows + 32 / LPR - 1) / (32 / LPR);
  const long long per_sm = warps / (sms > 0 ? sms : 1);
  const int wpb = per_sm >= kWarps ? kWarps : (per_sm < 1 ? 1 : static_cast<int>(per_sm));
  const unsigned blocks = static_cast<unsigned>((warps + wpb - 1) / wpb);
  rmsnorm_rows<TX, TS, LPR, PPL><<<blocks, wpb * 32, 0, s>>>(x, scale, y, rows, d, eps);
  return cudaGetLastError();
}

template <typename TX, typename TS>
cudaError_t launch(const void* x, const void* scale, void* y, long long rows, int d,
                   bool vec, float eps, int sms, cudaStream_t s) {
  const TX* xt = static_cast<const TX*>(x);
  const TS* st = static_cast<const TS*>(scale);
  TX* yt = static_cast<TX*>(y);
  const int packs = vec ? d / Pack<TX>::N : 0;
  // lanes per row and packs per lane: kernels/rmsnorm.py :: layout
  if (vec && packs <= 32) {
    if (packs <= 1) return launch_rows<TX, TS, 1, 1>(xt, st, yt, rows, d, eps, sms, s);
    if (packs <= 2) return launch_rows<TX, TS, 2, 1>(xt, st, yt, rows, d, eps, sms, s);
    if (packs <= 4) return launch_rows<TX, TS, 4, 1>(xt, st, yt, rows, d, eps, sms, s);
    if (packs <= 8) return launch_rows<TX, TS, 8, 1>(xt, st, yt, rows, d, eps, sms, s);
    if (packs <= 16) return launch_rows<TX, TS, 16, 1>(xt, st, yt, rows, d, eps, sms, s);
    return launch_rows<TX, TS, 32, 1>(xt, st, yt, rows, d, eps, sms, s);
  }
  if (vec && packs <= 32 * kMaxPacksPerLane) {
    if (packs <= 64) return launch_rows<TX, TS, 32, 2>(xt, st, yt, rows, d, eps, sms, s);
    if (packs <= 128) return launch_rows<TX, TS, 32, 4>(xt, st, yt, rows, d, eps, sms, s);
    if (packs <= 256) return launch_rows<TX, TS, 32, 8>(xt, st, yt, rows, d, eps, sms, s);
    return launch_rows<TX, TS, 32, 16>(xt, st, yt, rows, d, eps, sms, s);
  }
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  if (vec) {
    rmsnorm_rows_two_pass<TX, TS, true><<<blocks, kWarps * 32, 0, s>>>(xt, st, yt, rows, d, eps);
  } else {
    rmsnorm_rows_two_pass<TX, TS, false><<<blocks, kWarps * 32, 0, s>>>(xt, st, yt, rows, d, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: (rows, d) contiguous, bf16 if x_bf16 else fp32; scale: (d,), bf16
// if scale_bf16 else fp32.  vec: x, y and scale are 16-byte aligned and d
// fills whole 16-byte packs (the wrapper checks).  sms: the card's SMs.
// Returns a cudaError_t.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y, long long rows,
                              int d, int x_bf16, int scale_bf16, int vec, float eps, int sms,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  if (x_bf16) {
    return scale_bf16
        ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d, vec, eps, sms, s)
        : launch<__nv_bfloat16, float>(x, scale, y, rows, d, vec, eps, sms, s);
  }
  return scale_bf16 ? launch<float, __nv_bfloat16>(x, scale, y, rows, d, vec, eps, sms, s)
                    : launch<float, float>(x, scale, y, rows, d, vec, eps, sms, s);
}
