// Mamba-2 SSD scan from a zero state: the port of the Pallas kernel
// src/repro/kernels/ssd_scan.py :: ssd_scan (body `_kernel`), which the
// port's SSD layer runs for every prefill.
//
// What it computes: x (B, S, H, P), dt (B, S, H) after softplus, A (H,)
// negative, Bm and Cm (B, S, N), one group shared by the H heads.  Per
// (b, h) the (P, N) state starts at zero and, per step t,
//   state = state * exp(dt_t * A) + (x_t * dt_t) (outer) B_t,
//   y_t   = state . C_t,
// all in fp32 (x, B and C are read as bf16 or fp32).  That is the function
// the Pallas kernel computes by chunks.  Where this kernel departs from it,
// on purpose:
//   * y is written in fp32 (B, S, H, P) contiguous: the layer adds the
//     D * x skip term in fp32 before it rounds to the model's type, as the
//     JAX layer does; parity with the Pallas kernel is judged on y cast to
//     x's type;
//   * the final (B, H, P, N) fp32 state is written as well: the layer's
//     prefill needs it for the decode cache, and the Pallas kernel drops it;
//   * x, dt, Bm and Cm are read through the strides they come with (x is a
//     view into the conv output, a row stride of d_inner + 2N), so the
//     layer makes no copy;
//   * any S: the chunk length is the kernel's own choice, and the function
//     does not depend on it, so a ragged S needs no padding.
//
// What bounds it on an H100: at the mamba2 path's prefill (B 8, S 512,
// H 48, P 64, N 128, bf16 x, B and C) the kernel moves x, B, C and dt in
// (28 MB) and y and the state out (63 MB): 27 us at 3.35 TB/s.  The
// chunked SSD at chunk Q does 2(QN + QP)Q + 4QNP flops per (b, h, chunk),
// 8.9 GFLOP at Q 32 (9 us at the 989 TFLOP/s bf16 tensor-core peak);
// the hi/lo splits below double the three products with an fp32 operand,
// to 16.1 GFLOP (16 us).  So bytes bound the card.
//
// Two routes, chosen by dtype:
//
// * bf16 (every config of the repo; the serve path): the chunked SSD on
//   the tensor cores, `ssd_chunk_bf16_tc` below.
// * fp32 keeps the CUDA-core kernel `ssd_scan_kernel` of the first port,
//   which steps the recurrence one step at a time (5 flops per state
//   element and step: 0.12 ms at the 67 TFLOP/s fp32 peak for the shape
//   above); the reduced fp32 configs and the fp32 kernel checks use it.
//
// Design of the bf16 route:
//
// * One block per (h, b) walks the chunks of Q = 32 steps in order, with
//   ceil(P / 16) warps: warp w owns rows p in [16w, 16w + 16) of the
//   (P, N) state and columns p in [16w, 16w + 16) of y.  The state stays
//   in fp32 `mma` accumulators across the chunks.
// * x, B, C (bf16) and dt of a chunk are staged through their strides by
//   `cp.async` into a ring of two stages, so the next chunk loads while
//   this one is used (a third stage measured no faster): 16-byte pieces
//   where every address and stride is a multiple of 16 bytes and P and N
//   are multiples of 8 (the layer's views), else element by element.
//   Rows past S read as zeros with dt = 0 (decay 1, contribution 0).
//   Tiles are padded to 16 in P and N (zeros), and their rows by 16
//   bytes, which keeps `ldmatrix` free of bank conflicts.
// * Per chunk, all with `mma.sync.m16n8k16` (bf16 in, fp32 accumulate),
//   fragments from `ldmatrix` and cs = the in-chunk cumulative sum of
//   dt * A (one lane per step, added in step order):
//     y      = exp(cs) o (C . state^T)         the entering state;
//     M      = (C . B^T) o L o dt, L_ij = exp(cs_i - cs_j) for i >= j,
//              0 above the diagonal (its three non-zero 16 x 16 blocks
//              split over the warps, then through shared memory);
//     y     += M . X;
//     state  = exp(cs_last) state + (X o exp(cs_last - cs) dt)^T . B.
//   The accumulator fragment of a 16 x 8 state tile is, element for
//   element, the B fragment of C . state^T, so the state never leaves
//   registers.  x, B and C enter exactly.  Where an operand is fp32 (the
//   state, M, the decay-scaled x) it is split into bf16 hi + lo, and both
//   are multiplied: a single bf16 operand keeps 8 bits, which misses the
//   checks' 1e-4 (tests/test_torch_kernels.py emulates both).
// * y goes from the accumulators to global memory as 8-byte pieces (four
//   lanes fill a 32-byte sector), the final state likewise.  No atomics:
//   two launches are bitwise equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace {

// ------------------------------------------- fp32 route (CUDA cores)
// One block per (h, b) steps the recurrence with the (P, N) state in
// registers: thread (p, g) of 4 * ceil8(P) threads owns row p and the NS =
// N/4 (rounded up to 8, 16 or 32) columns [g*NS, g*NS + NS) of it, and
// the block stages kT = 32 steps of x, dt, exp(dt*A), B and C in shared
// memory as fp32.
constexpr int kG = 4;    // lanes sharing one row p of the state
constexpr int kT = 32;   // steps staged in shared memory per pass
constexpr int kMaxP = 128;
constexpr int kMaxThreads = kG * kMaxP;

// Element strides: x (b, s, h), dt (b, s, h), Bm and Cm (b, s); the last
// axis of x, Bm and Cm is contiguous.
struct Strides {
  long long x[3], dt[3], bm[2], cm[2];
};

__host__ __device__ constexpr int ldn(int ns) { return kG * (ns + 4); }
__host__ __device__ constexpr int ceil8(int p) { return (p + 7) / 8 * 8; }

template <int NS>
constexpr int smem_floats_for(int p_pad) {
  return kT * (2 * ldn(NS) + 2 * p_pad + 2);
}

template <int NS>
__global__ void __launch_bounds__(kMaxThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ bm,
                const float* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int N, Strides st) {
  constexpr int LDN = ldn(NS);
  const int p_pad = ceil8(P);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* bs = smem;                 // kT x LDN
  float* cs = bs + kT * LDN;        // kT x LDN
  float* xs = cs + kT * LDN;        // kT x p_pad
  float* ys = xs + kT * p_pad;      // kT x p_pad
  float* dts = ys + kT * p_pad;     // kT
  float* das = dts + kT;            // kT

  const int tid = threadIdx.x;
  const int p = tid >> 2;
  const int g = tid & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float a_h = A[h];
  const float* xb = x + b * st.x[0] + h * st.x[2];
  const float* db = dt + b * st.dt[0] + h * st.dt[2];
  const float* bb = bm + b * st.bm[0];
  const float* cb = cm + b * st.cm[0];
  float* yb = y + (static_cast<long long>(b) * S * H + h) * P;

  // padding columns of B/C and rows p >= P of x stay zero: their state
  // entries stay zero and add nothing to y
  for (int i = tid; i < kT * (2 * LDN + p_pad); i += blockDim.x) smem[i] = 0.f;

  float s[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int tc = min(kT, S - t0);
    __syncthreads();  // the previous pass is consumed (and the zeroing done)
    for (int e = tid; e < tc * N; e += blockDim.x) {
      const int tt = e / N, n = e - tt * N;
      const int at = tt * LDN + (n / NS) * (NS + 4) + n % NS;
      bs[at] = (bb[(t0 + tt) * st.bm[1] + n]);
      cs[at] = (cb[(t0 + tt) * st.cm[1] + n]);
    }
    for (int e = tid; e < tc * P; e += blockDim.x) {
      const int tt = e / P, pp = e - tt * P;
      xs[tt * p_pad + pp] = (xb[(t0 + tt) * st.x[1] + pp]);
    }
    for (int tt = tid; tt < tc; tt += blockDim.x) {
      const float d = db[(t0 + tt) * st.dt[1]];
      dts[tt] = d;
      das[tt] = expf(d * a_h);
    }
    __syncthreads();

    for (int tt = 0; tt < tc; ++tt) {
      const float da = das[tt];
      const float xd = xs[tt * p_pad + p] * dts[tt];
      const float4* b4 = reinterpret_cast<const float4*>(bs + tt * LDN + g * (NS + 4));
      const float4* c4 = reinterpret_cast<const float4*>(cs + tt * LDN + g * (NS + 4));
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
        const float4 bv = b4[j];
        const float4 cv = c4[j];
        s[4 * j + 0] = fmaf(xd, bv.x, s[4 * j + 0] * da);
        s[4 * j + 1] = fmaf(xd, bv.y, s[4 * j + 1] * da);
        s[4 * j + 2] = fmaf(xd, bv.z, s[4 * j + 2] * da);
        s[4 * j + 3] = fmaf(xd, bv.w, s[4 * j + 3] * da);
        acc = fmaf(s[4 * j + 0], cv.x, acc);
        acc = fmaf(s[4 * j + 1], cv.y, acc);
        acc = fmaf(s[4 * j + 2], cv.z, acc);
        acc = fmaf(s[4 * j + 3], cv.w, acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (g == 0) ys[tt * p_pad + p] = acc;
    }
    __syncthreads();
    for (int e = tid; e < tc * P; e += blockDim.x) {
      const int tt = e / P, pp = e - tt * P;
      yb[static_cast<long long>(t0 + tt) * H * P + pp] = ys[tt * p_pad + pp];
    }
  }

  if (p < P) {
    float* so = state_out + ((static_cast<long long>(b) * H + h) * P + p) * N;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int n = g * NS + j;
      if (n < N) so[n] = s[j];
    }
  }
}


// ------------------------------------------- bf16 route (tensor cores)
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kQ = 32;          // steps per chunk (one lane each in the scan)
constexpr int kStages = 2;      // chunks in the shared ring
constexpr int kLDM = kQ + 8;    // bf16 row stride of the M tiles
constexpr int kMaxWarps = 8;    // P <= 128

__host__ __device__ constexpr int ld_of(int cols) { return cols + 8; }  // 16 bytes of padding

// Shared bytes of one stage (x, B, C as bf16, dt as fp32) and of the block.
__host__ __device__ constexpr int stage_bytes(int pp, int np) {
  return 2 * kQ * ld_of(pp) + 4 * kQ * ld_of(np) + 4 * kQ;
}
__host__ __device__ constexpr int smem_bytes(int pp, int np) {
  return kStages * stage_bytes(pp, np) + 4 * kQ * kLDM;
}

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::mma_bf16;
using repro::smem_addr;
using repro::split_bf16;

// ldmatrix fragments of a shared bf16 tile, one row address per lane
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  repro::ldsm_x4(r, smem_addr(p));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  repro::ldsm_x4_trans(r, smem_addr(p));
}
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Queue rows [t0, t0 + kQ) of a (S, cols) bf16 matrix with row stride
// `stride` elements into a shared tile of row stride ld_of(pad); rows past
// S read as zeros, columns cols..pad are never written (they stay zero).
template <bool kAligned>
__device__ __forceinline__ void stage_rows(bf16* tile, int ld, const bf16* src, long long stride,
                                           int t0, int S, int cols) {
  if (kAligned) {  // 16-byte pieces: cols % 8 == 0, 16-byte addresses and strides
    const int ch = cols / 8;
    for (int e = threadIdx.x; e < kQ * ch; e += blockDim.x) {
      const int r = e / ch, c = e - r * ch;
      const bool ok = t0 + r < S;
      cp_async16(smem_addr(tile + r * ld + 8 * c), ok ? src + (t0 + r) * stride + 8 * c : src, ok);
    }
  } else {         // element by element (a view off 16 bytes, or P or N off 8)
    for (int e = threadIdx.x; e < kQ * cols; e += blockDim.x) {
      const int r = e / cols, c = e - r * cols;
      tile[r * ld + c] = t0 + r < S ? src[(t0 + r) * stride + c] : __float2bfloat16(0.f);
    }
  }
}

// NK: N padded to 16 NK.  Block: ceil(P / 16) warps, one per 16 rows p.
template <int NK, bool kAligned>
__global__ void __launch_bounds__(32 * kMaxWarps)
ssd_chunk_bf16_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ bm,
                  const bf16* __restrict__ cm, float* __restrict__ y,
                  float* __restrict__ state_out, int S, int H, int P, int N, Strides st) {
  constexpr int NP = 16 * NK;
  constexpr int LDN = NP + 8;
  const int nw = blockDim.x / 32;
  const int pp = 16 * nw;
  const int ldx = ld_of(pp);
  const int sbytes = stage_bytes(pp, NP);
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  bf16* m_hi = reinterpret_cast<bf16*>(smem + kStages * sbytes);   // kQ x kLDM
  bf16* m_lo = m_hi + kQ * kLDM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float a_h = A[h];
  const bf16* xb = x + b * st.x[0] + h * st.x[2];
  const float* db = dt + b * st.dt[0] + h * st.dt[2];
  const bf16* bb = bm + b * st.bm[0];
  const bf16* cb = cm + b * st.cm[0];

  // the padding of every tile stays zero
  for (int i = tid; i < kStages * sbytes / 16; i += blockDim.x) {
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  auto tiles = [&](int stage, bf16*& xs, bf16*& bs, bf16*& cs, float*& dts) {
    char* base = smem + stage * sbytes;
    xs = reinterpret_cast<bf16*>(base);
    bs = xs + kQ * ldx;
    cs = bs + kQ * LDN;
    dts = reinterpret_cast<float*>(cs + kQ * LDN);
  };
  auto issue = [&](int chunk) {
    bf16 *xs, *bs, *cs;
    float* dts;
    tiles(chunk % kStages, xs, bs, cs, dts);
    const int t0 = chunk * kQ;
    stage_rows<kAligned>(xs, ldx, xb, st.x[1], t0, S, P);
    stage_rows<kAligned>(bs, LDN, bb, st.bm[1], t0, S, N);
    stage_rows<kAligned>(cs, LDN, cb, st.cm[1], t0, S, N);
    for (int r = tid; r < kQ; r += blockDim.x) {
      const bool ok = t0 + r < S;
      cp_async4(smem_addr(dts + r), ok ? db + (t0 + r) * st.dt[1] : db, ok);
    }
  };

  float state[2 * NK][4];  // rows 16 warp + g (+8), columns 8 j + 2 t4 (+1)
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) state[j][e] = 0.f;

  const int n_chunks = (S + kQ - 1) / kQ;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) issue(c);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk + kStages - 1 < n_chunks) issue(chunk + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // this chunk landed in every thread's copies
    bf16 *xs, *bs, *cs;
    float* dts;
    tiles(chunk % kStages, xs, bs, cs, dts);
    const int t0 = chunk * kQ;

    // cs_t (lane t): the sum of dt * A over steps 0..t of the chunk, added
    // in step order, so that the zero steps past S leave cs_last equal to
    // the last step's cs bit for bit (a tree scan would round it apart,
    // and exp(cs_last - cs_t) would miss 1 by |cs| * 2^-24)
    const float dt_l = dts[lane];
    const float da_l = dt_l * a_h;
    float cum = 0.f;
#pragma unroll
    for (int t = 0; t < kQ; ++t) {
      const float v = __shfl_sync(0xffffffffu, da_l, t);
      if (t <= lane) cum += v;
    }
    const float cs_last = __shfl_sync(0xffffffffu, cum, kQ - 1);

    // y = exp(cs) o (C . state^T): the state's accumulators are the B
    // fragments (n = p), split into hi + lo
    float acc[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int pg = 0; pg < 2; ++pg)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][pg][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      uint32_t hi[2][2], lo[2][2];   // [p group][b0 | b1]
#pragma unroll
      for (int pg = 0; pg < 2; ++pg)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float* sv = state[2 * ks + q];
          split_bf16(sv[2 * pg], sv[2 * pg + 1], hi[pg][q], lo[pg][q]);
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, cs + (16 * mt + (lane & 15)) * LDN + 16 * ks + 8 * (lane >> 4));
#pragma unroll
        for (int pg = 0; pg < 2; ++pg) {
          mma_bf16(acc[mt][pg], a, lo[pg][0], lo[pg][1]);
          mma_bf16(acc[mt][pg], a, hi[pg][0], hi[pg][1]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float e = expf(__shfl_sync(0xffffffffu, cum, 16 * mt + g + 8 * r));
#pragma unroll
        for (int pg = 0; pg < 2; ++pg) {
          acc[mt][pg][2 * r] *= e;
          acc[mt][pg][2 * r + 1] *= e;
        }
      }

    // M = (C . B^T) o L o dt on the three 16 x 16 blocks on or below the
    // diagonal, split into hi + lo through shared memory
    for (int u = warp; u < 3; u += nw) {
      const int mi = u == 0 ? 0 : 1;
      const int kj = u == 2 ? 1 : 0;
      float gacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        uint32_t a[4], bk[4];
        ldsm_x4(a, cs + (16 * mi + (lane & 15)) * LDN + 16 * ks + 8 * (lane >> 4));
        ldsm_x4(bk, bs + (16 * kj + (lane & 7) + 8 * (lane >> 4)) * LDN + 16 * ks +
                        8 * ((lane >> 3) & 1));
        mma_bf16(gacc[0], a, bk[0], bk[1]);
        mma_bf16(gacc[1], a, bk[2], bk[3]);
      }
      float cs_i[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) cs_i[r] = __shfl_sync(0xffffffffu, cum, 16 * mi + g + 8 * r);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        float cs_j[2], dt_j[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 16 * kj + 8 * nn + 2 * t4 + e;
          cs_j[e] = __shfl_sync(0xffffffffu, cum, j);
          dt_j[e] = __shfl_sync(0xffffffffu, dt_l, j);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 16 * mi + g + 8 * r;
          const int j = 16 * kj + 8 * nn + 2 * t4;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = j + e <= i ? gacc[nn][2 * r + e] * expf(cs_i[r] - cs_j[e]) * dt_j[e] : 0.f;
          }
          uint32_t vh, vl;
          split_bf16(v[0], v[1], vh, vl);
          *reinterpret_cast<uint32_t*>(m_hi + i * kLDM + j) = vh;
          *reinterpret_cast<uint32_t*>(m_lo + i * kLDM + j) = vl;
        }
      }
    }
    __syncthreads();  // M is complete

    // y += M . X (X: rows j, columns p of this warp)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int ks = 0; ks <= mt; ++ks) {
        uint32_t ah[4], al[4], xv[4];
        const int mo = (16 * mt + (lane & 15)) * kLDM + 16 * ks + 8 * (lane >> 4);
        ldsm_x4(ah, m_hi + mo);
        ldsm_x4(al, m_lo + mo);
        ldsm_x4_trans(xv, xs + (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldx +
                              16 * warp + 8 * (lane >> 4));
#pragma unroll
        for (int pg = 0; pg < 2; ++pg) {
          mma_bf16(acc[mt][pg], al, xv[2 * pg], xv[2 * pg + 1]);
          mma_bf16(acc[mt][pg], ah, xv[2 * pg], xv[2 * pg + 1]);
        }
      }
    }
    // write y: rows t0 + i < S, columns p < P
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = t0 + 16 * mt + g + 8 * r;
        if (t < S) {
          float* yr = y + ((static_cast<long long>(b) * S + t) * H + h) * P;
#pragma unroll
          for (int pg = 0; pg < 2; ++pg) {
            const int p = 16 * warp + 8 * pg + 2 * t4;
            const float v0 = acc[mt][pg][2 * r], v1 = acc[mt][pg][2 * r + 1];
            if (p + 1 < P && (P & 1) == 0) {
              *reinterpret_cast<float2*>(yr + p) = make_float2(v0, v1);
            } else {
              if (p < P) yr[p] = v0;
              if (p + 1 < P) yr[p + 1] = v1;
            }
          }
        }
      }

    // state = exp(cs_last) state + (X o exp(cs_last - cs) dt)^T . B
    const float decay = expf(cs_last);
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) state[j][e] *= decay;
    const float w_l = expf(cs_last - cum) * dt_l;   // step `lane`'s weight
#pragma unroll
    for (int ks = 0; ks < kQ / 16; ++ks) {
      uint32_t xa[4], ahi[4], alo[4];
      ldsm_x4_trans(xa, xs + (16 * ks + (lane & 7) + 8 * (lane >> 4)) * ldx + 16 * warp +
                            8 * ((lane >> 3) & 1));
      const float w0 = __shfl_sync(0xffffffffu, w_l, 16 * ks + 2 * t4);
      const float w1 = __shfl_sync(0xffffffffu, w_l, 16 * ks + 2 * t4 + 1);
      const float w8 = __shfl_sync(0xffffffffu, w_l, 16 * ks + 8 + 2 * t4);
      const float w9 = __shfl_sync(0xffffffffu, w_l, 16 * ks + 9 + 2 * t4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {   // a0/a1 columns j, j + 1; a2/a3 j + 8, j + 9
        const float2 v = unpack(xa[q]);
        split_bf16(v.x * (q < 2 ? w0 : w8), v.y * (q < 2 ? w1 : w9), ahi[q], alo[q]);
      }
#pragma unroll
      for (int np = 0; np < NK; ++np) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, bs + (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDN + 16 * np +
                              8 * (lane >> 4));
        mma_bf16(state[2 * np], alo, bv[0], bv[1]);
        mma_bf16(state[2 * np], ahi, bv[0], bv[1]);
        mma_bf16(state[2 * np + 1], alo, bv[2], bv[3]);
        mma_bf16(state[2 * np + 1], ahi, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the stage and M are consumed
  }
  cp_async_wait<0>();

  // the final state: rows p < P, columns n < N
  float* so = state_out + (static_cast<long long>(b) * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 16 * warp + g + 8 * r;
      const int n = 8 * j + 2 * t4;
      if (p < P) {
        float* row = so + static_cast<long long>(p) * N;
        if (n + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<float2*>(row + n) = make_float2(state[j][2 * r], state[j][2 * r + 1]);
        } else {
          if (n < N) row[n] = state[j][2 * r];
          if (n + 1 < N) row[n + 1] = state[j][2 * r + 1];
        }
      }
    }
}

}  // namespace tc

cudaError_t launch_fp32(const float* x, const float* dt, const float* A, const float* bm,
                        const float* cm, float* y, float* state, int B, int S, int H, int P,
                        int N, const Strides& st, cudaStream_t s) {
  auto go = [&](auto kernel, int smem_floats) {
    const int smem = smem_floats * static_cast<int>(sizeof(float));
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(H, B), kG * ceil8(P), smem, s>>>(x, dt, A, bm, cm, y, state, S, H, P, N, st);
    return cudaGetLastError();
  };
  const int p_pad = ceil8(P);
  if (N <= kG * 8) return go(ssd_scan_kernel<8>, smem_floats_for<8>(p_pad));
  if (N <= kG * 16) return go(ssd_scan_kernel<16>, smem_floats_for<16>(p_pad));
  return go(ssd_scan_kernel<32>, smem_floats_for<32>(p_pad));
}

template <int NK, bool kAligned>
cudaError_t launch_tc(const void* x, const float* dt, const float* A, const void* bm,
                      const void* cm, float* y, float* state, int B, int S, int H, int P, int N,
                      const Strides& st, cudaStream_t s) {
  const int nw = (P + 15) / 16;
  const int smem = tc::smem_bytes(16 * nw, 16 * NK);
  auto kernel = tc::ssd_chunk_bf16_tc<NK, kAligned>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), 32 * nw, smem, s>>>(
      static_cast<const tc::bf16*>(x), dt, A, static_cast<const tc::bf16*>(bm),
      static_cast<const tc::bf16*>(cm), y, state, S, H, P, N, st);
  return cudaGetLastError();
}

template <bool kAligned>
cudaError_t dispatch_tc(const void* x, const float* dt, const float* A, const void* bm,
                        const void* cm, float* y, float* state, int B, int S, int H, int P,
                        int N, const Strides& st, cudaStream_t s) {
  if (N <= 16) return launch_tc<1, kAligned>(x, dt, A, bm, cm, y, state, B, S, H, P, N, st, s);
  if (N <= 32) return launch_tc<2, kAligned>(x, dt, A, bm, cm, y, state, B, S, H, P, N, st, s);
  if (N <= 64) return launch_tc<4, kAligned>(x, dt, A, bm, cm, y, state, B, S, H, P, N, st, s);
  return launch_tc<8, kAligned>(x, dt, A, bm, cm, y, state, B, S, H, P, N, st, s);
}

bool on_16_bytes(const void* p, std::initializer_list<long long> strides, int elem_bytes) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (long long v : strides) {
    if ((v * elem_bytes) % 16) return false;
  }
  return true;
}

}  // namespace

// x: (B, S, H, P), bm and cm: (B, S, N), each bf16 if bf16 else fp32, with
// a contiguous last axis; dt: (B, S, H) fp32; A: (H,) fp32 contiguous.
// strides: a host array of 10 element strides, x (b, s, h), dt (b, s, h),
// bm (b, s), cm (b, s).  y: (B, S, H, P) fp32 and state: (B, H, P, N) fp32,
// both contiguous.  1 <= P <= 128, 1 <= N <= 128.  bf16 runs on the tensor
// cores, fp32 on the CUDA cores.  Returns a cudaError_t.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* bm,
                               const void* cm, void* y, void* state, int B, int S, int H, int P,
                               int N, const long long* strides, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (P < 1 || P > kMaxP || N < 1 || N > kG * 32) return cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.dt[i] = strides[3 + i];
  }
  for (int i = 0; i < 2; ++i) {
    st.bm[i] = strides[6 + i];
    st.cm[i] = strides[8 + i];
  }
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  if (!bf16) {
    return launch_fp32(static_cast<const float*>(x), dtf, Af, static_cast<const float*>(bm),
                       static_cast<const float*>(cm), yf, sf, B, S, H, P, N, st, s);
  }
  const bool aligned = P % 8 == 0 && N % 8 == 0 &&
                       on_16_bytes(x, {st.x[0], st.x[1], st.x[2]}, 2) &&
                       on_16_bytes(bm, {st.bm[0], st.bm[1]}, 2) &&
                       on_16_bytes(cm, {st.cm[0], st.cm[1]}, 2);
  return aligned ? dispatch_tc<true>(x, dtf, Af, bm, cm, yf, sf, B, S, H, P, N, st, s)
                 : dispatch_tc<false>(x, dtf, Af, bm, cm, yf, sf, B, S, H, P, N, st, s);
}
