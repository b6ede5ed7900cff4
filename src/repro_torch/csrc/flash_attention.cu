// GQA attention forward with an online softmax: the port of the Pallas
// kernel src/repro/kernels/flash_attention.py :: flash_attention (line 92,
// body `_kernel`), which the port's attention layer runs for every
// cache-free prefill.
//
// What it computes (the same as the Pallas kernel): q (B, H, Sq, d),
// k/v (B, K, Skv, d), H = K*G; query head h reads KV head h / G.  Scores
// are q . k / sqrt(d) in fp32; key j is visible to query i when j < Skv,
// and j <= i if causal, and i - j < window if a window is given.
// Positions count from 0 in both q and k, also when Sq != Skv.  Masked
// scores are NEG_INF = -1e30, a finite number: a query row whose first
// streamed block is wholly masked gathers exp(0) terms there, and the
// first block with a visible key wipes them out through
// alpha = exp(m_old - m_new) = 0, exactly as in the Pallas kernel (with
// -inf the rescale would be exp(-inf + inf) = NaN).  Blocks of keys
// wholly above the diagonal (causal) or wholly before the window of the
// block's first query are skipped: a zero rescale would wipe out their
// terms.  The output is acc / max(l, 1e-30), in q's type (the bf16 route
// multiplies by the reciprocal).
//
// Two routes, chosen by dtype:
//
// * bf16 (every config of the repo; the serve path) runs on the tensor
//   cores, `flash_fwd_bf16_tc` below.
// * fp32 keeps the CUDA-core kernel `flash_fwd` of the first port: its
//   products are fp32 FMAs, which the reduced fp32 configs need (their
//   card-vs-CPU logits are held to 1e-4, out of reach of bf16 operands),
//   and so do the fp32 cases of the kernel checks.
//
// What bounds the bf16 route on an H100: at qwen3-0.6b's prefill (B 8,
// H 16, K 8, S 512, d 64, causal) the work is 4*B*H*Sq*Skv*d / 2 =
// 4.3 GFLOP over 25 MB of q, k, v and o: 4.3 us at the 989 TFLOP/s bf16
// tensor-core peak, 7.5 us at 3.35 TB/s, so bytes bound the card.  At
// recurrentgemma-9b's (K 1, d 256, window 2048) 17.2 GFLOP over 71 MB:
// 21 us of bytes, 17 us of tensor-core time.  The split P below doubles
// the P.V products (to 6.4 and 25.8 GFLOP): still under the bytes.
//
// Design of the bf16 route, in the manner of FlashAttention-2:
//
// * One block of 4 warps per (64-query tile, head, batch), each warp
//   owning 16 query rows.  The grid's slowest axis is the query tile,
//   counted from the last: every head's causal tiles that see the most
//   keys start first, and the light ones fill the tail.
// * q, and tiles of k and v (64 rows; 32 at d 256), are staged as bf16 in
//   shared memory by 16-byte `cp.async` copies (zero-filled past Sq /
//   Skv) into a ring of two stages, so the next K/V tile loads while this
//   one is used.  Rows are padded by 16 bytes, which keeps `ldmatrix` free
//   of bank conflicts.  At d 256 the 32-key tile keeps a block at 101 KB
//   (two per SM) and the O accumulator (16 x 256 fp32 a warp, 128
//   registers a lane) beside S without spilling.
// * S = Q.K^T by `mma.sync.m16n8k16` (bf16 in, fp32 accumulate), Q and K
//   fragments from `ldmatrix`.  The scale is applied to S in fp32 after
//   the product, folded with log2 e so that P = 2^(s - m) is one
//   `ex2.approx`: the Pallas kernel scales q in fp32 first, which a bf16
//   operand cannot carry at d 32 or 128 without rounding.  The two differ
//   by one fp32 rounding per score, and ex2.approx by ~2^-22 relative.
// * The softmax runs on S's accumulator fragment in registers.  A lane
//   holds rows r and r + 8 of its warp's 16 (r = lane / 4) and columns
//   2 (lane % 4) + {0, 1} of each 8-key slice; the mask follows that
//   layout, and is evaluated only on tiles that a warp's rows do not
//   wholly see (the diagonal, the window's edge, the ragged tail).  The
//   running max m and the row sum l are fp32, reduced over the 4 lanes of
//   a quad with shuffles.
// * P never leaves registers: S's accumulator fragment is the A fragment
//   of P.V.  P is split into hi = bf16(p) and lo = bf16(p - hi), and both
//   are multiplied with the same bf16 V fragment (`ldmatrix.trans`).  A
//   single bf16 P keeps 8 bits of each weight: on random inputs 9-11% of
//   the outputs then leave one bf16 step (rtol 2^-7) of the exact
//   softmax, while hi + lo carries 16 bits and stays within it
//   (tests/test_torch_kernels.py emulates both).
// * O is staged through the block's q tile and written as 16-byte rows.
//   No atomics: two launches are bitwise equal.
//
// The fp32 route (`flash_fwd`): one 256-thread block per (64 query rows,
// h, b) stages its q rows (scaled, fp32) in shared memory and streams
// 64-row K/V blocks through it; thread (ty, tx) of a 16 x 16 grid owns
// query rows 4 ty .. 4 ty + 3 and key columns tx + 16 j of the score
// tile, and output columns tx + 16 c; P goes through shared memory for
// P.V.  Its ceiling is the 67 TFLOP/s fp32 CUDA-core peak.
//
// Head dims: one template per d in {16, 32, 64, 128, 256} on both routes.
// Shared memory of the bf16 route: (64 + 4 BK) rows of d + 8 bf16,
// 101,376 bytes at d 256; of the fp32 route 215,296 bytes at d 256.
// ptxas's register and spill report for every kernel is printed by
// chip_smoke.py's build phase, with the count of tensor-core instructions
// in each.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;        // key rows per streamed block
constexpr float kNegInf = -1e30f;

// Element strides of the batch, head and sequence axes (the last axis is
// contiguous).
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// ------------------------------------------------ fp32 route (CUDA cores)
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kLDP = kBK + 4;  // shared stride of the P tile

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 4) + kBK * (D + 1) + kBK * D + kBQ * kLDP;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int H, int G, int Sq,
          int Skv, Strides st, float scale, int causal, int window) {
  constexpr int LDQ = D + 4;  // two row groups of a warp land 16 banks apart
  constexpr int LDK = D + 1;  // 16 key rows of one column on 16 banks
  constexpr int C = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // kBQ x LDQ
  float* ks = qs + kBQ * LDQ;   // kBK x LDK
  float* vs = ks + kBK * LDK;   // kBK x D
  float* ps = vs + kBK * D;     // kBQ x kLDP

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / G;
  const float* qp = q + b * st.q[0] + h * st.q[1];
  const float* kp = k + b * st.k[0] + kh * st.k[1];
  const float* vp = v + b * st.v[0] + kh * st.v[1];
  float* op = o + b * st.o[0] + h * st.o[1];

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int pos = q0 + r;
    qs[r * LDQ + c] = pos < Sq ? qp[pos * st.q[2] + c] * scale : 0.f;
  }

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = kv_begin / kBK * kBK; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // q is staged; the previous K/V/P tiles are consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int pos = k0 + r;
      const bool ok = pos < Skv;  // the ragged tail reads as zeros
      ks[r * LDK + c] = ok ? kp[pos * st.k[2] + c] : 0.f;
      vs[r * D + c] = ok ? vp[pos * st.v[2] + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * LDQ + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LDK + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * kLDP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kLDP + j];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float vv = vs[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos < Sq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < C; ++c) op[qpos * st.o[2] + tx + 16 * c] = acc[i][c] / den;
    }
  }
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int K, int Sq, int Skv, const Strides& st, int causal, int window,
                        cudaStream_t s) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd<D><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, H / K, Sq, Skv, st,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))),  // as the Pallas kernel's
      causal, window);
  return cudaGetLastError();
}

// ------------------------------------------- bf16 route (tensor cores)
using bf16 = __nv_bfloat16;

template <int D>
struct TcCfg {
  static constexpr int BQ = 64;                // query rows per block
  static constexpr int BK = D >= 256 ? 32 : 64;  // key rows per streamed tile
  static constexpr int STAGES = 2;             // K/V tiles in the ring
  static constexpr int kWarps = BQ / 16;       // a warp per 16 query rows
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int LD = D + 8;             // bf16 row stride: 16 bytes of padding
  static constexpr int NO = D / 8;             // 8-column slices of O per warp
  static constexpr int NS = BK / 8;            // 8-key slices of S per warp
  static constexpr int SMEM = (BQ + 2 * STAGES * BK) * LD * 2;  // q; the K/V ring
};

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma_bf16;
using repro::smem_addr;
using repro::split_bf16;

// 2^x (MUFU.EX2; relative error ~2^-22, subnormal results flushed to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Stage rows [row0, row0 + ROWS) of a (rows, D) bf16 matrix with row
// stride `stride` elements into a shared tile; rows >= n_rows read as
// zeros.
template <int D, int ROWS>
__device__ __forceinline__ void stage_tile(bf16* tile, const bf16* src, long long stride,
                                           int row0, int n_rows) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int NT = TcCfg<D>::kThreads;
  static_assert(ROWS * CH % NT == 0, "every thread copies the same number of chunks");
  // thread t copies chunk t % CH of rows t / CH + j NT / CH
  const int c = threadIdx.x % CH;
  const int r0 = threadIdx.x / CH;
#pragma unroll
  for (int j = 0; j < ROWS * CH / NT; ++j) {
    const int r = r0 + j * (NT / CH);
    const bool ok = row0 + r < n_rows;
    const bf16* g = ok ? src + static_cast<long long>(row0 + r) * stride + c * 8 : src;
    cp_async16(smem_addr(tile + r * TcCfg<D>::LD + c * 8), g, ok);
  }
}

// The bound names one block per SM as the floor: given the threads alone,
// ptxas cut d 32 to 80 registers and spilled.
template <int D>
__global__ void __launch_bounds__(TcCfg<D>::kThreads, 1)
flash_fwd_bf16_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int H, int G, int Sq,
                  int Skv, Strides st, float scale_log2, int causal, int window) {
  using C = TcCfg<D>;
  constexpr int LD = C::LD, BQ = C::BQ, BK = C::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* ks = qs + BQ * LD;                       // STAGES x BK x LD
  bf16* vs = ks + C::STAGES * BK * LD;           // STAGES x BK x LD

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;  // query rows 16 warp ..
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the heaviest tiles first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kh = h / G;
  const bf16* qp = q + b * st.q[0] + h * st.q[1];
  const bf16* kp = k + b * st.k[0] + kh * st.k[1];
  const bf16* vp = v + b * st.v[0] + kh * st.v[1];
  bf16* op = o + b * st.o[0] + h * st.o[1];

  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / BK;
  const int t_end = (kv_end + BK - 1) / BK;

  // the ring: tile t_begin + r sits in stage r % STAGES; a group of
  // copies per tile (q rides with the first), STAGES - 1 tiles ahead
  stage_tile<D, BQ>(qs, qp, st.q[2], q0, Sq);
#pragma unroll
  for (int r = 0; r < C::STAGES - 1; ++r) {
    if (t_begin + r < t_end) {
      stage_tile<D, BK>(ks + r * BK * LD, kp, st.k[2], (t_begin + r) * BK, Skv);
      stage_tile<D, BK>(vs + r * BK * LD, vp, st.v[2], (t_begin + r) * BK, Skv);
    }
    cp_async_commit();
  }

  // this lane's rows (of the warp's 16) and the column pair it holds in
  // each 8-column slice of an accumulator fragment
  const int w_first = q0 + 16 * warp;
  const int r_lo = w_first + (lane >> 2);
  const int r_hi = r_lo + 8;
  const int cpair = 2 * (lane & 3);
  // ldmatrix row addresses: lane l feeds row (l & 15) of the q tile at
  // column 8 (l >> 4); row (l & 7) + 8 (l >> 4) of a k tile at column
  // 8 ((l >> 3) & 1); row (l & 7) + 8 ((l >> 3) & 1) of a v tile at
  // column 8 (l >> 4)
  const uint32_t q_addr =
      smem_addr(qs + (16 * warp + (lane & 15)) * LD + 8 * (lane >> 4));
  const int k_off = ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
  const int v_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);

  // m: running max of the scores in log2 units (score * scale * log2 e)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[C::NO][4];
#pragma unroll
  for (int n = 0; n < C::NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) % C::STAGES;
    const int ahead = t + C::STAGES - 1;
    if (ahead < t_end) {
      const int at = (ahead - t_begin) % C::STAGES;
      stage_tile<D, BK>(ks + at * BK * LD, kp, st.k[2], ahead * BK, Skv);
      stage_tile<D, BK>(vs + at * BK * LD, vp, st.v[2], ahead * BK, Skv);
    }
    cp_async_commit();
    cp_async_wait<C::STAGES - 1>();  // q and this tile have landed
    __syncthreads();

    // S = Q . K^T: 16 rows x BK keys per warp, in 8-key slices
    float s[C::NS][4];
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const uint32_t k_addr = smem_addr(ks + stage * BK * LD + k_off);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_addr + kk * 32);
#pragma unroll
      for (int jj = 0; jj < C::NS / 2; ++jj) {
        uint32_t bk[4];
        ldsm_x4(bk, k_addr + (jj * 16 * LD + kk * 16) * 2);
        mma_bf16(s[2 * jj], a, bk[0], bk[1]);
        mma_bf16(s[2 * jj + 1], a, bk[2], bk[3]);
      }
    }

    // scale (log2 units), mask, online softmax.  Element e of slice j is
    // row (e < 2 ? r_lo : r_hi), key t BK + 8 j + cpair + (e & 1); the
    // mask is evaluated only on tiles that the warp's rows do not wholly see.
    const int k0 = t * BK;
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > w_first) ||
                      (window > 0 && w_first + 15 - k0 >= window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int qpos = e < 2 ? r_lo : r_hi;
          const int kpos = k0 + 8 * j + cpair + (e & 1);
          bool ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          if (!ok) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2_approx(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_approx(s[j][e] - mx[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];  // this lane's share
#pragma unroll
    for (int n = 0; n < C::NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P . V, 16 keys a step; P = hi + lo, each against the same V
    const uint32_t v_addr = smem_addr(vs + stage * BK * LD + v_off);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int nn = 0; nn < C::NO / 2; ++nn) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_addr + (kk * 16 * LD + nn * 16) * 2);
        mma_bf16(acc[2 * nn], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * nn], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * nn + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * nn + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is refilled STAGES - 1 tiles on
  }
  cp_async_wait<0>();

  // the row sums over the quad; O / max(l, 1e-30) through the q tile, as
  // O times 1 / max(l, 1e-30) from MUFU.RCP (~1 ulp; a division per element
  // would carry its slow-path call into the kernel)
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(inv[i]) : "f"(fmaxf(l[i], 1e-30f)));
  }
  __syncthreads();  // every warp is done with the q tile
  bf16* orow = qs + (16 * warp + (lane >> 2)) * LD + cpair;
#pragma unroll
  for (int n = 0; n < C::NO; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
        __floats2bfloat162_rn(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(orow + 8 * LD + 8 * n) =
        __floats2bfloat162_rn(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncthreads();
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < BQ * CH; i += C::kThreads) {
    const int r = i / CH, c = i % CH;
    if (q0 + r < Sq)
      *reinterpret_cast<uint4*>(op + static_cast<long long>(q0 + r) * st.o[2] + c * 8) =
          *reinterpret_cast<const uint4*>(qs + r * LD + c * 8);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int K, int Sq, int Skv, const Strides& st, int causal, int window,
                        cudaStream_t s) {
  using C = TcCfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Sq + C::BQ - 1) / C::BQ);
  // the Pallas kernel's 1/sqrt(d), times log2(e): P = 2^(s log2(e) / sqrt(d) - m)
  const double scale_log2 = 1.4426950408889634 / sqrt(static_cast<double>(D));
  flash_fwd_bf16_tc<D><<<grid, C::kThreads, C::SMEM, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, H / K, Sq, Skv, st, static_cast<float>(scale_log2), causal,
      window);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, void* o, int B,
                       int H, int K, int Sq, int Skv, const Strides& st, int causal,
                       int window, cudaStream_t s) {
#define REPRO_FLASH_CASE(DIM)                                                               \
  case DIM:                                                                                 \
    return BF16 ? launch_bf16<DIM>(q, k, v, o, B, H, K, Sq, Skv, st, causal, window, s)     \
                : launch_fp32<DIM>(q, k, v, o, B, H, K, Sq, Skv, st, causal, window, s);
  switch (d) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    REPRO_FLASH_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

// q, o: (B, H, Sq, d); k, v: (B, K, Skv, d); all bf16 if bf16 else fp32,
// each with a contiguous last axis and the element strides of its first
// three axes in `strides` (a host array of 12: q, k, v, o).  On the bf16
// route every pointer and stride is a multiple of 16 bytes (the wrapper
// checks).  d is 16, 32, 64, 128 or 256 (the head dims of the configs and
// of their reduced versions); window <= 0 means none.  Returns a
// cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int K, int Sq, int Skv, int d,
                                      const long long* strides, int causal, int window,
                                      int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Sq <= 0) return cudaSuccess;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  return bf16 ? dispatch_d<true>(d, q, k, v, o, B, H, K, Sq, Skv, st, causal, window, s)
              : dispatch_d<false>(d, q, k, v, o, B, H, K, Sq, Skv, st, causal, window, s);
}
