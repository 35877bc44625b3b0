// The backward of banded causal sliding-window attention on Hopper's own
// tensor-core path: K7's gradient for bfloat16 heads with hd % 8 == 0 and
// hd <= 128, wgmma fed by TMA.
//
// Replaces: the gradient that JAX takes of the reference's banded attention
// (src/repro/models/layers.py, attention(swa_banded=True)); the TPU kernel
// src/repro/kernels/flash_swa/kernel.py::flash_swa has no backward.  The
// wrapper (kernel.py::flash_swa_bwd) routes by dtype and head width alone:
// bf16 heads that are not a multiple of 8 keep flash_swa_bwd_mma.cu
// (mma.sync), float32 and wider heads flash_swa_bwd.cu.
//
// Computes what flash_swa_bwd_mma.cu computes, with the same arithmetic
// (D = sum(dout * out), P = exp2(S scale log2 e - lse log2 e) in the band,
// dS = P (dP - D) in f32; P and dS split into bf16 hi and lo halves for
// P^T dO, dS K and dS^T Q, both halves into one f32 accumulator; scale on
// the dq and dk sums; the outputs rounded to bf16 once), for q, out, dout,
// dq [B, S, H, hd] and k, v, dk, dv [B, S, Hkv, hd] in bfloat16, lse [B,
// H, S] float32.  Only the order of the f32 sums inside a product differs.
//
// Bound on the H100: operations, 10 hd flop per (query, key) pair of the
// band and head; at Danube's training shape (S 8,192, window 4,096, 32
// heads of 120) 0.97 TFLOP, 0.98 ms at 989 TFLOP/s.  The two kernels
// execute about 2x that (chip_smoke.py::bwd_wgmma_executed_flop): both
// recompute Q K^T and dO V^T, the three split products run twice, Q K^T
// and dO V^T run over the head padded to 128, and the band's edge tiles
// are computed whole and masked.
//
// Design: the two-kernel, no-atomics structure of flash_swa_bwd_mma.cu, so
// that two runs give the same bits, each kernel warp-specialised as
// flash_swa_wgmma.cu is (warpgroup 0 a TMA producer, warpgroups 1 and 2
// consumers, mbarrier rings; 4-D tensor maps (hd, heads, S, B) read in
// boxes of 64 head columns, zeros past hd and past S; tiles sized to the
// 168 registers a thread that ptxas allocates in a 384-thread CTA):
// * dq_kernel, one CTA per (128-row query tile, head, batch), the heads
//   fastest and the query tiles last to first, as the forward's grid.  The
//   consumers first compute D for their rows (from global memory; written
//   to the D scratch for the second kernel), while the producer loads the Q
//   and dO tiles once and then the band's 64-row K and V tiles, each with
//   its own barriers.  Per KV tile: S = Q K^T and dP = dO V^T (wgmma
//   m64n64k16, all operands in shared memory, K and V K-major), P and dS in
//   the accumulator registers, dS packed into A fragments (hi, lo) for dQ
//   += dS K with K read again as an MN-major B (one load, two
//   descriptors);
// * dkdv_kernel, one CTA per (64-row KV tile, KV head, batch), launched
//   after dq_kernel on the stream (it reads D), the KV tiles fastest.  The
//   producer loads K and V once, then for each query head of the group in
//   order, each 64-row query tile of the band [kt, min(S - 1, kt + 63 +
//   window - 1)]: Q and dO by TMA and their rows' lse and D by the
//   producer warp's 32 lanes (plain loads into the stage, then an arrive on
//   the stage's full barrier, which counts the TMA bytes and 33 arrivals).
//   The two consumer warpgroups split the gradient, not the rows: the
//   first computes S^T = K Q^T (m64n64k16), P^T, and dV += P^T dO; the
//   second S^T, dP^T = V dO^T, dS^T (lse and D read by query column) and
//   dK += dS^T Q; both A from registers (split) and dO, Q as MN-major B, so
//   one TMA load of a Q or dO tile serves its K-major and MN-major reads.
//   Each keeps one 64 x hd f32 accumulator (64 registers) for the whole
//   walk: dK and dV together in one warpgroup (128) beside S^T and dP^T
//   (64) would pass the 168 registers ptxas gives a thread (it spilled and
//   serialised the wgmmas).  That costs S^T twice, one more product in 7.
//   The GQA sum over the group's heads happens in the CTA, in a fixed
//   order;
// * the mask runs only on tiles that cross the band's edges or S (per
//   warpgroup's 64 rows); the others are read whole.
#include <cuda.h>
#include <cuda_runtime.h>

#include "../../csrc/tma.cuh"
#include "../../csrc/wgmma.cuh"
#include "flash_swa_mma.cuh"

namespace {

using swa_mma::bf16;
using swa_mma::kFull;
using swa_mma::kLog2e;
using swa_mma::split;

constexpr int kRowBytes = 128;           // a box row: 64 bf16
constexpr int kConsumers = 2;            // consumer warpgroups of 64 rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 2;
constexpr int kBQ = 64 * kConsumers;     // query rows a dq CTA: 128
constexpr int kBK = 64;                  // KV rows a tile of its walk
constexpr int kBKV = 64;                 // key rows a dk/dv CTA
constexpr int kBQ2 = 64;                 // query rows a tile of its walk

__device__ __forceinline__ void bump(int& stage, uint32_t& phase) {
  if (++stage == kStages) {
    stage = 0;
    phase ^= 1;
  }
}

// P and dS halves as the A fragments of k16 step kk: n8 groups 2kk, 2kk+1
template <int kSteps>
__device__ __forceinline__ void split_all(const float (&c)[8 * kSteps],
                                          uint32_t (&hi)[kSteps][4],
                                          uint32_t (&lo)[kSteps][4]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
  }
}

// rows row0 + lane / 4 (+ 8) x columns < hd of acc (a warp's 16 rows),
// scaled and rounded to bf16, into dst (rows of `stride` elements)
template <int NO>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           size_t stride,
                                           const float (&acc)[NO / 2],
                                           int row0, int S, int hd,
                                           float scale) {
  const int lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + lane / 4 + half * 8;
    if (row >= S) continue;
    bf16* p = dst + static_cast<size_t>(row) * stride;
#pragma unroll
    for (int j = 0; j < NO / 8; ++j) {
      const int col = j * 8 + c0;
      if (col < hd) {                  // hd % 8 == 0: col + 1 < hd too
        *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * half] * scale, acc[4 * j + 2 * half + 1] * scale);
      }
    }
  }
}

// dq for one (128-row query tile, head, batch); writes D for its rows.
// DP: the head padded to 64 or 128 (DP / 64 boxes); NO: the head's width
// as a wgmma N (64, 120 or 128).
template <int DP, int NO>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap do_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const bf16* __restrict__ out, const bf16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ dsum,
              bf16* __restrict__ dq, int S, int H, int Hkv, int hd,
              int window, float scale) {
  constexpr int kBoxes = DP / 64;
  constexpr int kQBytes = kBoxes * kBQ * kRowBytes;      // Q or dO
  constexpr int kTileBytes = kBoxes * kBK * kRowBytes;   // K or V
  constexpr int kQSteps = DP / 16;
  constexpr int kSSteps = kBK / 16;                      // of dS K
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, full_k[kStages], full_v[kStages],
      empty_k[kStages], empty_v[kStages];
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* sdo = sq + kQBytes;
  unsigned char* sk = sdo + kQBytes;                     // [kStages]
  unsigned char* sv = sk + kStages * kTileBytes;         // [kStages]

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;    // last tile first
  const int hk = h / (H / Hkv);
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt0 = max(0, q0 - window + 1) / kBK * kBK;
  const int ntiles = (q_last - kt0) / kBK + 1;
  if (threadIdx.x == 0) {
    tma::mbar_init(&bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      tma::mbar_init(&full_k[s], 1);
      tma::mbar_init(&full_v[s], 1);
      tma::mbar_init(&empty_k[s], kConsumers * 128);
      tma::mbar_init(&empty_v[s], kConsumers * 128);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {   // producer
    if (threadIdx.x == 0) {
      tma::mbar_arrive_expect_tx(&bar_q, 2 * kQBytes);
      for (int x = 0; x < kBoxes; ++x) {
        tma::load_4d(sq + x * kBQ * kRowBytes, &q_map, &bar_q, x * 64, h, q0,
                     b);
        tma::load_4d(sdo + x * kBQ * kRowBytes, &do_map, &bar_q, x * 64, h,
                     q0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < ntiles; ++it) {
        const int kt = kt0 + it * kBK;
        tma::mbar_wait(&empty_k[stage], phase ^ 1);
        tma::mbar_arrive_expect_tx(&full_k[stage], kTileBytes);
        for (int x = 0; x < kBoxes; ++x)
          tma::load_4d(sk + stage * kTileBytes + x * kBK * kRowBytes, &k_map,
                       &full_k[stage], x * 64, hk, kt, b);
        tma::mbar_wait(&empty_v[stage], phase ^ 1);
        tma::mbar_arrive_expect_tx(&full_v[stage], kTileBytes);
        for (int x = 0; x < kBoxes; ++x)
          tma::load_4d(sv + stage * kTileBytes + x * kBK * kRowBytes, &v_map,
                       &full_v[stage], x * 64, hk, kt, b);
        bump(stage, phase);
      }
    }
    return;
  }

  const int tid = threadIdx.x - 128;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int r0 = q0 + wg * 64;
  const int ra = r0 + warp * 16 + lane / 4;   // rows ra and ra + 8
  const int c0 = 2 * (lane % 4);              // columns c0, c0 + 1
  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t row_off = (static_cast<size_t>(b) * H + h) * S;

  // D for the warp's 16 rows (row lane % 16; lanes l and l + 16 take
  // alternate 8-column chunks), then each lane's rows ra and ra + 8
  float dd[2], ll[2];
  {
    const int row = r0 + warp * 16 + lane % 16;
    float acc = 0.0f;
    if (row < S) {
      const size_t off = (static_cast<size_t>(b) * S + row) * q_stride +
                         static_cast<size_t>(h) * hd;
      for (int c = (lane / 16) * 8; c < hd; c += 16) {
        const uint4 a = *reinterpret_cast<const uint4*>(out + off + c);
        const uint4 g = *reinterpret_cast<const uint4*>(dout + off + c);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 af = __bfloat1622float2(a2[i]);
          const float2 gf = __bfloat1622float2(g2[i]);
          acc = fmaf(gf.x, af.x, acc);
          acc = fmaf(gf.y, af.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(kFull, acc, 16);
    if (lane < 16 && row < S) dsum[row_off + row] = acc;
    dd[0] = __shfl_sync(kFull, acc, lane / 4);
    dd[1] = __shfl_sync(kFull, acc, lane / 4 + 8);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ra + half * 8;
      ll[half] = r < S ? lse[row_off + r] * kLog2e : 0.0f;
    }
  }
  const float scale_log2 = scale * kLog2e;
  const uint64_t dqa = wgmma::desc_sw128(sq + wg * 64 * kRowBytes, 0, 1024);
  const uint64_t doa = wgmma::desc_sw128(sdo + wg * 64 * kRowBytes, 0, 1024);

  float s[kBK / 2], dp[kBK / 2], acc[NO / 2];
  uint32_t hi[kSSteps][4], lo[kSSteps][4];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) acc[i] = 0.0f;

  tma::mbar_wait(&bar_q, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < ntiles; ++it) {
    const int kt = kt0 + it * kBK;
    const unsigned char* ks = sk + stage * kTileBytes;
    const unsigned char* vs = sv + stage * kTileBytes;

    // S = Q K^T and dP = dO V^T
    tma::mbar_wait(&full_k[stage], phase);
    const uint64_t dkb = wgmma::desc_sw128(ks, 0, 1024);
    wgmma::fence_operands(s);
    wgmma::fence_operands(dp);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < kQSteps; ++kk) {
      const uint32_t off_a = (kk / 4) * kBQ * kRowBytes + (kk % 4) * 32;
      const uint32_t off_b = (kk / 4) * kBK * kRowBytes + (kk % 4) * 32;
      wgmma::mma_ss<kBK>(s, dqa + (off_a >> 4), dkb + (off_b >> 4), kk > 0);
    }
    tma::mbar_wait(&full_v[stage], phase);
    const uint64_t dvb = wgmma::desc_sw128(vs, 0, 1024);
#pragma unroll
    for (int kk = 0; kk < kQSteps; ++kk) {
      const uint32_t off_a = (kk / 4) * kBQ * kRowBytes + (kk % 4) * 32;
      const uint32_t off_b = (kk / 4) * kBK * kRowBytes + (kk % 4) * 32;
      wgmma::mma_ss<kBK>(dp, doa + (off_a >> 4), dvb + (off_b >> 4), kk > 0);
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(s);
    wgmma::fence_operands(dp);
    tma::mbar_arrive(&empty_v[stage]);

    // P, then dS = P (dP - D) in dp; masked only on the band's edge tiles
    const bool interior = kt + kBK - 1 <= r0 && kt >= r0 + 64 - window;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2f(s[4 * j + e] * scale_log2 - ll[e >> 1]);
        if (!interior) {
          const int col = kt + j * 8 + c0 + (e & 1);
          const int row = ra + (e >> 1) * 8;
          if (!(col <= row && col > row - window)) pr = 0.0f;
        }
        dp[4 * j + e] = pr * (dp[4 * j + e] - dd[e >> 1]);
      }
    }
    split_all<kSSteps>(dp, hi, lo);

    // dQ += dS_hi K + dS_lo K, K as an MN-major B, waited on before the
    // next tile's products: S, dP and dQ (32 + 32 + 64 registers) beside
    // dS's A fragments (32) would pass the 168 registers ptxas gives a
    // thread
    const uint64_t dkn = wgmma::desc_sw128(ks, kBK * kRowBytes, 1024);
    wgmma::fence_operands(acc);
    wgmma::fence_operands(hi);
    wgmma::fence_operands(lo);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < kSSteps; ++kk) {
      const uint64_t d = dkn + ((kk * 16 * kRowBytes) >> 4);
      wgmma::mma_rs<NO>(acc, hi[kk], d, 1);
      wgmma::mma_rs<NO>(acc, lo[kk], d, 1);
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(acc);
    wgmma::fence_operands(hi);
    wgmma::fence_operands(lo);
    tma::mbar_arrive(&empty_k[stage]);
    bump(stage, phase);
  }
  store_rows<NO>(dq + static_cast<size_t>(b) * S * q_stride +
                     static_cast<size_t>(h) * hd,
                 q_stride, acc, r0 + warp * 16, S, hd, scale);
}

// One consumer warpgroup of dkdv_kernel over the CTA's walk: kDK false
// accumulates dV += P^T dO, true dK += dS^T Q, for the CTA's 64 key rows.
template <int DP, int NO, bool kDK>
__device__ __forceinline__ void kv_consumer(
    const unsigned char* sk, const unsigned char* sv, const unsigned char* sq,
    const unsigned char* sdo, const float (*sl)[kBQ2],
    const float (*sd)[kBQ2], uint64_t* full, uint64_t* empty,
    bf16* __restrict__ dst, int kt, int nq, int steps, int S, int hd,
    int window, float scale, size_t kv_stride) {
  constexpr int kTileBytes = DP / 64 * kBQ2 * kRowBytes;   // Q or dO
  constexpr int kQSteps = DP / 16;
  constexpr int kSSteps = kBQ2 / 16;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int kr = kt + warp * 16 + lane / 4;   // key rows kr and kr + 8
  const int c0 = 2 * (lane % 4);              // query columns c0, c0 + 1
  const float scale_log2 = scale * kLog2e;
  const uint64_t dka = wgmma::desc_sw128(sk, 0, 1024);
  const uint64_t dva = wgmma::desc_sw128(sv, 0, 1024);

  float st[kBQ2 / 2], dpt[kBQ2 / 2], acc[NO / 2];
  uint32_t hi[kSSteps][4], lo[kSSteps][4];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) acc[i] = 0.0f;

  int stage = 0;
  uint32_t phase = 0;
  for (int step = 0; step < steps; ++step) {
    const int qs = kt + (step % nq) * kBQ2;
    const unsigned char* qt = sq + stage * kTileBytes;
    const unsigned char* dot = sdo + stage * kTileBytes;

    // S^T = K Q^T, and for dK dP^T = V dO^T, Q and dO K-major
    tma::mbar_wait(&full[stage], phase);
    const uint64_t dqb = wgmma::desc_sw128(qt, 0, 1024);
    const uint64_t dob = wgmma::desc_sw128(dot, 0, 1024);
    wgmma::fence_operands(st);
    if (kDK) wgmma::fence_operands(dpt);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < kQSteps; ++kk) {
      const uint32_t off_a = (kk / 4) * kBKV * kRowBytes + (kk % 4) * 32;
      const uint32_t off_b = (kk / 4) * kBQ2 * kRowBytes + (kk % 4) * 32;
      wgmma::mma_ss<kBQ2>(st, dka + (off_a >> 4), dqb + (off_b >> 4),
                          kk > 0);
    }
    if (kDK) {
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
        const uint32_t off_a = (kk / 4) * kBKV * kRowBytes + (kk % 4) * 32;
        const uint32_t off_b = (kk / 4) * kBQ2 * kRowBytes + (kk % 4) * 32;
        wgmma::mma_ss<kBQ2>(dpt, dva + (off_a >> 4), dob + (off_b >> 4),
                            kk > 0);
      }
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(st);
    if (kDK) wgmma::fence_operands(dpt);
    wgmma::fence_operands(acc);

    // P^T, and for dK dS^T = P^T (dP^T - D), into st; lse and D by
    // query column
    const bool interior = kt + kBKV - 1 <= qs &&
                          kt >= qs + kBQ2 - window && qs + kBQ2 <= S;
#pragma unroll
    for (int j = 0; j < kBQ2 / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(sl[stage] + j * 8 +
                                                         c0);
      const float2 d2 = kDK ? *reinterpret_cast<const float2*>(
                                  sd[stage] + j * 8 + c0)
                            : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2f(st[4 * j + e] * scale_log2 -
                         ((e & 1) ? l2.y : l2.x) * kLog2e);
        if (!interior) {
          const int col = qs + j * 8 + c0 + (e & 1);
          const int row = kr + (e >> 1) * 8;
          if (!(col < S && row <= col && row > col - window)) pr = 0.0f;
        }
        st[4 * j + e] =
            kDK ? pr * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x)) : pr;
      }
    }
    split_all<kSSteps>(st, hi, lo);

    // dV += P^T dO or dK += dS^T Q, dO and Q as MN-major B
    const uint64_t db = wgmma::desc_sw128(kDK ? qt : dot, kBQ2 * kRowBytes,
                                          1024);
    wgmma::fence_operands(hi);
    wgmma::fence_operands(lo);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < kSSteps; ++kk) {
      const uint32_t off = (kk * 16 * kRowBytes) >> 4;
      wgmma::mma_rs<NO>(acc, hi[kk], db + off, 1);
      wgmma::mma_rs<NO>(acc, lo[kk], db + off, 1);
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(acc);
    wgmma::fence_operands(hi);
    wgmma::fence_operands(lo);
    tma::mbar_arrive(&empty[stage]);
    bump(stage, phase);
  }
  store_rows<NO>(dst, kv_stride, acc, kt + warp * 16, S, hd,
                 kDK ? scale : 1.0f);
}

// dk and dv for one (64-row KV tile, KV head, batch), over the group's
// query heads and the query tiles whose band holds the tile's keys.
template <int DP, int NO>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const float* __restrict__ lse,
                const float* __restrict__ dsum, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int S, int H, int Hkv, int hd,
                int window, float scale) {
  constexpr int kBoxes = DP / 64;
  constexpr int kKVBytes = kBoxes * kBKV * kRowBytes;    // K or V
  constexpr int kTileBytes = kBoxes * kBQ2 * kRowBytes;  // Q or dO
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, full[kStages], empty[kStages];
  __shared__ __align__(16) float sl[kStages][kBQ2], sd[kStages][kBQ2];
  unsigned char* sk = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* sv = sk + kKVBytes;
  unsigned char* sq = sv + kKVBytes;                     // [kStages]
  unsigned char* sdo = sq + kStages * kTileBytes;        // [kStages]

  const int kt = blockIdx.x * kBKV, hk = blockIdx.y, b = blockIdx.z;
  const int groups = H / Hkv;
  // queries kt <= i <= min(S - 1, kt + kBKV - 1 + window - 1) in kBQ2-row
  // tiles, for each head of the group: steps g * nq + t
  const int q_end = min(S - 1, kt + kBKV - 1 + window - 1);
  const int nq = (q_end - kt) / kBQ2 + 1;
  const int steps = groups * nq;
  if (threadIdx.x == 0) {
    tma::mbar_init(&bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      tma::mbar_init(&full[s], 1 + 32);   // the TMA bytes and 32 lanes
      tma::mbar_init(&empty[s], kConsumers * 128);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {   // producer: warp 0
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        tma::mbar_arrive_expect_tx(&bar_kv, 2 * kKVBytes);
        for (int x = 0; x < kBoxes; ++x) {
          tma::load_4d(sk + x * kBKV * kRowBytes, &k_map, &bar_kv, x * 64,
                       hk, kt, b);
          tma::load_4d(sv + x * kBKV * kRowBytes, &v_map, &bar_kv, x * 64,
                       hk, kt, b);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int step = 0; step < steps; ++step) {
        const int h = hk * groups + step / nq;
        const int qs = kt + (step % nq) * kBQ2;
        tma::mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) {
          tma::mbar_arrive_expect_tx(&full[stage], 2 * kTileBytes);
          for (int x = 0; x < kBoxes; ++x) {
            tma::load_4d(sq + stage * kTileBytes + x * kBQ2 * kRowBytes,
                         &q_map, &full[stage], x * 64, h, qs, b);
            tma::load_4d(sdo + stage * kTileBytes + x * kBQ2 * kRowBytes,
                         &do_map, &full[stage], x * 64, h, qs, b);
          }
        }
        const size_t row_off = (static_cast<size_t>(b) * H + h) * S;
        for (int r = lane; r < kBQ2; r += 32) {
          const int row = qs + r;
          sl[stage][r] = row < S ? lse[row_off + row] : 0.0f;
          sd[stage][r] = row < S ? dsum[row_off + row] : 0.0f;
        }
        tma::mbar_arrive(&full[stage]);
        bump(stage, phase);
      }
    }
    return;
  }

  const size_t kv_stride = static_cast<size_t>(Hkv) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride +
                        static_cast<size_t>(hk) * hd;
  tma::mbar_wait(&bar_kv, 0);
  if (threadIdx.x < 256)
    kv_consumer<DP, NO, false>(sk, sv, sq, sdo, sl, sd, full, empty,
                               dv + kv_off, kt, nq, steps, S, hd, window,
                               scale, kv_stride);
  else
    kv_consumer<DP, NO, true>(sk, sv, sq, sdo, sl, sd, full, empty,
                              dk + kv_off, kt, nq, steps, S, hd, window,
                              scale, kv_stride);
}

// A 4-D map (hd, heads, S, B) over a [B, S, heads, hd] bf16 tensor, read
// in boxes of 64 head columns x `rows` rows of one head.
int head_map(CUtensorMap* map, const void* base, int B, int S, int heads,
             int hd, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * hd * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2, row,
                                 row * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return tma::encode_tiled(map, base, 4, dims, strides, box);
}

template <int DP, int NO>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int B, int S, int H, int Hkv, int hd,
           int window, float scale, cudaStream_t stream) {
  constexpr int kBoxes = DP / 64;
  constexpr int kSmemQ = kBoxes * (2 * kBQ + 2 * kStages * kBK) * kRowBytes +
                         1024;
  constexpr int kSmemKV =
      kBoxes * (2 * kBKV + 2 * kStages * kBQ2) * kRowBytes + 1024;
  CUtensorMap maps[8];   // dq's q, dout, k, v; then dk/dv's
  const void* bases[4] = {q, dout, k, v};
  for (int i = 0; i < 8; ++i) {
    const bool kv = i % 4 >= 2;
    const int rows = i < 4 ? (kv ? kBK : kBQ) : (kv ? kBKV : kBQ2);
    const int err = head_map(&maps[i], bases[i % 4], B, S, kv ? Hkv : H, hd,
                             rows);
    if (err) return err;
  }
  auto kq = dq_kernel<DP, NO>;
  auto kkv = dkdv_kernel<DP, NO>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemQ);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemKV);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  kq<<<dim3(H, (S + kBQ - 1) / kBQ, B), kThreads, kSmemQ, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), lse, dsum, static_cast<bf16*>(dq), S,
      H, Hkv, hd, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kkv<<<dim3((S + kBKV - 1) / kBKV, Hkv, B), kThreads, kSmemKV, stream>>>(
      maps[4], maps[5], maps[6], maps[7], lse, dsum, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, Hkv, hd, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 q/k/v/out/dout/dq/dk/dv with 16-byte aligned bases, hd % 8 == 0
// and hd <= 128; lse float32 [B, H, S]; dsum float32 [B, H, S] scratch (D,
// written by the first kernel, read by the second).  Returns a
// cudaError_t code.
extern "C" int flash_swa_bwd_wgmma(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const float* lse,
                                   float* dsum, void* dq, void* dk, void* dv,
                                   int B, int S, int H, int Hkv, int hd,
                                   int window, float scale,
                                   cudaStream_t stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
      reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
      reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (Hkv <= 0 || H % Hkv != 0 || hd < 8 || hd % 8 != 0 || hd > 128 ||
      window <= 0 || (S + kBQ - 1) / kBQ > 65535 || Hkv > 65535 ||
      B > 65535 || bases % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hd <= 64)
    return launch<64, 64>(q, k, v, out, dout, lse, dsum, dq, dk, dv, B, S, H,
                          Hkv, hd, window, scale, stream);
  if (hd == 120)
    return launch<128, 120>(q, k, v, out, dout, lse, dsum, dq, dk, dv, B, S,
                            H, Hkv, hd, window, scale, stream);
  return launch<128, 128>(q, k, v, out, dout, lse, dsum, dq, dk, dv, B, S, H,
                          Hkv, hd, window, scale, stream);
}
