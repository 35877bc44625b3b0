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
// H, S] float32.  Only the order of the f32 sums inside a product differs,
// and exp2 flushes results under 2^-126 to zero (swa_mma::exp2_ftz).
//
// Bound on the H100: operations, 10 hd flop per (query, key) pair of the
// band and head; at Danube's training shape (S 8,192, window 4,096, 32
// heads of 120) 0.97 TFLOP, 0.98 ms at 989 TFLOP/s.  The two kernels
// execute about 2.1x that (chip_smoke.py::bwd_wgmma_executed_flop): both
// recompute Q K^T and dO V^T, the three split products run twice, Q K^T
// and dO V^T run over the head padded to 128, and the band's edge tiles
// are computed whole and masked.
//
// Design: the two-kernel, no-atomics structure of flash_swa_bwd_mma.cu, so
// that two runs give the same bits, each kernel warp-specialised as
// flash_swa_wgmma.cu is: warpgroup 0 a TMA producer that hands registers
// over (setmaxnreg.dec to 24), warpgroups 1 and 2 consumers that take them
// (setmaxnreg.inc to 240), roles from a warp-uniform index; mbarrier
// rings; 4-D tensor maps (hd, heads, S, B) read in boxes of 64 head
// columns, zeros past hd and past S.  The consumers wait with
// tma::mbar_wait_spin (a trap in their code makes ptxas pipeline their
// wgmmas as if they had 168 registers: flash_swa_wgmma.cu's header) and
// the producer keeps the 4 s guard, waiting at its end until the
// consumers have released the last stages.
// * dq_kernel, one CTA per (128-row query tile, head, batch), the heads
//   fastest and the query tiles last to first, as the forward's grid.  The
//   consumers first compute D for their rows (from global memory; written
//   to the D scratch for the second kernel), while the producer loads the Q
//   and dO tiles once and then the band's 64-row K and V tiles, each with
//   its own barriers.  Per KV tile: S = Q K^T and dP = dO V^T (wgmma
//   m64n64k16, all operands in shared memory, K and V K-major), P and dS in
//   the accumulator registers, dS packed into A fragments (hi, lo) for dQ
//   += dS K with K read again as an MN-major B (one load, two
//   descriptors).  S and dP are double-buffered against dQ: each step
//   issues the next tile's S and dP, then this tile's dQ += dS K, and
//   computes the next dS while dQ's products run (S, dP, dQ and dS's
//   fragments: 32 + 32 + 64 + 32 registers beside the addresses, ~200 in
//   all); the two consumers take turns to issue (wgmma::turn_wait /
//   turn_pass, FlashAttention-3's ping-pong);
// * dkdv_kernel, one CTA per (128-row KV tile, KV head, batch), launched
//   after dq_kernel on the stream (it reads D), the KV tiles fastest.  The
//   producer loads K and V once, then for each query head of the group in
//   order, each 64-row query tile of the band [kt, min(S - 1, kt + 127 +
//   window - 1)] (kernel.py::wgmma_dkdv_walk mirrors the walk): Q and dO
//   by TMA and their rows' lse and D by the producer warp's 32 lanes (plain
//   loads into the stage, then an arrive on the stage's full barrier,
//   which counts the TMA bytes and 33 arrivals).  Each consumer warpgroup
//   owns 64 key rows of the tile and holds both dK and dV for them (64 +
//   64 registers): per query tile it computes S^T = K Q^T and dP^T = V
//   dO^T (m64n64k16) once, P^T and dS^T (lse and D read by query column)
//   from them, then dV += P^T dO and dK += dS^T Q in one group, A from
//   registers (split) and dO, Q as MN-major B, so one TMA load of a Q or dO
//   tile serves its K-major and MN-major reads and two warpgroups' key
//   rows.  A query tile with no pair of the band for a warpgroup's 64 key
//   rows (the diagonal's other half, the band's far end) is passed over.
//   The GQA sum over the group's heads happens in the CTA, in a fixed
//   order.  S^T and dP^T go in two groups, and P^T is computed while dP^T
//   runs: issued in one group and waited on together, they left ptxas
//   short of registers at ~236 (C7512, part of the wgmmas serialised).
//   Turns cost this kernel more than they gave (its two warpgroups pass
//   over different tiles), so it has none;
// * the mask runs only on tiles that cross the band's edges or S (per
//   warpgroup's 64 rows); the others are read whole.
#include <cuda.h>
#include <cuda_runtime.h>

#include "../../csrc/tma.cuh"
#include "../../csrc/wgmma.cuh"
#include "flash_swa_mma.cuh"

namespace {

using swa_mma::bf16;
using swa_mma::exp2_ftz;
using swa_mma::kFull;
using swa_mma::kLog2e;
using swa_mma::split;

constexpr int kRowBytes = 128;           // a box row: 64 bf16
constexpr int kConsumers = 2;            // consumer warpgroups of 64 rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 24;        // a producer thread after setmaxnreg
constexpr int kConsumerRegs = 240;       // a consumer thread after setmaxnreg
constexpr int kStages = 3;
constexpr int kBQ = 64 * kConsumers;     // query rows a dq CTA: 128
constexpr int kBK = 64;                  // KV rows a tile of its walk
constexpr int kBKV = 64 * kConsumers;    // key rows a dk/dv CTA: 128
constexpr int kBQ2 = 64;                 // query rows a tile of its walk
constexpr int kSteps = 64 / 16;          // k16 steps of a 64-row product
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                  65536,
              "the warpgroups' registers exceed the SM's 65,536");

__device__ __forceinline__ void bump(int& stage, uint32_t& phase) {
  if (++stage == kStages) {
    stage = 0;
    phase ^= 1;
  }
}

// P and dS halves as the A fragments of k16 step kk: n8 groups 2kk, 2kk+1
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

// d (+)= A B^T over the padded head, A the warpgroup's 64 rows (descriptor
// da: a box of `a_rows` rows) and B a tile of 64 rows (db: `b_rows`), both
// K-major; not committed
template <int DP>
__device__ __forceinline__ void product_ss(float (&d)[32], uint64_t da,
                                           int a_rows, uint64_t db,
                                           int b_rows) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off_a = (kk / 4) * a_rows * kRowBytes + (kk % 4) * 32;
    const uint32_t off_b = (kk / 4) * b_rows * kRowBytes + (kk % 4) * 32;
    wgmma::mma_ss<64>(d, da + (off_a >> 4), db + (off_b >> 4), kk > 0);
  }
}

// acc += hi B + lo B, B a 64-row MN-major tile (descriptor db); not
// committed
template <int NO>
__device__ __forceinline__ void product_rs(float (&acc)[NO / 2],
                                           uint32_t (&hi)[kSteps][4],
                                           uint32_t (&lo)[kSteps][4],
                                           uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint64_t d = db + ((kk * 16 * kRowBytes) >> 4);
    wgmma::mma_rs<NO>(acc, hi[kk], d, 1);
    wgmma::mma_rs<NO>(acc, lo[kk], d, 1);
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

// dS = P (dP - D) of the KV tile at kt into dp, P = exp2(S scale log2 e -
// lse log2 e) from s, for the rows ra and ra + 8 (ll: their lse log2 e,
// dd: their D); masked unless the tile is interior to the band
__device__ __forceinline__ void ds_rows(const float (&s)[32],
                                        float (&dp)[32], const float (&ll)[2],
                                        const float (&dd)[2], int kt, int ra,
                                        int c0, int window, bool interior,
                                        float scale_log2) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pr = exp2_ftz(s[4 * j + e] * scale_log2 - ll[e >> 1]);
      if (!interior) {
        const int col = kt + j * 8 + c0 + (e & 1);
        const int row = ra + (e >> 1) * 8;
        if (!(col <= row && col > row - window)) pr = 0.0f;
      }
      dp[4 * j + e] = pr * (dp[4 * j + e] - dd[e >> 1]);
    }
  }
}

// A tile of `rows` keys at kt lies inside the band for every query row
// r0 .. r0 + 63
__device__ __forceinline__ bool inside_band(int kt, int rows, int r0,
                                            int window) {
  return kt + rows - 1 <= r0 && kt >= r0 + 64 - window;
}

// S = Q K^T and dP = dO V^T of the K and V tiles at ks and vs (dqa, doa:
// the warpgroup's 64 rows of Q and dO); issued and committed
template <int DP>
__device__ __forceinline__ void issue_s_dp(float (&s)[32], float (&dp)[32],
                                           uint64_t dqa, uint64_t doa,
                                           const unsigned char* ks,
                                           const unsigned char* vs) {
  wgmma::fence_operands(s);
  wgmma::fence_operands(dp);
  wgmma::fence();
  product_ss<DP>(s, dqa, kBQ, wgmma::desc_sw128(ks, 0, 1024), kBK);
  product_ss<DP>(dp, doa, kBQ, wgmma::desc_sw128(vs, 0, 1024), kBK);
  wgmma::commit();
}

// dQ += dS_hi K + dS_lo K with the K tile at ks read as an MN-major B;
// issued and committed
template <int NO>
__device__ __forceinline__ void issue_dq(float (&acc)[NO / 2],
                                         uint32_t (&hi)[kSteps][4],
                                         uint32_t (&lo)[kSteps][4],
                                         const unsigned char* ks) {
  wgmma::fence_operands(acc);
  wgmma::fence_operands(hi);
  wgmma::fence_operands(lo);
  wgmma::fence();
  product_rs<NO>(acc, hi, lo,
                 wgmma::desc_sw128(ks, kBK * kRowBytes, 1024));
  wgmma::commit();
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
  const int role = __shfl_sync(kFull, threadIdx.x / 128, 0);
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

  if (role == 0) {   // producer
    wgmma::reg_dealloc<kProducerRegs>();
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
      // the hang guard of the consumers' waits: the last tiles released
      for (int it = max(0, ntiles - kStages); it < ntiles; ++it)
        tma::mbar_wait(&empty_k[it % kStages], (it / kStages) & 1);
    }
    return;
  }

  wgmma::reg_alloc<kConsumerRegs>();
  const int wg = role - 1, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
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
  uint32_t hi[kSteps][4], lo[kSteps][4];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) acc[i] = 0.0f;

  // the two warpgroups take turns to issue a step's products (ntiles
  // turns each; the last dQ += dS K takes none)
  wgmma::turns_start(wg);
  tma::mbar_wait_spin(&bar_q, 0);
  tma::mbar_wait_spin(&full_k[0], 0);
  tma::mbar_wait_spin(&full_v[0], 0);
  wgmma::turn_wait(wg);
  issue_s_dp<DP>(s, dp, dqa, doa, sk, sv);
  if (wg == 0 || ntiles > 1) wgmma::turn_pass(wg);
  wgmma::wait<0>();
  wgmma::fence_operands(s);
  wgmma::fence_operands(dp);
  tma::mbar_arrive(&empty_v[0]);
  ds_rows(s, dp, ll, dd, kt0, ra, c0, window,
          inside_band(kt0, kBK, r0, window), scale_log2);
  split_all(dp, hi, lo);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it + 1 < ntiles; ++it) {
    int next = stage;
    uint32_t next_phase = phase;
    bump(next, next_phase);
    tma::mbar_wait_spin(&full_k[next], next_phase);
    tma::mbar_wait_spin(&full_v[next], next_phase);
    wgmma::turn_wait(wg);
    issue_s_dp<DP>(s, dp, dqa, doa, sk + next * kTileBytes,
                   sv + next * kTileBytes);
    issue_dq<NO>(acc, hi, lo, sk + stage * kTileBytes);
    if (wg == 0 || it + 2 < ntiles) wgmma::turn_pass(wg);
    wgmma::wait<1>();                  // the next S and dP
    wgmma::fence_operands(s);
    wgmma::fence_operands(dp);
    tma::mbar_arrive(&empty_v[next]);
    const int kt = kt0 + (it + 1) * kBK;
    ds_rows(s, dp, ll, dd, kt, ra, c0, window,
            inside_band(kt, kBK, r0, window), scale_log2);
    wgmma::wait<0>();                  // this tile's dQ
    wgmma::fence_operands(acc);
    wgmma::fence_operands(hi);
    wgmma::fence_operands(lo);
    tma::mbar_arrive(&empty_k[stage]);
    split_all(dp, hi, lo);
    stage = next;
    phase = next_phase;
  }
  issue_dq<NO>(acc, hi, lo, sk + stage * kTileBytes);
  wgmma::wait<0>();
  wgmma::fence_operands(acc);
  wgmma::fence_operands(hi);
  wgmma::fence_operands(lo);
  tma::mbar_arrive(&empty_k[stage]);
  store_rows<NO>(dq + static_cast<size_t>(b) * S * q_stride +
                     static_cast<size_t>(h) * hd,
                 q_stride, acc, r0 + warp * 16, S, hd, scale);
}

// dk and dv for one (128-row KV tile, KV head, batch), over the group's
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
  const int role = __shfl_sync(kFull, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    tma::mbar_init(&bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      tma::mbar_init(&full[s], 1 + 32);   // the TMA bytes and 32 lanes
      tma::mbar_init(&empty[s], kConsumers * 128);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  if (role == 0) {   // producer: warp 0
    wgmma::reg_dealloc<kProducerRegs>();
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
      // the hang guard of the consumers' waits: the last steps released
      for (int t = max(0, steps - kStages); t < steps; ++t)
        tma::mbar_wait(&empty[t % kStages], (t / kStages) & 1);
    }
    return;
  }

  // consumers: warpgroup wg owns key rows kr0 .. kr0 + 63 and both of
  // their gradients
  wgmma::reg_alloc<kConsumerRegs>();
  const int wg = role - 1, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int kr0 = kt + wg * 64;
  const int kr = kr0 + warp * 16 + lane / 4;  // key rows kr and kr + 8
  const int c0 = 2 * (lane % 4);              // query columns c0, c0 + 1
  const float scale_log2 = scale * kLog2e;
  const uint64_t dka = wgmma::desc_sw128(sk + wg * 64 * kRowBytes, 0, 1024);
  const uint64_t dva = wgmma::desc_sw128(sv + wg * 64 * kRowBytes, 0, 1024);

  float ak[NO / 2], av[NO / 2];
  uint32_t ph[kSteps][4], pl[kSteps][4], dh[kSteps][4], dl[kSteps][4];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) {
    ak[i] = 0.0f;
    av[i] = 0.0f;
  }

  tma::mbar_wait_spin(&bar_kv, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int step = 0; step < steps; ++step) {
    const int qs = kt + (step % nq) * kBQ2;
    tma::mbar_wait_spin(&full[stage], phase);
    // a query tile without a pair of the band for these key rows
    if (qs + kBQ2 - 1 < kr0 || qs > kr0 + 63 + window - 1) {
      tma::mbar_arrive(&empty[stage]);
      bump(stage, phase);
      continue;
    }
    const unsigned char* qt = sq + stage * kTileBytes;
    const unsigned char* dot = sdo + stage * kTileBytes;

    // S^T = K Q^T and dP^T = V dO^T, Q and dO K-major, in two groups into
    // accumulators new to this step (so that no value of the last step's
    // stays live)
    float st[kBQ2 / 2], dpt[kBQ2 / 2];
    wgmma::fence_operands(st);
    wgmma::fence_operands(dpt);
    wgmma::fence();
    product_ss<DP>(st, dka, kBKV, wgmma::desc_sw128(qt, 0, 1024), kBQ2);
    wgmma::commit();
    product_ss<DP>(dpt, dva, kBKV, wgmma::desc_sw128(dot, 0, 1024), kBQ2);
    wgmma::commit();
    wgmma::wait<1>();
    wgmma::fence_operands(st);

    // P^T into st while dP^T is on the tensor cores, then dS^T = P^T (dP^T
    // - D) into dpt; lse and D by query column
    const bool interior = kr0 + 63 <= qs && kr0 >= qs + kBQ2 - window &&
                          qs + kBQ2 <= S;
#pragma unroll
    for (int j = 0; j < kBQ2 / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(sl[stage] + j * 8 +
                                                         c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2_ftz(st[4 * j + e] * scale_log2 -
                         ((e & 1) ? l2.y : l2.x) * kLog2e);
        if (!interior) {
          const int col = qs + j * 8 + c0 + (e & 1);
          const int row = kr + (e >> 1) * 8;
          if (!(col < S && row <= col && row > col - window)) pr = 0.0f;
        }
        st[4 * j + e] = pr;
      }
    }
    wgmma::wait<0>();
    wgmma::fence_operands(dpt);
#pragma unroll
    for (int j = 0; j < kBQ2 / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(sd[stage] + j * 8 +
                                                         c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dpt[4 * j + e] =
            st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
    }
    split_all(st, ph, pl);
    split_all(dpt, dh, dl);

    // dV += P^T dO and dK += dS^T Q, dO and Q as MN-major B
    wgmma::fence_operands(av);
    wgmma::fence_operands(ak);
    wgmma::fence_operands(ph);
    wgmma::fence_operands(pl);
    wgmma::fence_operands(dh);
    wgmma::fence_operands(dl);
    wgmma::fence();
    product_rs<NO>(av, ph, pl, wgmma::desc_sw128(dot, kBQ2 * kRowBytes, 1024));
    product_rs<NO>(ak, dh, dl, wgmma::desc_sw128(qt, kBQ2 * kRowBytes, 1024));
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(av);
    wgmma::fence_operands(ak);
    wgmma::fence_operands(ph);
    wgmma::fence_operands(pl);
    wgmma::fence_operands(dh);
    wgmma::fence_operands(dl);
    tma::mbar_arrive(&empty[stage]);
    bump(stage, phase);
  }
  const size_t kv_stride = static_cast<size_t>(Hkv) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride +
                        static_cast<size_t>(hk) * hd;
  store_rows<NO>(dv + kv_off, kv_stride, av, kr0 + warp * 16, S, hd, 1.0f);
  store_rows<NO>(dk + kv_off, kv_stride, ak, kr0 + warp * 16, S, hd, scale);
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
