// Banded causal sliding-window attention on Hopper's own tensor-core path:
// K7 for bfloat16 heads with hd % 8 == 0 and hd <= 128, wgmma fed by TMA.
//
// Replaces: src/repro/kernels/flash_swa/kernel.py::flash_swa
// (_flash_swa_kernel), as flash_swa_mma.cu (mma.sync: bf16 heads that are
// not a multiple of 8) and flash_swa.cu (float32, wider heads) do for the
// other inputs; the wrapper (kernel.py::flash_swa) routes by dtype and head
// width alone.
//
// Computes what flash_swa_mma.cu computes, with the same arithmetic: for q
// [B, S, H, hd] and k/v [B, S, Hkv, hd] in bfloat16 (query head h reads KV
// head h / (H / Hkv), no copy), out in bfloat16,
// * S = Q K^T: bf16 products exact in f32, accumulated in f32;
// * the scale folded with log2 e into one multiply, the band's outside
//   filled with -1e30 (the reference's fill), the online softmax in f32 in
//   the base-2 domain (exp2f), the normaliser l summing the f32 P;
// * P V: P split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), both
//   through the tensor cores into one f32 accumulator (P rounded to bf16
//   alone misses the check against the f32 plain version, as
//   flash_swa_mma.cu's header says);
// * out = O / max(l, 1e-30) rounded to bf16 once; with lse (training), each
//   row's log-sum-exp (m + log2 l) ln 2, natural log, f32 [B, H, S].
// Only the order of the f32 sums inside a product differs from
// flash_swa_mma.cu.
//
// Bound on the H100: operations.  4 hd flop per (query, key) pair of the
// band and head; at Danube's prefill (S 32,768, window 4,096, 32 heads of
// 120) 1.93 TFLOP, 1.95 ms at the 989 TFLOP/s dense bf16 peak.  This
// kernel executes about 1.5x that (chip_smoke.py::wgmma_executed_flop):
// Q K^T over the head padded to 128, P V twice (the split; at hd 120 over
// 120 columns), and the band's edge tiles computed whole and masked.
//
// Design (wgmma + TMA, warp-specialised, one CTA an SM):
// * one CTA of three warpgroups per (128-row query tile, query head,
//   batch).  In warpgroup 0, the producer, one thread issues the TMA
//   loads: the query tile once, then the KV tiles of the band, [max(0, q0
//   - window + 1), q_last] in 64-row tiles, into a ring of kStages stages,
//   K and V each with a full and an empty mbarrier (so Q K^T starts before
//   V lands).  Warpgroups 1 and 2, the consumers, each own 64 query rows;
// * registers: ptxas allocates every thread of a 384-thread CTA at most
//   168 registers, with or without setmaxnreg (its report on the card
//   reads the same spills either way), so the tiles fit 168: S and P of a
//   64-row KV tile (32 + 32) beside O (64) stay in registers while one
//   tile's P V and the next tile's Q K^T are in flight.  A 128-row KV
//   tile (192) made ptxas serialise the wgmmas (C7512, "insufficient
//   register resources") and spill;
// * the loads are 4-D tensor maps whose innermost dimension is the head,
//   (hd, H, S, B) for q and (hd, Hkv, S, B) for k/v, read in boxes of 64
//   head columns (128 bytes, 128-byte swizzle) x rows: a box past hd reads
//   TMA's zeros (120 -> 128 without the next head's columns), and so do
//   rows past S;
// * per KV tile: S = Q K^T as wgmma m64n64k16 with both operands in
//   shared memory (K K-major); the online softmax in the accumulator
//   registers (row max and sum over the quad of lanes that share a row);
//   P's accumulators packed in registers into wgmma A fragments (hi and
//   lo) for O += P V as m64nNk16 with A from registers and V as an MN-major
//   B (N = hd at 64, 120 and 128: the O accumulators are the head's width).
//   The steps overlap within a warpgroup (FlashAttention-3's order): each
//   issues the next tile's Q K^T and this tile's P V, runs the next tile's
//   softmax while P V is on the tensor cores, and packs the next P once
//   P V is done; O takes each tile's correction just before its P V.  The
//   other consumer warpgroup's products fill the gaps;
// * the mask runs only on tiles that cross the band's edges (per
//   warpgroup's 64 rows); the others are read whole;
// * the grid runs the heads fastest, so the H / Hkv query heads of one KV
//   head, and neighbouring query tiles, run together and read the same KV
//   band from L2; the query tiles go last to first, so the shorter bands
//   of the sequence's start fill the end of the launch.  A CTA keeps its
//   tiles for one query tile (no persistent grid: a query tile's band is
//   65 KV tiles at Danube's window, so its prologue and epilogue are a
//   few per cent of it).
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

constexpr int kBQ = 128;                 // query rows a CTA
constexpr int kBK = 64;                  // KV rows a tile
constexpr int kStages = 2;
constexpr int kConsumers = kBQ / 64;     // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kRowBytes = 128;           // a box row: 64 bf16
constexpr int kKSteps = kBK / 16;        // k16 steps of P V
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// DP: the head padded to 64 or 128 in shared memory (DP / 64 boxes); NO:
// the output width of P V (the head: 64, 120 or 128).
template <int DP, int NO>
__global__ void __launch_bounds__(kThreads, 1)
    flash_swa_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           int S, int H, int Hkv, int hd, int window,
                           float scale_log2) {
  constexpr int kBoxes = DP / 64;
  constexpr int kQBytes = kBoxes * kBQ * kRowBytes;
  constexpr int kTileBytes = kBoxes * kBK * kRowBytes;   // K or V
  constexpr int kQSteps = DP / 16;         // k16 steps of Q K^T
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, full_k[kStages], full_v[kStages],
      empty_k[kStages], empty_v[kStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* sq = smem;
  unsigned char* sk = sq + kQBytes;                       // [kStages]
  unsigned char* sv = sk + kStages * kTileBytes;          // [kStages]

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;     // last tile first
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
      tma::mbar_arrive_expect_tx(&bar_q, kQBytes);
      for (int x = 0; x < kBoxes; ++x)
        tma::load_4d(sq + x * kBQ * kRowBytes, &q_map, &bar_q, x * 64, h, q0,
                     b);
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
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows r0 .. r0 + 63
  const int tid = threadIdx.x - 128;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int r0 = q0 + wg * 64;
  const int ra = r0 + warp * 16 + lane / 4;   // rows ra and ra + 8
  const int c0 = 2 * (lane % 4);              // columns c0, c0 + 1
  const uint64_t dq = wgmma::desc_sw128(sq + wg * 64 * kRowBytes, 0, 1024);

  float s[kBK / 2];                  // S, then P, of this thread's cells
  float o[NO / 2];
  uint32_t ph[kKSteps][4], pl[kKSteps][4];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};         // this lane's share of the row sums

  // S = Q K^T of the tile in K stage stage_k into s (issued and
  // committed, not waited on)
  auto issue_s = [&](int stage_k, uint32_t phase_k) {
    tma::mbar_wait(&full_k[stage_k], phase_k);
    const uint64_t dk = wgmma::desc_sw128(sk + stage_k * kTileBytes, 0, 1024);
    wgmma::fence_operands(s);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < kQSteps; ++kk) {
      const uint32_t off_q = (kk / 4) * kBQ * kRowBytes + (kk % 4) * 32;
      const uint32_t off_k = (kk / 4) * kBK * kRowBytes + (kk % 4) * 32;
      wgmma::mma_ss<kBK>(s, dq + (off_q >> 4), dk + (off_k >> 4), kk > 0);
    }
    wgmma::commit();
  };
  // the online softmax of the S in s of the tile at kt, scaled (base 2)
  // and, on tiles that cross the band's edges, masked: P (f32) in s, the
  // row max and sum updated, corr the factor O has yet to take
  auto softmax = [&](int kt, float (&corr)[2]) {
    const bool interior = kt + kBK - 1 <= r0 && kt >= r0 + 64 - window;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (!interior) {
          const int col = kt + j * 8 + c0 + (e & 1);
          const int row = ra + (e >> 1) * 8;
          if (!(col <= row && col > row - window)) x = kNegInf;
        }
        s[4 * j + e] = x;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    corr[0] = exp2f(m[0] - mx[0]);
    corr[1] = exp2f(m[1] - mx[1]);
    m[0] = mx[0];
    m[1] = mx[1];
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = exp2f(s[4 * j + e] - mx[e >> 1]);
        rs[e >> 1] += s[4 * j + e];
      }
    }
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
  };
  // P's accumulators as A fragments: k16 step kk is n8 groups 2kk, 2kk+1
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[kk][r], pl[kk][r]);
    }
  };
  // O += P_hi V + P_lo V with the tile in V stage stage_v (not waited on)
  auto issue_pv = [&](int stage_v, uint32_t phase_v) {
    tma::mbar_wait(&full_v[stage_v], phase_v);
    const uint64_t dv =
        wgmma::desc_sw128(sv + stage_v * kTileBytes, kBK * kRowBytes, 1024);
    wgmma::fence_operands(o);
    wgmma::fence_operands(ph);
    wgmma::fence_operands(pl);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const uint64_t d = dv + ((kk * 16 * kRowBytes) >> 4);
      wgmma::mma_rs<NO>(o, ph[kk], d, 1);
      wgmma::mma_rs<NO>(o, pl[kk], d, 1);
    }
    wgmma::commit();
  };

  float corr[2];
  auto correct_o = [&]() {
#pragma unroll
    for (int j = 0; j < NO / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
  };

  tma::mbar_wait(&bar_q, 0);
  // tile 0's S and P; then each step issues the next tile's S and this
  // tile's P V, runs the next softmax while P V is on the tensor cores,
  // and packs the next P once P V is done
  issue_s(0, 0);
  wgmma::wait<0>();
  wgmma::fence_operands(s);
  tma::mbar_arrive(&empty_k[0]);
  softmax(kt0, corr);
  split_p();
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it + 1 < ntiles; ++it) {
    int next = stage + 1;
    uint32_t next_phase = phase;
    if (next == kStages) {
      next = 0;
      next_phase ^= 1;
    }
    issue_s(next, next_phase);
    correct_o();
    issue_pv(stage, phase);
    wgmma::wait<1>();
    wgmma::fence_operands(s);
    tma::mbar_arrive(&empty_k[next]);
    softmax(kt0 + (it + 1) * kBK, corr);
    wgmma::wait<0>();
    wgmma::fence_operands(o);
    wgmma::fence_operands(ph);
    wgmma::fence_operands(pl);
    tma::mbar_arrive(&empty_v[stage]);
    split_p();
    stage = next;
    phase = next_phase;
  }
  correct_o();
  issue_pv(stage, phase);
  wgmma::wait<0>();
  wgmma::fence_operands(o);
  wgmma::fence_operands(ph);
  wgmma::fence_operands(pl);

  // out = O / max(l, 1e-30), rounded to bf16 once
  const float denom[2] = {fmaxf(quad_sum(l[0]), 1e-30f),
                          fmaxf(quad_sum(l[1]), 1e-30f)};
  const size_t q_stride = static_cast<size_t>(H) * hd;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = ra + half * 8;
    if (row >= S) continue;
    if (lse != nullptr && (lane & 3) == 0) {
      lse[(static_cast<size_t>(b) * H + h) * S + row] =
          (m[half] + log2f(denom[half])) * kLn2;
    }
    bf16* dst = out + (static_cast<size_t>(b) * S + row) * q_stride +
                static_cast<size_t>(h) * hd;
#pragma unroll
    for (int j = 0; j < NO / 8; ++j) {
      const int col = j * 8 + c0;
      if (col < hd) {                  // hd % 8 == 0: col + 1 < hd too
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * half] / denom[half],
                                  o[4 * j + 2 * half + 1] / denom[half]);
      }
    }
  }
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
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int H, int Hkv, int hd, int window,
           float scale, cudaStream_t stream) {
  constexpr int kSmem = (DP / 64) * (kBQ + 2 * kStages * kBK) * kRowBytes +
                        1024;
  CUtensorMap q_map, k_map, v_map;
  int err = head_map(&q_map, q, B, S, H, hd, kBQ);
  if (!err) err = head_map(&k_map, k, B, S, Hkv, hd, kBK);
  if (!err) err = head_map(&v_map, v, B, S, Hkv, hd, kBK);
  if (err) return err;
  auto kernel = flash_swa_wgmma_kernel<DP, NO>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(H, (S + kBQ - 1) / kBQ, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(out), lse, S, H, Hkv, hd,
      window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 q/k/v/out, 16-byte aligned bases, hd % 8 == 0 and hd <= 128;
// lse float32 [B, H, S] or null (serving writes none).  Returns a
// cudaError_t code.
extern "C" int flash_swa_wgmma_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int B, int S, int H, int Hkv, int hd,
                                   int window, float scale,
                                   cudaStream_t stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || hd < 8 || hd % 8 != 0 || hd > 128 ||
      window <= 0 || (S + kBQ - 1) / kBQ > 65535 || B > 65535 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
          16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hd <= 64)
    return launch<64, 64>(q, k, v, out, lse, B, S, H, Hkv, hd, window, scale,
                          stream);
  if (hd == 120)
    return launch<128, 120>(q, k, v, out, lse, B, S, H, Hkv, hd, window,
                            scale, stream);
  return launch<128, 128>(q, k, v, out, lse, B, S, H, Hkv, hd, window,
                          scale, stream);
}
