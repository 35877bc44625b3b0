// The backward of banded causal sliding-window attention on the tensor
// cores with mma.sync: K7's gradient for bfloat16 inputs with head_dim <=
// 128 that is not a multiple of 8 (flash_swa_bwd_wgmma.cu takes the
// others, every head of the main paths).
//
// Replaces: the gradient that JAX takes of the reference's banded attention
// (src/repro/models/layers.py, attention(swa_banded=True)); the TPU kernel
// src/repro/kernels/flash_swa/kernel.py::flash_swa has no backward.  For
// float32 (TF32 would round its inputs) and for bfloat16 heads of 129-256
// the port keeps flash_swa_bwd.cu; the wrapper (kernel.py::flash_swa_bwd)
// routes between the two by dtype and head width.
//
// Computes what flash_swa_bwd.cu computes (its header states the function:
// D = sum(dout * out), P = exp(scale q.k - lse) in the band i - window < j
// <= i, dS = P (dout.v - D), dq = scale dS k, and dk = scale dS^T q and dv
// = P^T dout summed over each KV head's query heads), for q, out, dout, dq
// [B, S, H, hd] and k, v, dk, dv [B, S, Hkv, hd] in bfloat16 (query head h
// reads KV head h / (H / Hkv), no copy), lse [B, H, S] float32.  Precision:
// * Q K^T and dO V^T: bf16 products are exact in f32, accumulated in f32;
// * P = exp2(S scale log2 e - lse log2 e) and dS = P (dP - D) in f32;
// * P^T dO, dS K and dS^T Q: P or dS rounded to bf16 alone misses the check
//   against the f32 plain version (|err| <= 1e-2 |want| + 1e-3 max(1,
//   max|want|)) on a few elements (dS for dq and dk, P for dv; the CPU model
//   in tests/test_torch_flash_swa_grad.py), so both are split into bf16 hi
//   and lo halves, as the forward splits P, and both halves go through the
//   tensor cores into the same f32 accumulator;
// * scale is applied to the dq and dk accumulators once; the outputs are
//   rounded to bf16 once.
//
// Bound on the H100: operations.  Per head and (query, key) pair of the
// band 10 hd useful flop (q.k, dout.v, P^T dout, dS^T q, dS k); at Danube's
// training shape (S 8,192, window 4,096, 32 heads of 120) 0.97 TFLOP,
// 0.98 ms at the 989 TFLOP/s dense bf16 peak.  This kernel executes 2.1x
// that (chip_smoke.py::bwd_mma_executed_flop): both kernels recompute Q K^T
// and dO V^T, the three split products run twice (20 hd a pair in all),
// hd 120 is padded to 128, and the tiles that cross the band's edges are
// computed whole and masked.
//
// Design (mma.sync m16n8k16, FlashAttention-2's backward with its
// register layout, and the two-kernel, no-atomics structure of
// flash_swa_bwd.cu, so that two runs give the same bits):
// * dq_kernel, one CTA of 8 warps per (128-row query tile, head, batch);
//   the grid runs the heads fastest, as the forward's does.  It first
//   computes D for its rows (a warp a row, from global memory) and writes
//   it to the D scratch; then it walks the 64-row KV tiles of its band,
//   [max(0, q0 - window + 1), q_last], double-buffered with cp.async.  Warp
//   w owns query rows 16w..16w+15: S = Q K^T and dP = dO V^T take Q and dO
//   as A fragments (ldmatrix from shared memory each tile: registers go to
//   the accumulators) and K and V as B fragments (ldmatrix); P and dS are
//   computed in the accumulator registers, and dS's accumulator becomes the
//   A fragments of dQ += dS K, with K through ldmatrix.trans;
// * dkdv_kernel, one CTA of 4 warps per (64-row KV tile, KV head, batch),
//   launched after dq_kernel on the stream (it reads D); the grid runs the
//   KV tiles fastest, so neighbouring CTAs read the same queries from L2.
//   Warp w owns key rows 16w..16w+15, and its dK and dV accumulators (2 x
//   16 x 128 f32) stay in registers for the whole walk.  For each of the
//   H / Hkv query heads of its KV head, in order, it walks the 32-row query
//   tiles of the band, [kt, min(S - 1, kt + 63 + window - 1)],
//   double-buffered with cp.async (Q, dO, lse and D).  It computes the
//   transposed scores S^T = K Q^T and dP^T = V dO^T (K and V as A
//   fragments, Q and dO as B fragments), so that P^T and dS^T come out of
//   the accumulators in the A-fragment layout of dV += P^T dO and dK +=
//   dS^T Q, with dO and Q through ldmatrix.trans; lse and D are read per
//   query column (each thread's columns 2 (lane % 4) + {0, 1} of each n8
//   tile).  The GQA sum over the group's heads happens in the CTA, in a
//   fixed order;
// * rows are padded by 16 bytes in shared memory (the 8 rows of each
//   ldmatrix phase hit distinct banks); the head is padded with zeros to a
//   multiple of 16 (120 -> 128); rows past S are zeros;
// * the mask is applied only on tiles that cross the band's edges or the
//   ragged tail past S; the others are read whole.
// flash_swa_bwd_wgmma.cu is this design's successor on Hopper's own path.
#include "flash_swa_mma.cuh"

namespace {

using namespace swa_mma;

constexpr int kQWarps = 8;              // dq_kernel
constexpr int kQThreads = 32 * kQWarps;
constexpr int kBQ = 16 * kQWarps;       // query rows per dq CTA: 128
constexpr int kBK = 64;                 // KV rows per tile of the dq walk
constexpr int kKvWarps = 4;             // dkdv_kernel
constexpr int kKvThreads = 32 * kKvWarps;
constexpr int kBKV = 16 * kKvWarps;     // key rows per dk/dv CTA: 64
constexpr int kBQ2 = 32;                // query rows per tile of its walk

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// rows [row0, row0 + 16) x columns < hd of acc (NO n8 tiles, a warp's 16
// rows), scaled and rounded to bf16, into dst (rows of stride `stride`)
template <int NO>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           size_t stride,
                                           const float (&acc)[NO][4],
                                           int row0, int S, int hd,
                                           float scale, bool vec) {
  const int lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (lane >> 2) + half * 8;
    if (row >= S) continue;
    bf16* p = dst + static_cast<size_t>(row) * stride;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + c0;
      const float x0 = acc[n][2 * half] * scale;
      const float x1 = acc[n][2 * half + 1] * scale;
      if (vec && col < hd) {           // hd % 8 == 0: col + 1 < hd too
        *reinterpret_cast<__nv_bfloat162*>(p + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < hd) p[col] = __float2bfloat16(x0);
        if (col + 1 < hd) p[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// dq for one (128-row query tile, head, batch); writes D for its rows
// first.  NO: n8 tiles of the head (hd <= 8 NO), padded to DP = 16 KD.
template <int NO>
__global__ void __launch_bounds__(kQThreads, 1)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ out,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ dsum, bf16* __restrict__ dq, int S, int H,
          int Hkv, int hd, int window, float scale, int vec) {
  constexpr int KD = (NO + 1) / 2;     // k16 steps over the head
  constexpr int DP = 16 * KD;
  constexpr int LD = DP + 8;           // row stride: 16 bytes of padding
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);   // [kBQ][LD]
  bf16* sdo = sq + kBQ * LD;                      // [kBQ][LD]
  bf16* sk = sdo + kBQ * LD;                      // [2][kBK][LD]
  bf16* sv = sk + 2 * kBK * LD;                   // [2][kBK][LD]
  float* sd = reinterpret_cast<float*>(sv + 2 * kBK * LD);   // [kBQ]

  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, q0 = blockIdx.y * kBQ, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(Hkv) * hd;
  const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                       static_cast<size_t>(h) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride +
                        static_cast<size_t>(hk) * hd;
  const size_t row_off = (static_cast<size_t>(b) * H + h) * S;

  // the padding columns [hd, DP) of every row are never loaded: zero them
  const int pad = DP - hd;
  for (int i = tid; i < (2 * kBQ + 4 * kBK) * pad; i += kQThreads) {
    sq[(i / pad) * LD + hd + i % pad] = __float2bfloat16(0.0f);
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt0 = max(0, q0 - window + 1) / kBK * kBK;
  const int ntiles = (q_last - kt0) / kBK + 1;

  load_tile<kBQ, LD, kQThreads>(sq, q + q_off, q_stride, q0, S, hd, vec);
  load_tile<kBQ, LD, kQThreads>(sdo, dout + q_off, q_stride, q0, S, hd, vec);
  load_tile<kBK, LD, kQThreads>(sk, k + kv_off, kv_stride, kt0, S, hd, vec);
  load_tile<kBK, LD, kQThreads>(sv, v + kv_off, kv_stride, kt0, S, hd, vec);
  cp_async_commit();

  // D for the warp's 16 rows while the tiles load: a warp a row
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float acc = 0.0f;
    if (row < S) {
      const size_t off = q_off + static_cast<size_t>(row) * q_stride;
      for (int c = lane; c < hd; c += 32) {
        acc = fmaf(__bfloat162float(dout[off + c]),
                   __bfloat162float(out[off + c]), acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      sd[warp * 16 + r] = acc;
      if (row < S) dsum[row_off + row] = acc;
    }
  }
  __syncwarp();
  const int ra = q0 + warp * 16 + (lane >> 2);   // rows ra and ra + 8
  const int c0 = 2 * (lane & 3);                 // columns c0, c0 + 1
  float dd[2], ll[2];                            // D and lse log2 e
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = ra + half * 8;
    dd[half] = sd[row - q0];
    ll[half] = row < S ? lse[row_off + row] * kLog2e : 0.0f;
  }
  const float scale_log2 = scale * kLog2e;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  }
  const bf16* qa = sq + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* doa = sdo + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8;   // B rows of ldmatrix_x4
  const int bcol = ((lane >> 3) & 1) * 8;

  for (int it = 0; it < ntiles; ++it) {
    const int kt = kt0 + it * kBK;
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      load_tile<kBK, LD, kQThreads>(sk + (buf ^ 1) * kBK * LD, k + kv_off,
                                    kv_stride, kt + kBK, S, hd, vec);
      load_tile<kBK, LD, kQThreads>(sv + (buf ^ 1) * kBK * LD, v + kv_off,
                                    kv_stride, kt + kBK, S, hd, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = sk + buf * kBK * LD;
    const bf16* vs = sv + buf * kBK * LD;

    // S = Q K^T and dP = dO V^T: 8 n8 tiles of KV columns each
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (p * 16 + brow) * LD + kk * 16 + bcol);
        mma(s[2 * p], a, bk[0], bk[1]);
        mma(s[2 * p + 1], a, bk[2], bk[3]);
      }
      ldmatrix_x4(a, doa + kk * 16);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bv[4];
        ldmatrix_x4(bv, vs + (p * 16 + brow) * LD + kk * 16 + bcol);
        mma(dp[2 * p], a, bv[0], bv[1]);
        mma(dp[2 * p + 1], a, bv[2], bv[3]);
      }
    }

    // P, then dS = P (dP - D) in dp; masked only on the band's edge tiles
    const bool interior = kt + kBK - 1 <= q0 && kt >= q0 + kBQ - window;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2f(s[n][e] * scale_log2 - ll[e >> 1]);
        if (!interior) {
          const int col = kt + n * 8 + c0 + (e & 1);
          const int row = ra + (e >> 1) * 8;
          if (!(col <= row && col > row - window)) pr = 0.0f;
        }
        dp[n][e] = pr * (dp[n][e] - dd[e >> 1]);
      }
    }

    // dQ += dS K: k16 step j takes KV rows 16j..16j+15
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t hi[4], lo[4];
      split_a(dp[2 * j], dp[2 * j + 1], hi, lo);
      mma_rows_trans<NO, LD>(acc, hi, lo, ks + j * 16 * LD);
    }
    __syncthreads();   // this buffer is loaded again two tiles on
  }

  store_rows<NO>(dq + q_off, q_stride, acc, q0 + warp * 16, S, hd, scale,
                 vec);
}

// dk and dv for one (64-row KV tile, KV head, batch), over the group's
// query heads and the query tiles whose band holds the tile's keys.
template <int NO>
__global__ void __launch_bounds__(kKvThreads, 1)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
            int Hkv, int hd, int window, float scale, int vec) {
  constexpr int KD = (NO + 1) / 2;
  constexpr int DP = 16 * KD;
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);   // [kBKV][LD]
  bf16* sv = sk + kBKV * LD;                      // [kBKV][LD]
  bf16* sq = sv + kBKV * LD;                      // [2][kBQ2][LD]
  bf16* sdo = sq + 2 * kBQ2 * LD;                 // [2][kBQ2][LD]
  float* sl = reinterpret_cast<float*>(sdo + 2 * kBQ2 * LD);  // [2][kBQ2]
  float* sd = sl + 2 * kBQ2;                                  // [2][kBQ2]

  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid >> 5, lane = tid & 31;
  const int kt = blockIdx.x * kBKV, hk = blockIdx.y, b = blockIdx.z;
  const int groups = H / Hkv;
  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(Hkv) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride +
                        static_cast<size_t>(hk) * hd;

  const int pad = DP - hd;
  for (int i = tid; i < (2 * kBKV + 4 * kBQ2) * pad; i += kKvThreads) {
    sk[(i / pad) * LD + hd + i % pad] = __float2bfloat16(0.0f);
  }

  // queries i with kt <= i <= min(S - 1, kt + kBKV - 1 + window - 1), in
  // kBQ2-row tiles, for each head of the group: steps g * nq + t
  const int q_end = min(S - 1, kt + kBKV - 1 + window - 1);
  const int nq = (q_end - kt) / kBQ2 + 1;
  const int steps = groups * nq;

  // the step's Q, dO, lse and D into buffer `buf`
  auto load_step = [&](int step, int buf) {
    const int h = hk * groups + step / nq;
    const int q0 = kt + (step % nq) * kBQ2;
    const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                         static_cast<size_t>(h) * hd;
    load_tile<kBQ2, LD, kKvThreads>(sq + buf * kBQ2 * LD, q + q_off,
                                    q_stride, q0, S, hd, vec);
    load_tile<kBQ2, LD, kKvThreads>(sdo + buf * kBQ2 * LD, dout + q_off,
                                    q_stride, q0, S, hd, vec);
    if (tid < 2 * kBQ2) {
      const int r = tid % kBQ2, row = q0 + r;
      const float* src = (tid < kBQ2 ? lse : dsum) +
                         (static_cast<size_t>(b) * H + h) * S;
      float* dst = (tid < kBQ2 ? sl : sd) + buf * kBQ2 + r;
      cp_async4(dst, row < S ? src + row : src, row < S);
    }
  };

  load_tile<kBKV, LD, kKvThreads>(sk, k + kv_off, kv_stride, kt, S, hd, vec);
  load_tile<kBKV, LD, kKvThreads>(sv, v + kv_off, kv_stride, kt, S, hd, vec);
  load_step(0, 0);
  cp_async_commit();

  float adk[NO][4], adv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.0f;
  }
  const int kr = kt + warp * 16 + (lane >> 2);   // key rows kr and kr + 8
  const int c0 = 2 * (lane & 3);                 // query columns c0, c0 + 1
  const float scale_log2 = scale * kLog2e;
  const bf16* ka = sk + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* va = sv + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8;
  const int bcol = ((lane >> 3) & 1) * 8;

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {
      load_step(step + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = kt + (step % nq) * kBQ2;
    const bf16* qs = sq + buf * kBQ2 * LD;
    const bf16* dos = sdo + buf * kBQ2 * LD;
    const float* ls = sl + buf * kBQ2;
    const float* ds = sd + buf * kBQ2;

    // S^T = K Q^T and dP^T = V dO^T: 4 n8 tiles of query columns each
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.0f;
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, ka + kk * 16);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bq[4];
        ldmatrix_x4(bq, qs + (p * 16 + brow) * LD + kk * 16 + bcol);
        mma(st[2 * p], a, bq[0], bq[1]);
        mma(st[2 * p + 1], a, bq[2], bq[3]);
      }
      ldmatrix_x4(a, va + kk * 16);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bo[4];
        ldmatrix_x4(bo, dos + (p * 16 + brow) * LD + kk * 16 + bcol);
        mma(dpt[2 * p], a, bo[0], bo[1]);
        mma(dpt[2 * p + 1], a, bo[2], bo[3]);
      }
    }

    // P^T in st, dS^T = P^T (dP^T - D) in dpt; lse and D by query column
    const bool interior = kt + kBKV - 1 <= q0 &&
                          kt >= q0 + kBQ2 - window && q0 + kBQ2 <= S;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + c0 + (e & 1);
        float pr = exp2f(st[n][e] * scale_log2 - ls[qi] * kLog2e);
        if (!interior) {
          const int col = q0 + qi;
          const int row = kr + (e >> 1) * 8;
          if (!(col < S && row <= col && row > col - window)) pr = 0.0f;
        }
        st[n][e] = pr;
        dpt[n][e] = pr * (dpt[n][e] - ds[qi]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: k16 step j takes query rows 16j..
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t hi[4], lo[4];
      split_a(st[2 * j], st[2 * j + 1], hi, lo);
      mma_rows_trans<NO, LD>(adv, hi, lo, dos + j * 16 * LD);
      split_a(dpt[2 * j], dpt[2 * j + 1], hi, lo);
      mma_rows_trans<NO, LD>(adk, hi, lo, qs + j * 16 * LD);
    }
    __syncthreads();   // this buffer is loaded again two steps on
  }

  store_rows<NO>(dk + kv_off, kv_stride, adk, kt + warp * 16, S, hd, scale,
                 vec);
  store_rows<NO>(dv + kv_off, kv_stride, adv, kt + warp * 16, S, hd, 1.0f,
                 vec);
}

template <int NO>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int B, int S, int H, int Hkv, int hd,
           int window, float scale, int vec, cudaStream_t stream) {
  constexpr int LD = 16 * ((NO + 1) / 2) + 8;
  const size_t smem_q = static_cast<size_t>(2 * kBQ + 4 * kBK) * LD *
                        sizeof(bf16) + kBQ * sizeof(float);
  const size_t smem_kv = static_cast<size_t>(2 * kBKV + 4 * kBQ2) * LD *
                         sizeof(bf16) + 4 * kBQ2 * sizeof(float);
  auto kq = dq_kernel<NO>;
  auto kkv = dkdv_kernel<NO>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_q));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kkv,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_kv));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* dob = static_cast<const bf16*>(dout);
  kq<<<dim3(H, (S + kBQ - 1) / kBQ, B), kQThreads, smem_q, stream>>>(
      qb, kb, vb, static_cast<const bf16*>(out), dob, lse, dsum,
      static_cast<bf16*>(dq), S, H, Hkv, hd, window, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kkv<<<dim3((S + kBKV - 1) / kBKV, Hkv, B), kKvThreads, smem_kv,
         stream>>>(qb, kb, vb, dob, lse, dsum, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), S, H, Hkv, hd, window, scale,
                   vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 q/k/v/out/dout/dq/dk/dv, lse float32 [B, H, S]; dsum float32
// [B, H, S] scratch (D, written by the first kernel, read by the second);
// vec = 1 when hd % 8 == 0 and every row starts on 16 bytes.  Returns a
// cudaError_t code.
extern "C" int flash_swa_bwd_mma(const void* q, const void* k, const void* v,
                                 const void* out, const void* dout,
                                 const float* lse, float* dsum, void* dq,
                                 void* dk, void* dv, int B, int S, int H,
                                 int Hkv, int hd, int window, float scale,
                                 int vec, cudaStream_t stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || hd <= 0 || hd > kMaxHeadDim ||
      window <= 0 || (S + kBQ - 1) / kBQ > 65535 || Hkv > 65535 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (hd + 7) / 8;
  if (tiles <= 4)
    return launch<4>(q, k, v, out, dout, lse, dsum, dq, dk, dv, B, S, H,
                     Hkv, hd, window, scale, vec, stream);
  if (tiles <= 8)
    return launch<8>(q, k, v, out, dout, lse, dsum, dq, dk, dv, B, S, H,
                     Hkv, hd, window, scale, vec, stream);
  if (tiles <= 12)
    return launch<12>(q, k, v, out, dout, lse, dsum, dq, dk, dv, B, S, H,
                      Hkv, hd, window, scale, vec, stream);
  if (tiles == 15)
    return launch<15>(q, k, v, out, dout, lse, dsum, dq, dk, dv, B, S, H,
                      Hkv, hd, window, scale, vec, stream);
  return launch<16>(q, k, v, out, dout, lse, dsum, dq, dk, dv, B, S, H,
                    Hkv, hd, window, scale, vec, stream);
}
