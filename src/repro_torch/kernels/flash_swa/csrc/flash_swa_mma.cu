// Banded causal sliding-window attention on the tensor cores with
// mma.sync: K7 for bfloat16 inputs with head_dim <= 128 that is not a
// multiple of 8 (TMA's 16-byte row strides).
//
// Replaces: src/repro/kernels/flash_swa/kernel.py::flash_swa
// (_flash_swa_kernel), as flash_swa_wgmma.cu (wgmma fed by TMA: bf16 heads
// that are a multiple of 8, every head of the main paths) and flash_swa.cu
// (float32, wider heads) do; the wrapper (kernel.py::flash_swa) routes by
// dtype and head width.
//
// Computes what flash_swa.cu computes (its header states the function and
// the reference's -1e30 fill, which this kernel keeps, with the same
// cancellation argument), for q [B, S, H, hd] and k/v [B, S, Hkv, hd] in
// bfloat16 (query head h reads KV head h / (H / Hkv), no copy), out in
// bfloat16.  Precision:
// * S = Q K^T: bf16 products are exact in f32, accumulated in f32;
// * the softmax runs in f32 in the base-2 domain (exp2f, the scale folded
//   with log2 e into one multiply), and the normaliser l sums the f32 P;
// * P V: P rounded to bf16 alone misses the check against the f32 plain
//   version (|err| <= 1e-4 + 1e-2 |want|) on a few per cent of the
//   elements, so P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi)
//   (the difference is exact in f32) and both go through the tensor cores
//   into the same f32 accumulator;
// * the output is rounded to bf16 once;
// * when lse is not null, each row's log-sum-exp (natural log, f32, [B, H,
//   S]) is written too: (m + log2(l)) * ln 2 from the base-2 running max m
//   and the row sum l, for the backward (flash_swa_bwd.cu).
//
// Bound on the H100: operations.  The band holds sum_i min(i + 1, window)
// (query, key) pairs per head, 4 * hd flop each; at Danube's prefill (S
// 32,768, window 4,096, 32 heads of 120) 1.93 TFLOP, 1.95 ms at the 989
// TFLOP/s dense bf16 peak.  This kernel executes about 1.6x that: hd 120
// padded to 128 for Q K^T, P V twice (the split), and the band's two edge
// tiles computed whole and masked.
//
// Design (mma.sync, FlashAttention-2's register layout):
// * one CTA of 8 warps per (128-row query tile, query head, batch); warp w
//   owns query rows 16w..16w+15 (199 registers a thread at hd 120: one CTA
//   per SM).  The grid runs the heads fastest, so the H / Hkv query heads
//   of one KV head, and the neighbouring query tiles, run together and
//   read the same KV band from L2;
// * the CTA walks only the 64-row KV tiles of its band, [max(0, q0 -
//   window + 1), q_last], double-buffered in shared memory with cp.async
//   (16 bytes a lane; rows past S filled with zeros); rows are padded by
//   16 bytes, so the 8 rows of each ldmatrix phase hit distinct banks;
// * the head is padded with zeros to a multiple of 16 in shared memory (120
//   -> 128) for mma.m16n8k16; Q's fragments stay in registers for the
//   whole walk; S accumulates in f32 registers; the row max and row sum
//   are quad shuffles; S's accumulator becomes P's A fragments in
//   registers (nothing goes through shared memory); P V runs over
//   ceil(hd / 8) n8 tiles (15 at hd 120), with V's B fragments from
//   ldmatrix.trans;
// * the mask is applied only on tiles that cross the band's edges (the
//   diagonal tiles and the lower edge tile; a ragged tail past S lies on
//   a diagonal tile); the others are read whole.
// flash_swa_wgmma.cu is this design's successor on Hopper's own path.
#include "flash_swa_mma.cuh"

namespace {

using namespace swa_mma;

constexpr int kWarps = 8;             // 4 timed slower on the H100
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;       // query rows per CTA: 128
constexpr int kBK = 64;                // KV rows per tile
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

// NO: output n8 tiles (hd <= 8 NO); the head is padded to DP = 16 KD.
template <int NO>
__global__ void __launch_bounds__(kThreads, 8 / kWarps)
flash_swa_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int S, int H, int Hkv, int hd,
                     int window, float scale_log2, int vec) {
  constexpr int KD = (NO + 1) / 2;     // k16 steps of Q K^T
  constexpr int DP = 16 * KD;
  constexpr int LD = DP + 8;           // row stride: 16 bytes of padding
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);   // [kBQ][LD]
  bf16* sk = sq + kBQ * LD;                       // [2][kBK][LD]
  bf16* sv = sk + 2 * kBK * LD;                   // [2][kBK][LD]

  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, q0 = blockIdx.y * kBQ, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(Hkv) * hd;
  const bf16* qg = q + static_cast<size_t>(b) * S * q_stride +
                   static_cast<size_t>(h) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride +
                        static_cast<size_t>(hk) * hd;
  const bf16* kg = k + kv_off;
  const bf16* vg = v + kv_off;

  // the padding columns [hd, DP) of every row are never loaded: zero them
  const int pad = DP - hd;
  for (int i = tid; i < (kBQ + 4 * kBK) * pad; i += kThreads) {
    sq[(i / pad) * LD + hd + i % pad] = __float2bfloat16(0.0f);
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt0 = max(0, q0 - window + 1) / kBK * kBK;
  const int ntiles = (q_last - kt0) / kBK + 1;

  load_tile<kBQ, LD, kThreads>(sq, qg, q_stride, q0, S, hd, vec);
  load_tile<kBK, LD, kThreads>(sk, kg, kv_stride, kt0, S, hd, vec);
  load_tile<kBK, LD, kThreads>(sv, vg, kv_stride, kt0, S, hd, vec);
  cp_async_commit();

  uint32_t qf[KD][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};           // this lane's share of the row sums
  const int ra = q0 + warp * 16 + (lane >> 2);   // rows ra and ra + 8
  const int c0 = 2 * (lane & 3);                 // columns c0, c0 + 1

  for (int it = 0; it < ntiles; ++it) {
    const int kt = kt0 + it * kBK;
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      load_tile<kBK, LD, kThreads>(sk + (buf ^ 1) * kBK * LD, kg, kv_stride,
                                   kt + kBK, S, hd, vec);
      load_tile<kBK, LD, kThreads>(sv + (buf ^ 1) * kBK * LD, vg, kv_stride,
                                   kt + kBK, S, hd, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldmatrix_x4(qf[kk], sq + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                (lane >> 4) * 8);
      }
    }
    const bf16* ks = sk + buf * kBK * LD;
    const bf16* vs = sv + buf * kBK * LD;

    // S = Q K^T: 8 n8 tiles of KV columns, 4 f32 per lane each
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (p * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma(s[2 * p], qf[kk], bk[0], bk[1]);
        mma(s[2 * p + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale (base 2) and, on tiles that cross the band's edges, mask
    const bool interior = kt + kBK - 1 <= q0 && kt >= q0 + kBQ - window;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (!interior) {
          const int col = kt + n * 8 + c0 + (e & 1);
          const int row = ra + (e >> 1) * 8;
          if (!(col <= row && col > row - window)) x = kNegInf;
        }
        s[n][e] = x;
      }
    }

    // online softmax: new row max, correction, P = exp2(S - m)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    const float corr[2] = {exp2f(m[0] - mx[0]), exp2f(m[1] - mx[1])};
    m[0] = mx[0];
    m[1] = mx[1];
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - mx[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
    }
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P_hi V + P_lo V: k16 step j takes KV rows 16j..16j+15
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t ph[4], pl[4];
      split_a(s[2 * j], s[2 * j + 1], ph, pl);
      mma_rows_trans<NO, LD>(o, ph, pl, vs + j * 16 * LD);
    }
    __syncthreads();   // this buffer is loaded again two tiles on
  }

  // out = O / max(l, 1e-30), rounded to bf16 once
  const float denom[2] = {fmaxf(quad_sum(l[0]), 1e-30f),
                          fmaxf(quad_sum(l[1]), 1e-30f)};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = ra + half * 8;
    if (row >= S) continue;
    if (lse != nullptr && (lane & 3) == 0) {
      lse[(static_cast<size_t>(b) * H + h) * S + row] =
          (m[half] + log2f(denom[half])) * kLn2;
    }
    bf16* dst = out + static_cast<size_t>(b) * S * q_stride +
                static_cast<size_t>(row) * q_stride +
                static_cast<size_t>(h) * hd;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + c0;
      const float x0 = o[n][2 * half] / denom[half];
      const float x1 = o[n][2 * half + 1] / denom[half];
      if (vec && col < hd) {           // hd % 8 == 0: col + 1 < hd too
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < hd) dst[col] = __float2bfloat16(x0);
        if (col + 1 < hd) dst[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int NO>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int H, int Hkv, int hd, int window,
           float scale, int vec, cudaStream_t stream) {
  constexpr int LD = 16 * ((NO + 1) / 2) + 8;
  const size_t smem = static_cast<size_t>(kBQ + 4 * kBK) * LD *
                      sizeof(bf16);
  auto kernel = flash_swa_mma_kernel<NO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, (S + kBQ - 1) / kBQ, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, H, Hkv,
      hd, window, scale * kLog2e, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 q/k/v/out; lse float32 [B, H, S] or null (serving writes none);
// vec = 1 when hd % 8 == 0 and every row starts on 16 bytes.  Returns a
// cudaError_t code.
extern "C" int flash_swa_mma_fwd(const void* q, const void* k, const void* v,
                                 void* out, float* lse, int B, int S, int H,
                                 int Hkv, int hd, int window, float scale,
                                 int vec, cudaStream_t stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || hd <= 0 || hd > kMaxHeadDim ||
      window <= 0 || (S + kBQ - 1) / kBQ > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (hd + 7) / 8;
  if (tiles <= 4)
    return launch<4>(q, k, v, out, lse, B, S, H, Hkv, hd, window, scale,
                     vec, stream);
  if (tiles <= 8)
    return launch<8>(q, k, v, out, lse, B, S, H, Hkv, hd, window, scale,
                     vec, stream);
  if (tiles <= 12)
    return launch<12>(q, k, v, out, lse, B, S, H, Hkv, hd, window, scale,
                      vec, stream);
  if (tiles == 15)
    return launch<15>(q, k, v, out, lse, B, S, H, Hkv, hd, window, scale,
                      vec, stream);
  return launch<16>(q, k, v, out, lse, B, S, H, Hkv, hd, window, scale,
                    vec, stream);
}
