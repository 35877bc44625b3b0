// The mma.sync helpers that K7's tensor-core kernels share: the forward
// (flash_swa_mma.cu) and the backward (flash_swa_bwd_mma.cu).
//
// * cp.async, ldmatrix (plain and transposed) and mma (d += a b, bf16
//   operands and f32 accumulators) come from the port's shared header
//   kernels/csrc/mma_sync.cuh, which the segmented GEMM's tensor-core
//   instance (segmm/csrc/segmm.cu) also includes;
// * split: an f32 pair as bf16 hi and lo halves (hi + lo carries 16 bits of
//   mantissa), for products whose bf16 rounding alone misses the check,
//   and mma_rows_trans, which runs both halves of an A operand against a
//   block of rows read transposed (P V, dS K, P^T dO, dS^T Q);
// * load_tile: a tile of bf16 rows into shared memory, by 16-byte cp.async
//   or element by element.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/mma_sync.cuh"

namespace swa_mma {

using namespace mma_sync;

using bf16 = __nv_bfloat16;

constexpr int kMaxHeadDim = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit with results below 2^-126 flushed to
// zero (ex2.approx.ftz): exp2f's own ex2.approx without the steps that make
// such results denormal, which a softmax probability of under 1e-38 never
// needs (the wgmma kernels' P)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), packed (x0 in the low half)
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// the A fragments (hi, lo) of a 16x16 block from the accumulators of its
// two n8 tiles c0 (columns 0-7) and c1 (columns 8-15)
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// acc[n] += a b over NO n8 tiles of columns, b = rows [0, 16) of `rows`
// (a [16][LD] block: the k dimension) read transposed; hi and lo are the
// two halves of the A operand
template <int NO, int LD>
__device__ __forceinline__ void mma_rows_trans(float (&acc)[NO][4],
                                               const uint32_t (&hi)[4],
                                               const uint32_t (&lo)[4],
                                               const bf16* rows) {
  const int lane = threadIdx.x & 31;
  const bf16* r = rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD;
#pragma unroll
  for (int np = 0; np < NO / 2; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, r + np * 16 + (lane >> 4) * 8);
    mma(acc[2 * np], hi, b[0], b[1]);
    mma(acc[2 * np], lo, b[0], b[1]);
    mma(acc[2 * np + 1], hi, b[2], b[3]);
    mma(acc[2 * np + 1], lo, b[2], b[3]);
  }
  if (NO % 2 == 1) {
    uint32_t b[2];
    ldmatrix_x2_trans(b, r + (NO - 1) * 8);
    mma(acc[NO - 1], hi, b[0], b[1]);
    mma(acc[NO - 1], lo, b[0], b[1]);
  }
}

// rows [row0, row0 + ROWS) of a [S, row_stride] matrix, columns 0..hd-1
// -> dst[ROWS][LD], by the THREADS threads of the block; rows past S are
// zeros.  vec: 16-byte cp.async (hd % 8 == 0 and 16-byte aligned rows),
// else element by element.
template <int ROWS, int LD, int THREADS>
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst,
                                          const bf16* __restrict__ src,
                                          size_t row_stride, int row0, int S,
                                          int hd, bool vec) {
  if (vec) {
    const int chunks = hd / 8;
    for (int c = threadIdx.x; c < ROWS * chunks; c += THREADS) {
      const int r = c / chunks, ch = c - r * chunks;
      const bool ok = row0 + r < S;
      const bf16* g = ok ? src + static_cast<size_t>(row0 + r) * row_stride +
                               ch * 8
                         : src;
      cp_async16(dst + r * LD + ch * 8, g, ok);
    }
  } else {
    for (int c = threadIdx.x; c < ROWS * hd; c += THREADS) {
      const int r = c / hd, d = c - r * hd;
      dst[r * LD + d] =
          row0 + r < S ? src[static_cast<size_t>(row0 + r) * row_stride + d]
                       : __float2bfloat16(0.0f);
    }
  }
}

}  // namespace swa_mma
