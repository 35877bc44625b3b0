// The mma.sync primitives that K7's tensor-core kernels share: the forward
// (flash_swa_mma.cu) and the backward (flash_swa_bwd_mma.cu).
//
// * cp.async copies global -> shared (16 bytes, or 4 for f32 rows), with a
//   zero fill where the source is out of range;
// * ldmatrix loads of bf16 8x8 matrices, plain and transposed, in the
//   fragment layouts of mma.m16n8k16 (FlashAttention-2's register layout);
// * mma: d += a b, bf16 operands and f32 accumulators;
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

namespace swa_mma {

using bf16 = __nv_bfloat16;

constexpr int kMaxHeadDim = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zeros when !valid (nothing is read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
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
