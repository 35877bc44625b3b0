// Card-test probes of the wgmma shapes that K7 and its backward use
// (src/repro_torch/kernels/csrc/wgmma.cuh), on operands loaded as the
// kernels load them: TMA 2-D boxes of 64 bf16 columns with the 128-byte
// swizzle.  One warpgroup computes one 64 x N product and writes it as
// float32 [64, N] from the accumulator layout.
// * probe_ss: out = A B^T, A [64, K] and B [N, K] K-major in shared
//   memory (mma_ss<N>, N = 64 or 128; K = 64 or 128: one or two boxes);
// * probe_rs: out = A B, A [64, K] from registers in the m16n8k16 A
//   layout, B [K, N] MN-major in shared memory (mma_rs<N>, N = 64, 120 or
//   128; K = 64 or 128 rows a box, LBO = K * 128 bytes between 64-column
//   boxes, as every B tile of the kernels).
// tests/test_torch_cuda.py holds both to torch.matmul on integer-valued
// operands (exact in float32), so any layout fault shows as a mismatch.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../src/repro_torch/kernels/csrc/tma.cuh"
#include "../../src/repro_torch/kernels/csrc/wgmma.cuh"

namespace {

constexpr int kSmem = 2 * 128 * 128 * 2 + 1024;   // two 128 x 128 tiles

template <int N>
__device__ void store(float* out, const float (&d)[N / 2]) {
  const int t = threadIdx.x, g = (t % 32) / 4, c = 2 * (t % 4);
  const int row = 16 * (t / 32) + g;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    out[row * N + 8 * j + c] = d[4 * j];
    out[row * N + 8 * j + c + 1] = d[4 * j + 1];
    out[(row + 8) * N + 8 * j + c] = d[4 * j + 2];
    out[(row + 8) * N + 8 * j + c + 1] = d[4 * j + 3];
  }
}

template <int N>
__global__ void ss_kernel(const __grid_constant__ CUtensorMap a_map,
                          const __grid_constant__ CUtensorMap b_map, int K,
                          float* out) {
  extern __shared__ unsigned char raw[];
  __shared__ __align__(8) uint64_t bar;
  unsigned char* sa = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t{1023});
  unsigned char* sb = sa + 128 * 128 * 2;
  const int boxes = K / 64;
  if (threadIdx.x == 0) {
    tma::mbar_init(&bar, 1);
    tma::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tma::mbar_arrive_expect_tx(&bar, boxes * (64 + N) * 128);
    for (int x = 0; x < boxes; ++x) {
      tma::load_2d(sa + x * 64 * 128, &a_map, &bar, x * 64, 0);
      tma::load_2d(sb + x * N * 128, &b_map, &bar, x * 64, 0);
    }
  }
  tma::mbar_wait(&bar, 0);
  float d[N / 2];
  const uint64_t da = wgmma::desc_sw128(sa, 0, 1024);
  const uint64_t db = wgmma::desc_sw128(sb, 0, 1024);
  wgmma::fence_operands(d);
  wgmma::fence();
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t oa = (kk / 4) * 64 * 128 + (kk % 4) * 32;
    const uint32_t ob = (kk / 4) * N * 128 + (kk % 4) * 32;
    wgmma::mma_ss<N>(d, da + (oa >> 4), db + (ob >> 4), kk > 0);
  }
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operands(d);
  store<N>(out, d);
}

template <int N>
__global__ void rs_kernel(const __nv_bfloat16* a,
                          const __grid_constant__ CUtensorMap b_map, int K,
                          float* out) {
  extern __shared__ unsigned char raw[];
  __shared__ __align__(8) uint64_t bar;
  unsigned char* sb = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t{1023});
  constexpr int kBoxes = (N + 63) / 64;
  if (threadIdx.x == 0) {
    tma::mbar_init(&bar, 1);
    tma::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tma::mbar_arrive_expect_tx(&bar, kBoxes * K * 128);
    for (int x = 0; x < kBoxes; ++x)
      tma::load_2d(sb + x * K * 128, &b_map, &bar, x * 64, 0);
  }
  const int t = threadIdx.x, g = (t % 32) / 4, c = 2 * (t % 4);
  const int row = 16 * (t / 32) + g;
  auto pack = [&](int r, int k) {
    __nv_bfloat162 v;
    v.x = a[r * K + k];
    v.y = a[r * K + k + 1];
    return *reinterpret_cast<uint32_t*>(&v);
  };
  tma::mbar_wait(&bar, 0);
  float d[N / 2];
  const uint64_t db = wgmma::desc_sw128(sb, K * 128, 1024);
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t frag[4] = {pack(row, 16 * kk + c),
                              pack(row + 8, 16 * kk + c),
                              pack(row, 16 * kk + c + 8),
                              pack(row + 8, 16 * kk + c + 8)};
    wgmma::fence_operands(d);
    wgmma::fence();
    wgmma::mma_rs<N>(d, frag, db + ((kk * 16 * 128) >> 4), kk > 0);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(d);
  }
  store<N>(out, d);
}

int map_2d(CUtensorMap* map, const void* base, int cols, int rows,
           int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return tma::encode_tiled(map, base, 2, dims, strides, box);
}

template <typename Kernel>
int prepare(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem));
}

}  // namespace

// out [64, N] = a [64, K] @ b [N, K]^T; returns a cudaError_t code.
extern "C" int probe_ss(const void* a, const void* b, float* out, int N,
                        int K) {
  if ((N != 64 && N != 128) || (K != 64 && K != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap a_map, b_map;
  int err = map_2d(&a_map, a, K, 64, 64);
  if (!err) err = map_2d(&b_map, b, K, N, N);
  if (err) return err;
  if (N == 64) {
    if ((err = prepare(ss_kernel<64>))) return err;
    ss_kernel<64><<<1, 128, kSmem>>>(a_map, b_map, K, out);
  } else {
    if ((err = prepare(ss_kernel<128>))) return err;
    ss_kernel<128><<<1, 128, kSmem>>>(a_map, b_map, K, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [64, N] = a [64, K] @ b [K, N]; returns a cudaError_t code.
extern "C" int probe_rs(const void* a, const void* b, float* out, int N,
                        int K) {
  if ((N != 64 && N != 120 && N != 128) || (K != 64 && K != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap b_map;
  int err = map_2d(&b_map, b, N, K, K);
  if (err) return err;
  const auto* ab = static_cast<const __nv_bfloat16*>(a);
  if (N == 64) {
    if ((err = prepare(rs_kernel<64>))) return err;
    rs_kernel<64><<<1, 128, kSmem>>>(ab, b_map, K, out);
  } else if (N == 120) {
    if ((err = prepare(rs_kernel<120>))) return err;
    rs_kernel<120><<<1, 128, kSmem>>>(ab, b_map, K, out);
  } else {
    if ((err = prepare(rs_kernel<128>))) return err;
    rs_kernel<128><<<1, 128, kSmem>>>(ab, b_map, K, out);
  }
  return static_cast<int>(cudaGetLastError());
}
