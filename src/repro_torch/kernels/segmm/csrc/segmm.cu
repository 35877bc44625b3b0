// Segmented (grouped) matmul kernels: K5 (one CTA per M-block) and K6 (one
// CTA per physical queue walking its M-blocks).
//
// Replaces: src/repro/kernels/segmm/kernel.py::segmented_matmul
// (_segmm_kernel) and ::segmented_matmul_chunked (_segmm_chunk_kernel).
//
// Both compute out[i*bm:(i+1)*bm, :] = lhs[i*bm:(i+1)*bm, :] @
// rhs[block_expert[i]] in float32: lhs [M_pad, K] and rhs [E, K, N] are
// float32 or bfloat16 (converted to float32 on load, as the reference
// does), out is float32 [M_pad, N].  An M-block whose expert id lies
// outside [0, E) gets zero rows.
//
// Numerics: every output element is one fmaf chain over k = 0, 1, ..., K-1
// in ascending order, starting from +0.0f, computed by the one device
// routine tile_product() below for both kernels and both tile shapes.  So
// the bits of an output row depend only on its lhs row and its expert,
// never on bm, bn, bk, the tile shape, the queue or the block order: K6 is
// bitwise equal to K5, and grouped_matmul is bitwise equal across its
// schedule policies and execution paths.  No TF32, no tensor cores.
//
// Design (a simple kernel, CUDA cores only): a CTA computes TM x TN output
// tiles, staging BK = 8 deep slices of lhs and rhs in shared memory,
// double-buffered through registers; each thread keeps RM x RN float32
// accumulators.  Two shapes: 128 x 128 with 256 threads (8 x 8 per thread,
// two float4 shared loads per operand per k) when bm % 128 == 0 (the MoE
// layer), else 8 x 128 with 128 threads (a column of 8 rows per thread)
// walking the M-block 8 rows at a time (the wavefront's bm = 8 level
// GEMM).  N and K tails are masked.
//
// Bound on the H100: float32 operations (2 * rows * K * N at 67 TFLOP/s)
// for the MoE widths; K6 leaves most SMs idle (NUM_QUEUES = 8 queues x
// N / 128 tiles CTAs), as the reference's queue count dictates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int TM, int TN, int RM, int RN>
struct TileShape {
  static constexpr int kThreads = (TM / RM) * (TN / RN);
  static constexpr int kALoads = (TM * kBK + kThreads - 1) / kThreads;
  static constexpr int kBLoads = (TN * kBK + kThreads - 1) / kThreads;
  static_assert(RM == 8, "rows per thread: two groups of four");
  static_assert(RN == 8 || RN == 1, "columns per thread: 8 or 1");
};

template <int TM, int TN>
struct Smem {
  __align__(16) float a[2][kBK][TM];   // lhs slice, transposed: a[k][row]
  __align__(16) float b[2][kBK][TN];   // rhs slice: b[k][col]
};

// out[r, n0 + c] = sum_k lhs[r, k] * rhs[k, n0 + c] for r < nrows,
// n0 + c < N, as one ascending fmaf chain per element.  lhs points at the
// tile's first row (row stride K), rhs at the expert's [K, N] matrix, out
// at the tile's first row (row stride N).  Every thread of the CTA calls
// it (it synchronises).
template <int TM, int TN, int RM, int RN, typename TA, typename TB>
__device__ void tile_product(const TA* __restrict__ lhs,
                             const TB* __restrict__ rhs,
                             float* __restrict__ out, int nrows, int n0,
                             int K, int N, Smem<TM, TN>& sm) {
  using S = TileShape<TM, TN, RM, RN>;
  const int tid = threadIdx.x;
  const int tx = tid % (TN / RN);
  const int ty = tid / (TN / RN);
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

  float ra[S::kALoads];
  float rb[S::kBLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < S::kALoads; ++l) {
      const int idx = tid + l * S::kThreads;
      const int m = idx / kBK, k = idx % kBK;
      float v = 0.0f;
      if (idx < TM * kBK && m < nrows && k0 + k < K)
        v = to_f32(lhs[static_cast<size_t>(m) * K + k0 + k]);
      ra[l] = v;
    }
#pragma unroll
    for (int l = 0; l < S::kBLoads; ++l) {
      const int idx = tid + l * S::kThreads;
      const int k = idx / TN, c = idx % TN;
      float v = 0.0f;
      if (idx < TN * kBK && k0 + k < K && n0 + c < N)
        v = to_f32(rhs[static_cast<size_t>(k0 + k) * N + n0 + c]);
      rb[l] = v;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int l = 0; l < S::kALoads; ++l) {
      const int idx = tid + l * S::kThreads;
      if (idx < TM * kBK) sm.a[buf][idx % kBK][idx / kBK] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < S::kBLoads; ++l) {
      const int idx = tid + l * S::kThreads;
      if (idx < TN * kBK) sm.b[buf][idx / TN][idx % TN] = rb[l];
    }
  };
  auto step = [&](int buf, int kk) {
    float a[RM], b[RN];
    const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[buf][kk][ty * 4]);
    const float4 a1 =
        *reinterpret_cast<const float4*>(&sm.a[buf][kk][TM / 2 + ty * 4]);
    a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
    a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
    if constexpr (RN == 8) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(&sm.b[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sm.b[buf][kk][TN / 2 + tx * 4]);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
    } else {
      b[0] = sm.b[buf][kk][tx];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  };

  const int ktiles = (K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) load((kt + 1) * kBK);
    const int kend = K - kt * kBK;
    if (kend >= kBK) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) step(buf, kk);
    } else {
      for (int kk = 0; kk < kend; ++kk) step(buf, kk);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = (i / 4) * (TM / 2) + ty * 4 + (i % 4);
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = RN == 8 ? (j / 4) * (TN / 2) + tx * 4 + (j % 4) : tx;
      if (n0 + c < N) out[static_cast<size_t>(r) * N + n0 + c] = acc[i][j];
    }
  }
}

// All of M-block `blk`'s rows, columns [n0, n0 + TN): TM rows at a time.
template <int TM, int TN, int RM, int RN, typename TA, typename TB>
__device__ void block_product(const TA* __restrict__ lhs,
                              const TB* __restrict__ rhs,
                              const int* __restrict__ block_expert, int blk,
                              int bm, int K, int N, int E, int n0,
                              float* __restrict__ out, Smem<TM, TN>& sm) {
  const int e = block_expert[blk];
  const size_t row0 = static_cast<size_t>(blk) * bm;
  if (e < 0 || e >= E) {
    for (int idx = threadIdx.x; idx < bm * TN; idx += blockDim.x) {
      const int r = idx / TN, c = idx % TN;
      if (n0 + c < N) out[(row0 + r) * N + n0 + c] = 0.0f;
    }
    return;
  }
  const TB* rhs_e = rhs + static_cast<size_t>(e) * K * N;
  for (int r0 = 0; r0 < bm; r0 += TM) {
    const int nrows = bm - r0 < TM ? bm - r0 : TM;
    tile_product<TM, TN, RM, RN>(lhs + (row0 + r0) * K, rhs_e,
                                 out + (row0 + r0) * N, nrows, n0, K, N, sm);
  }
}

// K5: grid (M-blocks, N tiles).
template <int TM, int TN, int RM, int RN, typename TA, typename TB>
__global__ void __launch_bounds__(TileShape<TM, TN, RM, RN>::kThreads)
segmm_blocks_kernel(const TA* __restrict__ lhs, const TB* __restrict__ rhs,
                    const int* __restrict__ block_expert, int bm, int K,
                    int N, int E, float* __restrict__ out) {
  __shared__ Smem<TM, TN> sm;
  block_product<TM, TN, RM, RN>(lhs, rhs, block_expert, blockIdx.x, bm, K, N,
                                E, blockIdx.y * TN, out, sm);
}

// K6: grid (physical queues, N tiles); queue p pops
// chunks[p * max_chunks + i] for i < counts[p] and writes each M-block in
// place (original row order, no permutation).
template <int TM, int TN, int RM, int RN, typename TA, typename TB>
__global__ void __launch_bounds__(TileShape<TM, TN, RM, RN>::kThreads)
segmm_queues_kernel(const TA* __restrict__ lhs, const TB* __restrict__ rhs,
                    const int* __restrict__ block_expert,
                    const int* __restrict__ chunks,
                    const int* __restrict__ counts, int max_chunks,
                    int num_blocks, int bm, int K, int N, int E,
                    float* __restrict__ out) {
  __shared__ Smem<TM, TN> sm;
  const int p = blockIdx.x;
  const int count = counts[p] < max_chunks ? counts[p] : max_chunks;
  for (int i = 0; i < count; ++i) {
    const int c = chunks[static_cast<size_t>(p) * max_chunks + i];
    if (c < 0 || c >= num_blocks) continue;
    block_product<TM, TN, RM, RN>(lhs, rhs, block_expert, c, bm, K, N, E,
                                  blockIdx.y * TN, out, sm);
  }
}

struct Args {
  const void* lhs;
  const void* rhs;
  const int* block_expert;
  const int* chunks;   // nullptr: K5
  const int* counts;
  int grid_x, max_chunks, num_blocks, bm, K, N, E;
  float* out;
  cudaStream_t stream;
};

template <int TM, int TN, int RM, int RN, typename TA, typename TB>
int launch(const Args& a) {
  constexpr int kThreads = TileShape<TM, TN, RM, RN>::kThreads;
  const dim3 grid(a.grid_x, (a.N + TN - 1) / TN);
  const TA* lhs = static_cast<const TA*>(a.lhs);
  const TB* rhs = static_cast<const TB*>(a.rhs);
  if (a.chunks == nullptr) {
    segmm_blocks_kernel<TM, TN, RM, RN, TA, TB>
        <<<grid, kThreads, 0, a.stream>>>(lhs, rhs, a.block_expert, a.bm,
                                          a.K, a.N, a.E, a.out);
  } else {
    segmm_queues_kernel<TM, TN, RM, RN, TA, TB>
        <<<grid, kThreads, 0, a.stream>>>(
            lhs, rhs, a.block_expert, a.chunks, a.counts, a.max_chunks,
            a.num_blocks, a.bm, a.K, a.N, a.E, a.out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TB>
int launch_shape(const Args& a) {
  if (a.bm % 128 == 0) return launch<128, 128, 8, 8, TA, TB>(a);
  return launch<8, 128, 8, 1, TA, TB>(a);
}

// dtype codes: 0 = float32, 1 = bfloat16.
int dispatch(int lhs_dtype, int rhs_dtype, const Args& a) {
  if (a.grid_x == 0 || a.N == 0) return 0;
  if (lhs_dtype == 0 && rhs_dtype == 0) return launch_shape<float, float>(a);
  if (lhs_dtype == 0 && rhs_dtype == 1)
    return launch_shape<float, __nv_bfloat16>(a);
  if (lhs_dtype == 1 && rhs_dtype == 0)
    return launch_shape<__nv_bfloat16, float>(a);
  if (lhs_dtype == 1 && rhs_dtype == 1)
    return launch_shape<__nv_bfloat16, __nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int segmm_blocks(const void* lhs, int lhs_dtype, const void* rhs,
                            int rhs_dtype, const int* block_expert,
                            int num_blocks, int bm, int K, int N, int E,
                            float* out, cudaStream_t stream) {
  const Args a{lhs, rhs, block_expert, nullptr, nullptr, num_blocks, 0,
               num_blocks, bm, K, N, E, out, stream};
  return dispatch(lhs_dtype, rhs_dtype, a);
}

extern "C" int segmm_queues(const void* lhs, int lhs_dtype, const void* rhs,
                            int rhs_dtype, const int* block_expert,
                            const int* chunks, const int* counts,
                            int num_physical, int max_chunks, int num_blocks,
                            int bm, int K, int N, int E, float* out,
                            cudaStream_t stream) {
  const Args a{lhs, rhs, block_expert, chunks, counts, num_physical,
               max_chunks, num_blocks, bm, K, N, E, out, stream};
  return dispatch(lhs_dtype, rhs_dtype, a);
}
