// Segmented (grouped) matmul kernels: K5 (a grid over groups of M-blocks)
// and K6 (a team of CTAs draining each physical queue of M-blocks).
//
// Replaces: src/repro/kernels/segmm/kernel.py::segmented_matmul
// (_segmm_kernel) and ::segmented_matmul_chunked (_segmm_chunk_kernel).
//
// Both compute out[i*bm:(i+1)*bm, :] = lhs[i*bm:(i+1)*bm, :] @
// rhs[block_expert[i]] in float32: lhs [M_pad, K] and rhs [E, K, N] are
// float32 or bfloat16 (converted exactly to float32 on the way into shared
// memory, as the reference does), out is float32 [M_pad, N].  An M-block
// whose expert id lies outside [0, E) gets zero rows.
//
// Numerics: every output element is one fmaf chain over k = 0, 1, ..., K-1
// in ascending order, starting from +0.0f, computed by the one device
// routine tile_product() below for both kernels.  So the bits of an output
// row depend only on its lhs row and its expert, never on bm, bn, bk, the
// tile, the grouping, the queue, the team or the CTA order: K6 is bitwise
// equal to K5, and grouped_matmul is bitwise equal across its schedule
// policies and execution paths.  No split-K, no TF32, no tensor cores.  The
// k tail of the last slice is skipped (the chain stops at K-1), and rows
// past a tile's end and columns past N are computed on zero-filled operands
// but never stored.
//
// Design (CUDA cores, one tile shape): a CTA of 128 threads computes
// 128 x 128 output tiles.  Each thread holds an 8 x 16 register tile, so
// one k step is 2 + 4 float4 shared loads for 128 FMAs, and the fragments
// of step k + 1 are loaded before the FMAs of step k.  k goes through a
// ring of kStages shared-memory slices kBK deep, filled ahead of the math:
// rhs rows by 16-byte cp.async copies (4-byte copies where N % 4 or the
// alignment forbids them; zero-fill past K and N), lhs quads by 16-byte
// register loads issued a slice ahead and stored transposed (a[k][row],
// padded) after the slice's math; bfloat16 operands go through registers
// and are converted exactly.  ptxas fits the float32 instance in 255
// registers without spills; two CTAs share an SM (66.5 KB of dynamic
// shared memory each).
//
// Work: a CTA takes a group of up to `group` M-blocks (group = 128 / bm
// for bm < 128, else 1) and one N tile; consecutive group entries with the
// same expert form one run, whose rows (gathered through a per-tile row
// table) go through the tile 128 at a time.  K5: CTA id -> (group of
// consecutive M-blocks, N tile), the N tile fastest, so the N tiles of one
// lhs block run side by side and read it from L2.  K6: the physical queues
// keep the schedule's contents and pop order; queue p and N tile n are
// drained by a team of ceil(max_chunks / group) CTAs, CTA t popping slot
// group t and writing each of its M-blocks in place.  The wrapper zeroes
// the output beforehand, so the rows of M-blocks no queue pops stay zero.
// Grids are 1-D.
//
// Bound on the H100: float32 operations (2 * rows * K * N at 67 TFLOP/s)
// at the MoE widths and at the wavefront's level GEMM.  What holds the
// kernel near half of that is the math loop itself, shared loads feeding
// FMAs (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kTM = 128;               // tile rows
constexpr int kTN = 128;               // tile columns
constexpr int kBK = 16;                // k depth of a shared-memory slice
constexpr int kStages = 4;             // slices in the ring
constexpr int kRows = 8;               // outputs per thread: kRows rows
constexpr int kCols = 16;              // x kCols columns, in float4 groups
constexpr int kColGroups = kCols / 4;
constexpr int kColSpan = kTN / kColGroups;   // column distance of groups
constexpr int kThreadCols = kTN / kCols;     // threads across the tile
constexpr int kThreads = (kTM / kRows) * kThreadCols;
constexpr int kAStride = kTM + 4;      // a[k][row], padded, float4-aligned
constexpr int kAFloats = kBK * kAStride;
constexpr int kStageFloats = kAFloats + kBK * kTN;
constexpr int kSmemBytes = kStages * kStageFloats * 4;

static_assert(kBK % 4 == 0, "slice depth: whole quads");
static_assert(kThreads % (kBK / 4) == 0, "lhs quads per thread");
static_assert(kTM * kBK / 4 % kThreads == 0, "lhs quads per thread");
static_assert(kBK * kTN / 4 % kThreads == 0, "rhs quads per thread");
static_assert(kStages >= 2, "ring of at least two slices");
static_assert(kCols % 4 == 0 && kTN % kCols == 0, "column groups");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// Copy kBytes (4 or 16) from global to shared; zero-fill when !full.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const void* src,
                                         bool full) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(full ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(full ? 4 : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// An rhs slice is copied in quads of 4 consecutive columns.  A float32
// rhs is cp.async'd: one 16-byte copy per quad when kVec (K % 4 == 0, N %
// 4 == 0, 16-byte aligned bases), else four 4-byte copies.  A bfloat16 rhs
// is loaded into registers, converted, and stored after the slice's math.
template <typename T, bool kVec, int kQuads>
struct RhsQuads {
  static constexpr bool kAsync = std::is_same<T, float>::value;
  float staged[kAsync ? 1 : 4 * kQuads];

  // Quad l: src points at its first element, `left` elements of it are
  // real (<= 0: none), dst is its place in shared memory.
  __device__ __forceinline__ void fetch(int l, const T* src, int left,
                                        float* dst) {
    if constexpr (kAsync && kVec) {
      cp_async<16>(dst, src, left > 0);   // src is not read when empty
    } else if constexpr (kAsync) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async<4>(dst + j, src + j, j < left);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        staged[4 * l + j] = j < left ? to_f32(src[j]) : 0.0f;
    }
  }
  __device__ __forceinline__ void put(int l, float* dst) {
    if constexpr (!kAsync)
      *reinterpret_cast<float4*>(dst) =
          make_float4(staged[4 * l], staged[4 * l + 1], staged[4 * l + 2],
                      staged[4 * l + 3]);
  }
};

struct Params {
  const void* lhs;
  const void* rhs;
  const int* block_expert;
  const int* chunks;   // nullptr: K5
  const int* counts;
  int num_physical, max_chunks, num_blocks, bm, group, K, N, E;
  int n_tiles;
  float* out;
};

// out[s_row[m], n0 + c] = sum_k lhs[s_row[m], k] * rhs_e[k, n0 + c] for
// m < nrows, n0 + c < N, as one ascending fmaf chain per element.
// s_row (shared) holds the tile's global lhs/out rows.  Every thread of
// the CTA calls it (it synchronises).
template <typename TA, typename TB, bool kVec>
__device__ void tile_product(const TA* __restrict__ lhs,
                             const TB* __restrict__ rhs_e,
                             float* __restrict__ out, const int* s_row,
                             int nrows, int n0, int K, int N, float* smem) {
  constexpr int kAQuadCols = kBK / 4;                 // quads per lhs row
  constexpr int kAQuads = kTM * kAQuadCols / kThreads;
  constexpr int kARowStep = kThreads / kAQuadCols;
  constexpr int kBQuadCols = kTN / 4;                 // quads per rhs row
  constexpr int kBQuads = kBK * kBQuadCols / kThreads;
  constexpr int kBRowStep = kThreads / kBQuadCols;
  constexpr bool kVecA = kVec && std::is_same<TA, float>::value;
  const int tid = threadIdx.x;

  // lhs quads: k columns qa.. of tile rows ra + l * kARowStep, loaded into
  // registers a slice ahead (a warp reads whole 64-byte row segments) and
  // stored transposed, a[k][row], after the current slice's math.  Row
  // pointers are set once per tile.
  const int qa = (tid % kAQuadCols) * 4, ra = tid / kAQuadCols;
  const TA* arow[kAQuads];
#pragma unroll
  for (int l = 0; l < kAQuads; ++l) {
    const int m = ra + l * kARowStep;
    arow[l] = lhs + static_cast<size_t>(m < nrows ? s_row[m] : 0) * K + qa;
  }
  float a_staged[kAQuads][4];
  auto fetch_a = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kAQuads; ++l) {
      const int left = ra + l * kARowStep < nrows ? K - k0 - qa : 0;
      if constexpr (kVecA) {   // K % 4 == 0: the quad is whole or empty
        const float4 v = left > 0
            ? *reinterpret_cast<const float4*>(arow[l] + k0)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        a_staged[l][0] = v.x; a_staged[l][1] = v.y; a_staged[l][2] = v.z;
        a_staged[l][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a_staged[l][j] = j < left ? to_f32(arow[l][k0 + j]) : 0.0f;
      }
    }
  };
  auto put_a = [&](int stage) {
    float* as = smem + stage * kStageFloats;
#pragma unroll
    for (int l = 0; l < kAQuads; ++l)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        as[(qa + j) * kAStride + ra + l * kARowStep] = a_staged[l][j];
  };
  // rhs quads: columns cb.. of slice rows rb + l * kBRowStep.
  const int cb = (tid % kBQuadCols) * 4, rb = tid / kBQuadCols;
  const int b_left = N - n0 - cb;
  const TB* brow = rhs_e + static_cast<size_t>(rb) * N + n0 + cb;
  RhsQuads<TB, kVec, kBQuads> b_quads;
  auto fetch_b = [&](int k0, int stage) {
    float* bs = smem + stage * kStageFloats + kAFloats;
#pragma unroll
    for (int l = 0; l < kBQuads; ++l) {
      const int k = rb + l * kBRowStep;
      b_quads.fetch(l, brow + static_cast<size_t>(k0 + l * kBRowStep) * N,
                    k0 + k < K ? b_left : 0, bs + k * kTN + cb);
    }
  };
  auto put_b = [&](int stage) {   // register-staged (bfloat16) rhs only
    float* bs = smem + stage * kStageFloats + kAFloats;
#pragma unroll
    for (int l = 0; l < kBQuads; ++l)
      b_quads.put(l, bs + (rb + l * kBRowStep) * kTN + cb);
  };

  // Thread (tx, ty) owns rows ty * 4 + {0..3} and kTM / 2 + ty * 4 +
  // {0..3}, and columns g * kColSpan + tx * 4 + {0..3} for g < kColGroups.
  // The 8 lanes of a quarter warp share ty: their lhs float4s are one
  // broadcast address, their rhs float4s 128 contiguous bytes.  The
  // fragments of step k + 1 are loaded before the FMAs of step k.
  const int tx = tid % kThreadCols, ty = tid / kThreadCols;
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  auto load_frag = [&](const float* as, const float* bs, int kk, float* a,
                       float* b) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(
          as + kk * kAStride + h * (kTM / 2) + ty * 4);
      a[4 * h] = v.x; a[4 * h + 1] = v.y; a[4 * h + 2] = v.z;
      a[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int g = 0; g < kColGroups; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(
          bs + kk * kTN + g * kColSpan + tx * 4);
      b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z;
      b[4 * g + 3] = v.w;
    }
  };
  auto fmas = [&](const float* a, const float* b) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  };

  const int ktiles = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) {
      fetch_a(s * kBK);
      put_a(s);
      fetch_b(s * kBK, s);
      put_b(s);
    }
    cp_async_commit();
  }
  float fa[2][kRows], fb[2][kCols];
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // slice kt landed; slice kt - 1 is read by all
    const int next = kt + kStages - 1;
    if (next < ktiles) {
      fetch_a(next * kBK);
      fetch_b(next * kBK, next % kStages);
    }
    cp_async_commit();
    const float* as = smem + (kt % kStages) * kStageFloats;
    const float* bs = as + kAFloats;
    const int kend = K - kt * kBK;
    if (kend >= kBK) {
      load_frag(as, bs, 0, fa[0], fb[0]);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        if (kk + 1 < kBK)
          load_frag(as, bs, kk + 1, fa[(kk + 1) % 2], fb[(kk + 1) % 2]);
        fmas(fa[kk % 2], fb[kk % 2]);
      }
    } else {
      for (int kk = 0; kk < kend; ++kk) {   // k tail: the chain stops at K
        load_frag(as, bs, kk, fa[0], fb[0]);
        fmas(fa[0], fb[0]);
      }
    }
    if (next < ktiles) {
      put_a(next % kStages);
      put_b(next % kStages);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int m = (i / 4) * (kTM / 2) + ty * 4 + (i % 4);
    if (m >= nrows) continue;
    float* orow = out + static_cast<size_t>(s_row[m]) * N + n0;
#pragma unroll
    for (int g = 0; g < kColGroups; ++g) {
      const int c = g * kColSpan + tx * 4;
      if (kVec && n0 + c < N) {   // N % 4 == 0: the quad is whole
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(acc[i][g * 4], acc[i][g * 4 + 1], acc[i][g * 4 + 2],
                        acc[i][g * 4 + 3]);
      } else if (!kVec) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + c + j < N) orow[c + j] = acc[i][g * 4 + j];
      }
    }
  }
}

// Zero the rows of M-block blk in the N tile from n0.
__device__ void zero_block(const Params& p, int blk, int n0) {
  for (int idx = threadIdx.x; idx < p.bm * kTN; idx += kThreads) {
    const int r = idx / kTN, c = idx % kTN;
    if (n0 + c < p.N)
      p.out[(static_cast<size_t>(blk) * p.bm + r) * p.N + n0 + c] = 0.0f;
  }
}

// One group of up to p.group M-blocks in N tile n0: slot s0 + i holds
// M-block queue[s0 + i] (K6) or s0 + i (K5).  Ids outside [0, num_blocks)
// are skipped; blocks with an expert outside [0, E) get zero rows.
template <typename TA, typename TB, bool kVec>
__device__ void group_product(const Params& p, const int* queue, int s0,
                              int len, int n0, float* smem, int* s_blk,
                              int* s_exp, int* s_row) {
  __syncthreads();   // the previous group is done with s_blk/s_exp/s_row
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const int c = queue != nullptr ? queue[s0 + i] : s0 + i;
    const bool valid = c >= 0 && c < p.num_blocks;
    s_blk[i] = valid ? c : -1;
    s_exp[i] = valid ? p.block_expert[c] : -1;
  }
  __syncthreads();
  const TA* lhs = static_cast<const TA*>(p.lhs);
  const TB* rhs = static_cast<const TB*>(p.rhs);
  int i = 0;
  while (i < len) {
    const int blk = s_blk[i], e = s_exp[i];
    if (blk < 0) {
      ++i;
      continue;
    }
    if (e < 0 || e >= p.E) {
      zero_block(p, blk, n0);
      ++i;
      continue;
    }
    int j = i + 1;   // a run: consecutive valid entries of expert e
    while (j < len && s_blk[j] >= 0 && s_exp[j] == e) ++j;
    const TB* rhs_e = rhs + static_cast<size_t>(e) * p.K * p.N;
    const int rows = (j - i) * p.bm;
    for (int r0 = 0; r0 < rows; r0 += kTM) {
      const int nrows = rows - r0 < kTM ? rows - r0 : kTM;
      __syncthreads();   // the previous tile is done with s_row and smem
      for (int m = threadIdx.x; m < kTM; m += kThreads) {
        const int r = r0 + m;
        s_row[m] = m < nrows ? s_blk[i + r / p.bm] * p.bm + r % p.bm : 0;
      }
      __syncthreads();
      tile_product<TA, TB, kVec>(lhs, rhs_e, p.out, s_row, nrows, n0, p.K,
                                 p.N, smem);
    }
    i = j;
  }
}

// K5 and K6 in one kernel; a 1-D grid whose id is decoded here (the N
// tile fastest).
template <typename TA, typename TB, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    segmm_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_blk[kTM], s_exp[kTM], s_row[kTM];
  const int n0 = static_cast<int>(blockIdx.x % p.n_tiles) * kTN;
  const int rest = static_cast<int>(blockIdx.x / p.n_tiles);
  const int* queue = nullptr;
  int s0 = rest * p.group, count = p.num_blocks;   // K5
  if (p.chunks != nullptr) {   // K6: queue q, slot group rest / num_physical
    const int q = rest % p.num_physical;
    queue = p.chunks + static_cast<size_t>(q) * p.max_chunks;
    s0 = rest / p.num_physical * p.group;
    count = p.counts[q] < p.max_chunks ? p.counts[q] : p.max_chunks;
    if (s0 >= count) return;
  }
  const int len = count - s0 < p.group ? count - s0 : p.group;
  group_product<TA, TB, kVec>(p, queue, s0, len, n0, smem, s_blk, s_exp,
                              s_row);
}

template <typename TA, typename TB, bool kVec>
int run(const Params& p, long long grid, cudaStream_t stream) {
  if (grid <= 0) return 0;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = &segmm_kernel<TA, TB, kVec>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), kThreads, kSmemBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TB>
int run_vec(int vec, const Params& p, long long grid, cudaStream_t stream) {
  return vec ? run<TA, TB, true>(p, grid, stream)
             : run<TA, TB, false>(p, grid, stream);
}

// dtype codes: 0 = float32, 1 = bfloat16.
int dispatch(int lhs_dtype, int rhs_dtype, int vec, const Params& p,
             long long grid, cudaStream_t stream) {
  if (p.group < 1 || p.group > kTM || p.n_tiles < 1 || p.N < 1)
    return grid == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  if (lhs_dtype == 0 && rhs_dtype == 0)
    return run_vec<float, float>(vec, p, grid, stream);
  if (lhs_dtype == 0 && rhs_dtype == 1)
    return run_vec<float, __nv_bfloat16>(vec, p, grid, stream);
  if (lhs_dtype == 1 && rhs_dtype == 0)
    return run_vec<__nv_bfloat16, float>(vec, p, grid, stream);
  if (lhs_dtype == 1 && rhs_dtype == 1)
    return run_vec<__nv_bfloat16, __nv_bfloat16>(vec, p, grid, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// vec = 1 when K % 4 == 0, N % 4 == 0 and every float32 operand is 16-byte
// aligned: 16-byte copies and float4 output stores.
extern "C" int segmm_blocks(const void* lhs, int lhs_dtype, const void* rhs,
                            int rhs_dtype, const int* block_expert,
                            int num_blocks, int bm, int group, int K, int N,
                            int E, int vec, float* out, cudaStream_t stream) {
  const int n_tiles = (N + kTN - 1) / kTN;
  const Params p{lhs, rhs, block_expert, nullptr, nullptr, 1, 0,
                 num_blocks, bm, group, K, N, E, n_tiles, out};
  const long long groups = group < 1 ? 0 : (num_blocks + group - 1) / group;
  return dispatch(lhs_dtype, rhs_dtype, vec, p, groups * n_tiles, stream);
}

// K6 writes only the popped M-blocks: `out` comes zeroed.  Grid: num_physical
// x ceil(max_chunks / group) x n_tiles CTAs, one slot group each.
extern "C" int segmm_queues(const void* lhs, int lhs_dtype, const void* rhs,
                            int rhs_dtype, const int* block_expert,
                            const int* chunks, const int* counts,
                            int num_physical, int max_chunks, int num_blocks,
                            int bm, int group, int K, int N, int E, int vec,
                            float* out, cudaStream_t stream) {
  const int n_tiles = (N + kTN - 1) / kTN;
  const Params p{lhs, rhs, block_expert, chunks, counts, num_physical,
                 max_chunks, num_blocks, bm, group, K, N, E, n_tiles, out};
  const long long team = group < 1 ? 0 : (max_chunks + group - 1) / group;
  return dispatch(lhs_dtype, rhs_dtype, vec, p,
                  static_cast<long long>(num_physical) * team * n_tiles,
                  stream);
}
