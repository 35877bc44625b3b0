// Segmented (grouped) matmul kernels: K5 (a grid over groups of M-blocks)
// and K6 (a team of CTAs draining each physical queue of M-blocks), and the
// zero pass of K6's wrapper.
//
// Replaces: src/repro/kernels/segmm/kernel.py::segmented_matmul
// (_segmm_kernel) and ::segmented_matmul_chunked (_segmm_chunk_kernel).
//
// Both compute out[i*bm:(i+1)*bm, :] = lhs[i*bm:(i+1)*bm, :] @
// rhs[block_expert[i]] in float32: lhs [M_pad, K] and rhs [E, K, N] are
// float32 or bfloat16, out is float32 [M_pad, N].  An M-block whose expert
// id lies outside [0, E) gets zero rows.  kernel.py::kernel_for picks the
// route from the operand types, bm, K and N alone; this file holds two of
// the three tile routines, which both kernels share:
//
// * bf16 x bf16 where bm % 128, K % 8 or N % 8 rules out the wgmma route
//   (segmm_wgmma.cu): tile_product_mma(), mma.sync on the tensor cores;
// * float32 x float32, float32 x bf16, bf16 x float32: tile_product(), on
//   the CUDA cores (bf16 operands converted exactly to float32 on the way
//   into shared memory, as the reference does).
//
// Numerics.  The CUDA-core routine computes every output element as one
// fmaf chain over k = 0, 1, ..., K-1 in ascending order from +0.0f.  The
// tensor-core routine computes it as one chain over k-steps of 16 in
// ascending order from +0.0f, each step one mma.sync that adds the step's
// 16 exact products (a product of two bf16 values is exact in float32)
// into the float32 accumulator; the last step's k past K multiplies
// zero-filled operands.  Either way the bits of an output row depend only
// on its lhs row, its expert and the operand types, never on bm, bn, bk,
// the tile, the grouping, the queue, the team or the CTA order: K6 is
// bitwise equal to K5, and grouped_matmul is bitwise equal across its
// schedule policies and execution paths.  No split-K, no TF32.  The two
// routines add in different orders, so a bf16 x bf16 result differs from
// the float32 chain's (and from torch.matmul in float32) by the order of
// the float32 additions only: within 2 K 2^-24 sum_k |a_k b_k|, and not at
// all where every partial sum is exact (integer-valued operands).
//
// Design, CUDA cores (float32 and the mixed pairs): a CTA of 128 threads
// computes 128 x 128 output tiles.  Each thread holds an 8 x 16 register
// tile, so one k step is 2 + 4 float4 shared loads for 128 FMAs, and the
// fragments of step k + 1 are loaded before the FMAs of step k.  k goes
// through a ring of kStages shared-memory slices kBK deep, filled ahead of
// the math: rhs rows by 16-byte cp.async copies (4-byte copies where N % 4
// or the alignment forbids them; zero-fill past K and N), lhs quads by
// 16-byte register loads issued a slice ahead and stored transposed
// (a[k][row], padded) after the slice's math; bfloat16 operands go
// through registers and are converted exactly.  ptxas fits the float32
// instance in 255 registers without spills; two CTAs share an SM (66.5 KB
// of dynamic shared memory each).  Bound on the H100: float32 operations
// (2 * rows * K * N at 67 TFLOP/s) at the MoE widths and at the
// wavefront's level GEMM; what holds it near half of that is the math
// loop itself, shared loads feeding FMAs (PERF.md).
//
// Design, tensor cores (bf16 x bf16): the same CTA of 128 threads and 128
// x 128 tile, as four warps of 64 x 64, each a grid of 4 x 8 m16n8k16
// mma.sync tiles (128 float32 accumulators a thread).  The operands stay
// bf16 in shared memory, in a ring of kMmaStages slices kMmaBK deep: a 128
// x kMmaBK lhs slice, its rows gathered through the tile's row table
// s_row, and a kMmaBK x 128 rhs slice, both filled ahead of the math by
// 16-byte cp.async copies of 8 bf16 (zero-fill past K, N and the tile's
// rows), or element by element where K % 8, N % 8 or a base misaligned to
// 16 bytes forbids them.  Rows are padded by 8 bf16, so the 8 rows an
// ldmatrix reads fall in 8 distinct 16-byte bank groups; lhs fragments
// come from ldmatrix.x4, rhs fragments from ldmatrix.x4.trans of the
// row-major [K, N] slice.  Each thread stores its accumulators straight
// to out (float2 where N % 8 == 0), columns below N only.  Bound on the
// H100: the bytes (bf16 operands read once, the float32 output written
// once, at 3.35 TB/s), close to the operations (989 TFLOP/s bf16);
// mma.sync issued from registers reaches only part of that peak (228
// TFLOP/s at the MoE's w1 shape), which is why the shapes the MoE runs
// (bm 128) go to segmm_wgmma.cu; this routine keeps the level GEMM's bm 8
// and the shapes TMA cannot take.
//
// Work: a CTA takes a group of up to `group` M-blocks (group = 128 / bm
// for bm < 128, else 1) and one N tile; consecutive group entries with the
// same expert form one run, whose rows (gathered through a per-tile row
// table) go through the tile 128 at a time.  K5: CTA id -> (group of
// consecutive M-blocks, N tile), the N tile fastest, so the N tiles of one
// lhs block run side by side and read it from L2.  K6: the physical queues
// keep the schedule's contents and pop order; queue p and N tile n are
// drained by a team of ceil(max_chunks / group) CTAs, CTA t popping slot
// group t and writing each of its M-blocks in place.  The output comes
// uninitialised: segmm_zero_unpopped (K6's wrapper, on this file's routes)
// marks the popped M-blocks and zeroes the rows of the others, instead of
// a fill of the whole output.  Grids are 1-D.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "../../csrc/mma_sync.cuh"

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

// The tensor-core instance (bf16 x bf16): tile_product_mma().
using bf16 = __nv_bfloat16;
constexpr int kMmaBK = 32;             // k depth of a slice: two mma k-steps
constexpr int kMmaStages = 4;          // slices in the ring
constexpr int kALd = kMmaBK + 8;       // lhs slice row, padded (80 bytes)
constexpr int kBLd = kTN + 8;          // rhs slice row, padded (272 bytes)
constexpr int kAElems = kTM * kALd;
constexpr int kMmaStageElems = kAElems + kMmaBK * kBLd;
constexpr int kMmaSmemBytes = kMmaStages * kMmaStageElems * 2;
constexpr int kWarpM = 64;             // a warp's tile: kWarpM x kWarpN
constexpr int kWarpN = 64;
constexpr int kMTiles = kWarpM / 16;   // m16 mma tiles a warp
constexpr int kNTiles = kWarpN / 8;    // n8 mma tiles a warp
constexpr int kAChunks = kTM * kMmaBK / 8 / kThreads;   // 16-byte copies
constexpr int kBChunks = kMmaBK * kTN / 8 / kThreads;   // a thread a slice

static_assert((kTM / kWarpM) * (kTN / kWarpN) * 32 == kThreads,
              "one warp per warp tile");
static_assert(kMmaBK % 16 == 0 && kMmaStages >= 3, "k-steps of 16; ring");
static_assert(kAChunks * kThreads * 8 == kTM * kMmaBK, "lhs copies");
static_assert(kBChunks * kThreads * 8 == kMmaBK * kTN, "rhs copies");
static_assert(kALd * 2 % 16 == 0 && kBLd * 2 % 16 == 0 &&
                  kAElems * 2 % 16 == 0 && kMmaStageElems * 2 % 16 == 0,
              "16-byte aligned rows and slices");

// The tensor-core routine runs the bf16 pair.
template <typename TA, typename TB>
constexpr bool kMma = std::is_same<TA, bf16>::value &&
                      std::is_same<TB, bf16>::value;

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

// tile_product() for bf16 x bf16 on the tensor cores: out[s_row[m], n0 +
// c] = sum_k lhs[s_row[m], k] * rhs_e[k, n0 + c] for m < nrows, n0 + c <
// N, as one ascending chain of mma k-steps of 16 per element.  kVec: K % 8
// == 0, N % 8 == 0 and 16-byte aligned bases (16-byte copies, float2
// stores).  Every thread of the CTA calls it (it synchronises).
template <bool kVec>
__device__ void tile_product_mma(const bf16* __restrict__ lhs,
                                 const bf16* __restrict__ rhs_e,
                                 float* __restrict__ out, const int* s_row,
                                 int nrows, int n0, int K, int N,
                                 bf16* smem) {
  namespace tc = mma_sync;
  constexpr int kACols = kMmaBK / 8;       // 8-element chunks a lhs row
  constexpr int kARowStep = kThreads / kACols;
  constexpr int kBCols = kTN / 8;          // 8-element chunks a rhs row
  constexpr int kBRowStep = kThreads / kBCols;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bf16 zero = __float2bfloat16(0.0f);

  // lhs chunks: k columns ac.. of tile rows ar + j * kARowStep, gathered
  // through s_row (row pointers set once per tile); rows past nrows and k
  // past K are zero-filled.
  const int ac = (tid % kACols) * 8, ar = tid / kACols;
  const bf16* arow[kAChunks];
  int arows_left[kAChunks];
#pragma unroll
  for (int j = 0; j < kAChunks; ++j) {
    const int m = ar + j * kARowStep;
    arow[j] = lhs + static_cast<size_t>(m < nrows ? s_row[m] : 0) * K + ac;
    arows_left[j] = m < nrows ? K - ac : 0;
  }
  // rhs chunks: columns n0 + bc.. of slice rows br + j * kBRowStep
  const int bc = (tid % kBCols) * 8, br = tid / kBCols;
  const int b_left = N - n0 - bc;
  const bf16* brow = rhs_e + static_cast<size_t>(br) * N + n0 + bc;
  auto load_slice = [&](int k0, int stage) {
    bf16* as = smem + stage * kMmaStageElems;
    bf16* bs = as + kAElems;
#pragma unroll
    for (int j = 0; j < kAChunks; ++j) {
      bf16* dst = as + (ar + j * kARowStep) * kALd + ac;
      const int left = arows_left[j] - k0;   // <= 0: none is real
      if constexpr (kVec) {
        tc::cp_async16(dst, arow[j] + k0, left > 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = e < left ? arow[j][k0 + e] : zero;
      }
    }
#pragma unroll
    for (int j = 0; j < kBChunks; ++j) {
      const int k = br + j * kBRowStep;
      bf16* dst = bs + k * kBLd + bc;
      const bf16* src = brow + static_cast<size_t>(k0 + j * kBRowStep) * N;
      const int left = k0 + k < K ? b_left : 0;
      if constexpr (kVec) {
        tc::cp_async16(dst, src, left > 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = e < left ? src[e] : zero;
      }
    }
  };

  // Warp (wm, wn) owns rows wm * kWarpM.. and columns wn * kWarpN.. of the
  // tile: kMTiles x kNTiles mma tiles.
  const int wm = warp / (kTN / kWarpN), wn = warp % (kTN / kWarpN);
  float acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;
  // a_off: the lhs rows and k half this lane's ldmatrix address names;
  // b_off: the rhs k row and column half
  const int a_off = (wm * kWarpM + (lane & 15)) * kALd + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kBLd +
                    wn * kWarpN + (lane >> 4) * 8;
  auto k_step = [&](const bf16* as, const bf16* bs, int kk) {
    uint32_t a[kMTiles][4], b[kNTiles][2];
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
      tc::ldmatrix_x4(a[i], as + a_off + i * 16 * kALd + kk);
#pragma unroll
    for (int j = 0; j < kNTiles / 2; ++j) {
      uint32_t r[4];
      tc::ldmatrix_x4_trans(r, bs + b_off + kk * kBLd + j * 16);
      b[2 * j][0] = r[0];
      b[2 * j][1] = r[1];
      b[2 * j + 1][0] = r[2];
      b[2 * j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
        tc::mma(acc[i][j], a[i], b[j][0], b[j][1]);
  };

  const int ktiles = (K + kMmaBK - 1) / kMmaBK;
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < ktiles) load_slice(s * kMmaBK, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    tc::cp_async_wait<kMmaStages - 2>();
    __syncthreads();   // slice kt landed; slice kt - 1 is read by all
    const int next = kt + kMmaStages - 1;
    if (next < ktiles) load_slice(next * kMmaBK, next % kMmaStages);
    tc::cp_async_commit();
    const bf16* as = smem + (kt % kMmaStages) * kMmaStageElems;
    const bf16* bs = as + kAElems;
    // the chain has ceil(K / 16) steps: a step wholly past K is not run
    const int ksteps = min(K - kt * kMmaBK + 15, kMmaBK) / 16;
#pragma unroll
    for (int ks = 0; ks < kMmaBK / 16; ++ks)
      if (ks < ksteps) k_step(as, bs, ks * 16);
  }
  tc::cp_async_wait<0>();

  // accumulator r of tile (i, j): row i * 16 + lane / 4 + (r / 2) * 8,
  // column j * 8 + (lane % 4) * 2 + r % 2 of the warp's tile
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm * kWarpM + i * 16 + h * 8 + lane / 4;
      if (m >= nrows) continue;
      float* orow = out + static_cast<size_t>(s_row[m]) * N + n0;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const int c = wn * kWarpN + j * 8 + (lane % 4) * 2;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (kVec) {   // N % 8 == 0: both columns real, 8-byte aligned
          if (n0 + c < N)
            *reinterpret_cast<float2*>(orow + c) = make_float2(v0, v1);
        } else {
          if (n0 + c < N) orow[c] = v0;
          if (n0 + c + 1 < N) orow[c + 1] = v1;
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
      if constexpr (kMma<TA, TB>)
        tile_product_mma<kVec>(lhs, rhs_e, p.out, s_row, nrows, n0, p.K,
                               p.N, reinterpret_cast<bf16*>(smem));
      else
        tile_product<TA, TB, kVec>(lhs, rhs_e, p.out, s_row, nrows, n0,
                                   p.K, p.N, smem);
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
  constexpr int smem = kMma<TA, TB> ? kMmaSmemBytes : kSmemBytes;
  auto* kernel = &segmm_kernel<TA, TB, kVec>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(p);
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

// K6's wrapper on this file's routes, before the launch: popped[b] = 1
// for every M-block b that some queue pops (slot s < min(counts[q],
// max_chunks), id in [0, num_blocks)); popped comes zeroed.
__global__ void mark_popped(const int* __restrict__ chunks,
                            const int* __restrict__ counts, int num_physical,
                            int max_chunks, int num_blocks,
                            unsigned char* __restrict__ popped) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(num_physical) * max_chunks) return;
  const int q = static_cast<int>(i / max_chunks);
  const int s = static_cast<int>(i % max_chunks);
  if (s >= min(counts[q], max_chunks)) return;
  const int b = chunks[i];
  if (b >= 0 && b < num_blocks) popped[b] = 1;
}

// One CTA per M-block: zero its bm x N rows (contiguous in out) unless it
// is popped.  kVec: bm * N % 4 == 0 (float4 stores).
template <bool kVec>
__global__ void zero_unpopped(const unsigned char* __restrict__ popped,
                              long long block_elems,
                              float* __restrict__ out) {
  if (popped[blockIdx.x]) return;
  float* rows = out + static_cast<size_t>(blockIdx.x) * block_elems;
  if constexpr (kVec) {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (long long i = threadIdx.x; i < block_elems / 4; i += blockDim.x)
      reinterpret_cast<float4*>(rows)[i] = zero;
  } else {
    for (long long i = threadIdx.x; i < block_elems; i += blockDim.x)
      rows[i] = 0.0f;
  }
}

}  // namespace

// The rows of the M-blocks that no queue pops, zeroed (K6 writes the
// others): a memset of `popped` (num_blocks bytes of scratch), the marks,
// one CTA a block.  Grids are 1-D; out is 16-byte aligned.  (The wgmma
// route zeroes them inside its kernel: segmm_wgmma.cu.)
extern "C" int segmm_zero_unpopped(const int* chunks, const int* counts,
                                   int num_physical, int max_chunks,
                                   int num_blocks, int bm, int N,
                                   unsigned char* popped, float* out,
                                   cudaStream_t stream) {
  if (num_blocks <= 0) return 0;
  cudaError_t err = cudaMemsetAsync(popped, 0, num_blocks, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = static_cast<long long>(num_physical) * max_chunks;
  if (slots > 0) {
    const long long grid = (slots + 255) / 256;
    if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    mark_popped<<<static_cast<unsigned>(grid), 256, 0, stream>>>(
        chunks, counts, num_physical, max_chunks, num_blocks, popped);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long block_elems = static_cast<long long>(bm) * N;
  if (block_elems % 4 == 0)
    zero_unpopped<true><<<num_blocks, 256, 0, stream>>>(popped, block_elems,
                                                        out);
  else
    zero_unpopped<false><<<num_blocks, 256, 0, stream>>>(popped,
                                                         block_elems, out);
  return static_cast<int>(cudaGetLastError());
}

// vec = 1 when the operands allow 16-byte copies: for the CUDA-core
// instances K % 4 == 0, N % 4 == 0 and every float32 operand 16-byte
// aligned (float4 output stores); for bf16 x bf16 K % 8 == 0, N % 8 == 0
// and both operands 16-byte aligned (float2 output stores).
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

// K6 writes only the popped M-blocks (segmm_zero_unpopped zeroes the
// others' rows).  Grid: num_physical
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
