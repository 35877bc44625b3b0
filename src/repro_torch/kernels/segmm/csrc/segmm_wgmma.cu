// K5 and K6 on bf16 x bf16 operands on Hopper's own tensor-core path:
// wgmma fed by TMA, one persistent CTA per SM.
//
// Replaces: src/repro/kernels/segmm/kernel.py::segmented_matmul
// (_segmm_kernel) and ::segmented_matmul_chunked (_segmm_chunk_kernel), on
// the operands kernel.py::kernel_for sends here: bf16 x bf16, bm a multiple
// of kTM (128), K % 8 == 0 and N % 8 == 0 (TMA's 16-byte strides), both
// bases 16-byte aligned.  segmm.cu keeps every other case.
//
// Both compute out[i*bm:(i+1)*bm, :] = lhs[i*bm:(i+1)*bm, :] @
// rhs[block_expert[i]] in float32 (lhs [M_pad, K], rhs [E, K, N], out
// float32 [M_pad, N]); an M-block whose expert lies outside [0, E) gets
// zero rows.
//
// Numerics.  Every output element is one chain of wgmma k-steps of 16 in
// ascending order from +0.0f, each step adding its 16 exact bf16 products
// into the float32 accumulator; the last step's k past K multiplies zeros
// (TMA's out-of-bounds fill).  No split-K.  The bits of an output row
// depend only on its lhs row and its expert, never on the item order, the
// CTA, the queue or the grid: K6 is bitwise equal to K5, and grouped_matmul
// bitwise equal across its policies and paths.  Against the plain version
// (torch.matmul in float32) only the order of the float32 additions
// differs: within 2 K 2^-24 sum|ab|, bitwise on integer-valued operands.
//
// Design.  A work item is a 128 x 256 output tile: 128 rows of one M-block
// (one expert) and 256 columns.  A CTA of three warpgroups walks the items
// i = blockIdx.x, blockIdx.x + gridDim.x, ... (gridDim.x = min(items, SMs),
// chosen by the wrapper):
// * warpgroup 0, the producer, gives up its registers (setmaxnreg 40) and
//   one thread of it decodes the items and issues, for each 64-deep k
//   slice of each, a TMA load of the lhs slice [128 rows, 64 k] (2-D map
//   over lhs [M_pad, K]) and of up to four rhs boxes [64 k, 64 n] (3-D map
//   over rhs [E, K, N], so a K-tail box reads TMA's zeros, not the next
//   expert's rows) into a ring of kStages stages, each with a full and an
//   empty mbarrier.  It runs ahead across items, so the next tile's loads
//   overlap this one's epilogue;
// * warpgroups 1 and 2, the consumers (setmaxnreg 232), each own 64 rows
//   of the tile: per slice four m64n256k16 wgmmas (A K-major, B MN-major:
//   the transposed-B form, no transpose of the weights in memory), one
//   group kept in flight while the previous slice's stage is released.
//   The epilogue stores the float32 accumulators straight from registers,
//   float2 per thread, columns below N only.
// * K6's output comes uninitialised: warps 1-3 of the producer warpgroup
//   zero the rows of the M-blocks no queue pops (zero_unpopped), beside the
//   items, so K6 launches nothing more than K5.
// * the consumers read the next item's ids during the current one (Ahead),
//   so a queue's dependent loads (count, slot id, expert) never stall the
//   tensor cores at an item's start.
// Items skip slices past N (no load for a box wholly right of N) and
// experts outside [0, E) (no load at all: the consumers write zeros).
// Shared memory: 4 stages x (16 KB lhs + 32 KB rhs) = 192 KB, one CTA an
// SM.
//
// Bound on the H100 at the MoE's w1 shape (OLMoE-1B-7B, 4,096 tokens
// top-8, [64, 2,048, 1,024]): bytes (bf16 operands read once, the float32
// output written once: 0.160 ms at 3.35 TB/s), close to the operations
// (0.139 ms at 989 TFLOP/s bf16).  The rhs tile of an item is read again
// by each M-block of its expert (from L2 when they run side by side: the
// N tile is the fastest index of the walk, then the M-block).
//
// Work decode (mirrored in kernel.py, wgmma_item, for the CPU tests):
// item -> N tile = item % n_tiles, then sub-tile of the M-block (bm /
// kTM of them), then K5: M-block; K6: queue q = rest % P and slot s = rest
// / P, an item only when s < min(counts[q], max_chunks) and the slot's id
// lies in [0, num_blocks).  So each queue's slots are walked in pop order.
#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>

#include "../../csrc/tma.cuh"
#include "../../csrc/wgmma.cuh"

namespace {

constexpr int kTM = 128;                 // tile rows (two warpgroups of 64)
constexpr int kTN = 256;                 // tile columns (one n256 wgmma)
constexpr int kBK = 64;                  // k depth of a stage: 128 bytes
constexpr int kBoxN = 64;                // rhs box columns: 128 bytes
constexpr int kStages = 4;
constexpr int kConsumers = kTM / 64;     // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kABytes = kTM * kBK * 2;               // 16 KB
constexpr int kBoxBytes = kBK * kBoxN * 2;           // 8 KB
constexpr int kBBytes = kTN / kBoxN * kBoxBytes;     // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;   // + alignment
constexpr int kAccRegs = kTN / 2;        // f32 accumulators a thread

static_assert(kABytes % 1024 == 0 && kBoxBytes % 1024 == 0,
              "swizzle atoms stay 1024-byte aligned");
static_assert(kTN % kBoxN == 0 && kBK % 16 == 0, "boxes and k-steps");

struct Params {
  const int* block_expert;
  const int* chunks;   // nullptr: K5
  const int* counts;
  int num_physical, max_chunks, num_blocks, bm, K, N, E;
  int n_tiles, sub_tiles;   // N tiles; kTM-row tiles an M-block
  long long items;
  float* out;
};

constexpr int kZeroThreads = 96;         // K6's zero pass: warps 1-3
constexpr int kZeroBarrier = 1;          // its named barrier
constexpr int kMarkSpan = 8192;          // its flags in shared memory

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

struct Item {
  int row0, n0, expert;   // expert < 0: zero rows; row0 < 0: no item
};

// An item's ids, read in two steps ahead of their use, so that the
// consumers do not wait on the queue's dependent loads at each item: step
// 1 (ahead) reads the slot's id and the queue's count (K6) or the expert
// (K5), step 2 (ahead_expert, K6) the popped id's expert, and take() makes
// the Item.  An item past the walk is no item.
struct Ahead {
  int blk, sub, n0, slot, count, expert;
};

__device__ __forceinline__ Ahead ahead(const Params& p, long long item) {
  Ahead a{-1, 0, 0, 0, 0, -1};
  if (item >= p.items) return a;
  a.n0 = static_cast<int>(item % p.n_tiles) * kTN;
  long long rest = item / p.n_tiles;
  a.sub = static_cast<int>(rest % p.sub_tiles);
  rest /= p.sub_tiles;
  if (p.chunks != nullptr) {   // K6: queue q, slot s (s < max_chunks)
    const int q = static_cast<int>(rest % p.num_physical);
    a.slot = static_cast<int>(rest / p.num_physical);
    a.count = __ldg(p.counts + q);
    a.blk = __ldg(p.chunks + static_cast<size_t>(q) * p.max_chunks + a.slot);
  } else {                     // K5: M-block rest
    a.blk = static_cast<int>(rest);
    a.count = 1;
    a.expert = __ldg(p.block_expert + a.blk);
  }
  return a;
}

// K6's slot is below max_chunks by construction, so slot < count is slot
// < min(count, max_chunks); K5's one slot is always popped.
__device__ __forceinline__ bool is_popped(const Params& p, const Ahead& a) {
  return a.slot < a.count && a.blk >= 0 && a.blk < p.num_blocks;
}

__device__ __forceinline__ void ahead_expert(const Params& p, Ahead& a) {
  if (p.chunks != nullptr && is_popped(p, a))
    a.expert = __ldg(p.block_expert + a.blk);
}

__device__ __forceinline__ Item take(const Params& p, const Ahead& a) {
  if (!is_popped(p, a)) return Item{-1, a.n0, -1};
  return Item{a.blk * p.bm + a.sub * kTM, a.n0,
              a.expert >= 0 && a.expert < p.E ? a.expert : -1};
}

__device__ __forceinline__ Item decode(const Params& p, long long item) {
  Ahead a = ahead(p, item);
  ahead_expert(p, a);
  return take(p, a);
}

// K6: zero the rows of the M-blocks no queue pops, on the producer
// warpgroup's warps 1-3 (kZeroThreads threads, otherwise idle) while the
// other warps run the items.  CTA c owns the blocks [c R, (c + 1) R), R =
// ceil(num_blocks / gridDim.x); it marks, kMarkSpan at a time, which of
// them some queue pops (slot s < min(counts[q], max_chunks)), reading
// every slot, then zeroes the bm x N rows (contiguous in out) of the
// others.  Disjoint from the rows the items write.
__device__ void zero_unpopped(const Params& p, unsigned char* popped) {
  const int t = threadIdx.x - 32;
  const int per = (p.num_blocks + gridDim.x - 1) / gridDim.x;
  const int first = blockIdx.x * per;
  const int last = min(p.num_blocks, first + per);
  const int quads = p.bm * (p.N / 4);   // a block's rows, in float4s
  for (int base = first; base < last; base += kMarkSpan) {
    const int span = min(kMarkSpan, last - base);
    for (int b = t; b < span; b += kZeroThreads) popped[b] = 0;
    named_sync(kZeroBarrier, kZeroThreads);
    for (int q = 0; q < p.num_physical; ++q) {
      const int count = min(__ldg(p.counts + q), p.max_chunks);
      const int* queue = p.chunks + static_cast<size_t>(q) * p.max_chunks;
      for (int s = t; s < count; s += kZeroThreads) {
        const int b = __ldg(queue + s) - base;
        if (b >= 0 && b < span) popped[b] = 1;
      }
    }
    named_sync(kZeroBarrier, kZeroThreads);
    for (int b = 0; b < span; ++b) {
      if (popped[b]) continue;
      float4* rows = reinterpret_cast<float4*>(p.out) +
                     static_cast<size_t>(base + b) * quads;
      for (int i = t; i < quads; i += kZeroThreads)
        rows[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    named_sync(kZeroBarrier, kZeroThreads);   // the flags are reused
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    segmm_wgmma_kernel(const __grid_constant__ CUtensorMap lhs_map,
                       const __grid_constant__ CUtensorMap rhs_map,
                       const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ unsigned char popped[kMarkSpan];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const int warpgroup = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tma::mbar_init(&full[s], 1);
      tma::mbar_init(&empty[s], kConsumers * 128);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();
  const int kslices = (p.K + kBK - 1) / kBK;

  if (warpgroup == 0) {   // producer
    wgmma::reg_dealloc<40>();
    if (threadIdx.x >= 32) {
      if (p.chunks != nullptr) zero_unpopped(p, popped);
      return;
    }
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (long long i = blockIdx.x; i < p.items; i += gridDim.x) {
      const Item it = decode(p, i);
      if (it.row0 < 0 || it.expert < 0) continue;
      const int boxes = min(kTN / kBoxN, (p.N - it.n0 + kBoxN - 1) / kBoxN);
      const uint32_t bytes = kABytes + boxes * kBoxBytes;
      for (int ks = 0; ks < kslices; ++ks) {
        tma::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* a = smem + stage * kStageBytes;
        tma::mbar_arrive_expect_tx(&full[stage], bytes);
        tma::load_2d(a, &lhs_map, &full[stage], ks * kBK, it.row0);
        for (int b = 0; b < boxes; ++b)
          tma::load_3d(a + kABytes + b * kBoxBytes, &rhs_map, &full[stage],
                       it.n0 + b * kBoxN, ks * kBK, it.expert);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: the next item's ids are read during this one (Ahead)
  wgmma::reg_alloc<232>();
  const int tid = threadIdx.x - 128;           // 0 .. 255
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  int stage = 0;
  uint32_t phase = 0;
  float acc[kAccRegs];
  Item it = decode(p, blockIdx.x);
  for (long long i = blockIdx.x; i < p.items; i += gridDim.x) {
    Ahead next = ahead(p, i + gridDim.x);
    bool next_expert = false;
    if (it.row0 >= 0) {
      const int row = it.row0 + wg * 64 + warp * 16 + lane / 4;
      float* out0 = p.out + static_cast<size_t>(row) * p.N + it.n0;
      float* out1 = out0 + static_cast<size_t>(8) * p.N;
#pragma unroll
      for (int r = 0; r < kAccRegs; ++r) acc[r] = 0.0f;
      if (it.expert >= 0) {
        int held = -1;   // the stage whose wgmmas may still be reading it
        for (int ks = 0; ks < kslices; ++ks) {
          tma::mbar_wait(&full[stage], phase);
          const unsigned char* a = smem + stage * kStageBytes;
          const uint64_t da = wgmma::desc_sw128(a + wg * 64 * 128, 0, 1024);
          const uint64_t db = wgmma::desc_sw128(a + kABytes, kBoxBytes, 1024);
          // the chain has ceil(K / 16) steps: one wholly past K is not run
          const int steps = min(p.K - ks * kBK + 15, kBK) / 16;
          wgmma::fence_operands(acc);
          wgmma::fence();
          if (steps == kBK / 16) {   // +32 bytes of lhs row, +16 rhs rows
#pragma unroll
            for (int k = 0; k < kBK / 16; ++k)
              wgmma::mma_m64n256k16_bf16_tn(acc, da + 2 * k, db + 128 * k);
          } else {
            for (int k = 0; k < steps; ++k)
              wgmma::mma_m64n256k16_bf16_tn(acc, da + 2 * k, db + 128 * k);
          }
          wgmma::commit();
          if (ks == 0) {   // step 2 while the first slice's wgmmas run
            ahead_expert(p, next);
            next_expert = true;
          }
          wgmma::wait<1>();
          wgmma::fence_operands(acc);
          if (held >= 0) tma::mbar_arrive(&empty[held]);
          held = stage;
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma::wait<0>();
        wgmma::fence_operands(acc);
        tma::mbar_arrive(&empty[held]);
      }
#pragma unroll
      for (int j = 0; j < kAccRegs / 4; ++j) {
        const int c = j * 8 + (lane % 4) * 2;
        if (it.n0 + c < p.N) {   // N % 8 == 0: both columns real
          *reinterpret_cast<float2*>(out0 + c) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(out1 + c) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
    if (!next_expert) ahead_expert(p, next);
    it = take(p, next);
  }
}

int launch(const void* lhs, const void* rhs, const Params& p, int m_pad,
           int grid, cudaStream_t stream) {
  if (p.items <= 0 || grid <= 0) return 0;
  if (p.K < 8 || p.K % 8 || p.N < 8 || p.N % 8 || p.bm % kTM ||
      m_pad % p.bm)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap lhs_map, rhs_map;
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(p.K),
                                static_cast<cuuint64_t>(m_pad)};
  const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(p.K) * 2};
  const cuuint32_t a_box[2] = {kBK, kTM};
  int err = tma::encode_tiled(&lhs_map, lhs, 2, a_dims, a_strides, a_box);
  if (err) return err;
  const cuuint64_t b_dims[3] = {static_cast<cuuint64_t>(p.N),
                                static_cast<cuuint64_t>(p.K),
                                static_cast<cuuint64_t>(p.E)};
  const cuuint64_t b_strides[2] = {
      static_cast<cuuint64_t>(p.N) * 2,
      static_cast<cuuint64_t>(p.K) * p.N * 2};
  const cuuint32_t b_box[3] = {kBoxN, kBK, 1};
  err = tma::encode_tiled(&rhs_map, rhs, 3, b_dims, b_strides, b_box);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      segmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  segmm_wgmma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(lhs_map,
                                                             rhs_map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5: items (M-block sub-tile, N tile), N tile fastest; `grid` CTAs walk
// them (the wrapper passes min(items, SMs)).
extern "C" int segmm_wgmma_blocks(const void* lhs, const void* rhs,
                                  const int* block_expert, int num_blocks,
                                  int bm, int K, int N, int E, int grid,
                                  float* out, cudaStream_t stream) {
  if (bm < kTM || num_blocks < 0) return static_cast<int>(
      cudaErrorInvalidValue);
  const int n_tiles = (N + kTN - 1) / kTN, sub = bm / kTM;
  const Params p{block_expert, nullptr, nullptr, 1, 0, num_blocks, bm, K, N,
                 E, n_tiles, sub,
                 static_cast<long long>(num_blocks) * sub * n_tiles, out};
  const long long m_pad = static_cast<long long>(num_blocks) * bm;
  if (m_pad > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return launch(lhs, rhs, p, static_cast<int>(m_pad), grid, stream);
}

// K6: items (M-block sub-tile, N tile) of every slot of every queue,
// popped or not, N tile fastest, then queue, then slot; unpopped slots and
// ids outside [0, num_blocks) are no item.  The kernel also zeroes the
// rows of the M-blocks that no queue pops (out comes uninitialised).
extern "C" int segmm_wgmma_queues(const void* lhs, const void* rhs,
                                  const int* block_expert,
                                  const int* chunks, const int* counts,
                                  int num_physical, int max_chunks,
                                  int num_blocks, int bm, int K, int N,
                                  int E, int grid, float* out,
                                  cudaStream_t stream) {
  if (bm < kTM || num_blocks < 0 || num_physical < 0 || max_chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (N + kTN - 1) / kTN, sub = bm / kTM;
  const Params p{block_expert, chunks, counts, num_physical, max_chunks,
                 num_blocks, bm, K, N, E, n_tiles, sub,
                 static_cast<long long>(num_physical) * max_chunks * sub *
                     n_tiles,
                 out};
  const long long m_pad = static_cast<long long>(num_blocks) * bm;
  if (m_pad > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return launch(lhs, rhs, p, static_cast<int>(m_pad), grid, stream);
}
