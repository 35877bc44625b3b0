// Chunk-walk kernels (K2 tiles, K3 atoms, K4 compact): the native
// executor behind every schedule.
//
// Replaces: src/repro/kernels/spmv_merge/kernel.py::chunk_walk_reduce
// (_chunk_walk_kernel) with emit="tiles", "atoms" and "compact".
//
// Common walk: one CTA per physical block p pops its queue,
// chunks[p * max_chunks + i] for i < counts[p] (the inverted block map of
// a dynamic schedule, or the identity queue of a static one), and writes
// the whole output row of every chunk it owns.
//
// * tiles: chunk c's atoms [atom_starts[c], min(atom_starts[c+1],
//   atom_starts[c] + window)) are tile-sorted, so each of the L local bins
//   (tile tids[a] - tile_starts[c]) reduces one contiguous run: the
//   sorted-window reduction of segreduce.cuh, sum/min/max, masked atoms
//   giving the identity, untouched bins the identity.  Fixed order, no
//   atomics.
// * atoms: out[c, j] = vals[atom_starts[c] + j] where that atom is inside
//   the chunk and unmasked, else the identity.
// * compact: the chunk bounds run over compacted slots; out[c, j] =
//   vals[idx[starts[c] + j]] inside the chunk, else the identity.  On
//   Hopper the per-slot gather is an ordinary indexed load.  This mode
//   does not walk queues in order: one CTA per (queue slot, 2,048-slot
//   slice of the window) returns at once if the queue does not reach its
//   slot, so all of a queue's chunks are gathered in parallel.  Each
//   thread takes 4 consecutive slots: one 16-byte index load where the
//   window and the chunk start are multiples of 4, all four gathers
//   issued before the first is stored, one 16-byte store; scalar accesses
//   elsewhere.  A copy, so bitwise equal to the plain version.
//
// Bound on the H100: bytes.  tiles reads each atom's value, tile id and
// mask once and writes C * L partials; atoms and compact read the chunk's
// values (and mask, or index) once and write C * window.  Three
// instantiations per mode, one per combiner.
#include <cstdint>

#include "segreduce.cuh"

namespace {

using segreduce::identity;

template <int C>
__global__ void __launch_bounds__(segreduce::kThreads)
chunk_walk_tiles_kernel(const float* __restrict__ vals,
                        const int* __restrict__ tids,
                        const int* __restrict__ mask,
                        const int* __restrict__ atom_starts,
                        const int* __restrict__ tile_starts,
                        const int* __restrict__ chunks,
                        const int* __restrict__ counts, int max_chunks,
                        int window, int L, float* __restrict__ out) {
  __shared__ segreduce::Pieces pieces;
  const int p = blockIdx.x;
  const int count = counts[p];
  for (int i = 0; i < count; ++i) {
    const int c = chunks[static_cast<long long>(p) * max_chunks + i];
    const long long base = atom_starts[c];
    long long end = atom_starts[c + 1];
    if (end > base + window) end = base + window;
    float* row = out + static_cast<long long>(c) * L;
    for (int l = threadIdx.x; l < L; l += blockDim.x) row[l] = identity<C>();
    __syncthreads();
    segreduce::reduce_sorted_window<C>(vals, tids, tile_starts[c], mask,
                                       base, end, row, L, pieces);
  }
}

template <int C>
__global__ void __launch_bounds__(segreduce::kThreads)
chunk_walk_atoms_kernel(const float* __restrict__ vals,
                        const int* __restrict__ mask,
                        const int* __restrict__ atom_starts,
                        const int* __restrict__ chunks,
                        const int* __restrict__ counts, int max_chunks,
                        int window, float* __restrict__ out) {
  const int p = blockIdx.x;
  const int count = counts[p];
  for (int i = 0; i < count; ++i) {
    const int c = chunks[static_cast<long long>(p) * max_chunks + i];
    const long long base = atom_starts[c];
    const long long end = atom_starts[c + 1];
    float* row = out + static_cast<long long>(c) * window;
    for (int j = threadIdx.x; j < window; j += blockDim.x) {
      const long long a = base + j;
      const bool ok = a < end && (mask == nullptr || mask[a] != 0);
      row[j] = ok ? vals[a] : identity<C>();
    }
  }
}

// One CTA per (queue slot, slice of kSlice window slots): the CTAs of a
// queue's chunks run side by side.  A thread takes kVec consecutive slots
// (4 timed faster than 2 or 8 at delta-stepping's shape on the H100).
constexpr int kVec = 4;
constexpr int kSlice = segreduce::kThreads * kVec;

template <int C>
__global__ void __launch_bounds__(segreduce::kThreads)
chunk_walk_compact_kernel(const float* __restrict__ vals,
                          const int* __restrict__ idx,
                          const int* __restrict__ starts,
                          const int* __restrict__ chunks,
                          const int* __restrict__ counts, int max_chunks,
                          int window, int slices, float* __restrict__ out) {
  const long long slot = blockIdx.x / slices;    // p * max_chunks + i
  const int p = static_cast<int>(slot / max_chunks);
  const int i = static_cast<int>(slot % max_chunks);
  if (i >= counts[p]) return;
  const int j0 = (blockIdx.x % slices) * kSlice + threadIdx.x * kVec;
  if (j0 >= window) return;
  const int c = chunks[slot];
  const long long base = starts[c];
  const long long end = starts[c + 1];
  float* row = out + static_cast<long long>(c) * window;
  const long long s0 = base + j0;
  const bool vec = j0 + kVec <= window && window % 4 == 0 && base % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(idx) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
    int a[kVec];
#pragma unroll
    for (int q = 0; q < kVec; q += 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(idx + s0 + q));
      a[q] = v.x;
      a[q + 1] = v.y;
      a[q + 2] = v.z;
      a[q + 3] = v.w;
    }
    float f[kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      f[q] = s0 + q < end ? __ldg(vals + a[q]) : identity<C>();
    }
#pragma unroll
    for (int q = 0; q < kVec; q += 4) {
      reinterpret_cast<float4*>(row + j0 + q)[0] =
          make_float4(f[q], f[q + 1], f[q + 2], f[q + 3]);
    }
    return;
  }
  for (int q = 0; q < kVec && j0 + q < window; ++q) {
    const long long s = s0 + q;
    row[j0 + q] = s < end ? vals[idx[s]] : identity<C>();
  }
}

#define DISPATCH_COMBINER(combiner, KERNEL, grid, stream, ...)               \
  switch (combiner) {                                                        \
    case segreduce::kSum:                                                    \
      KERNEL<segreduce::kSum>                                                \
          <<<grid, segreduce::kThreads, 0, stream>>>(__VA_ARGS__);           \
      break;                                                                 \
    case segreduce::kMin:                                                    \
      KERNEL<segreduce::kMin>                                                \
          <<<grid, segreduce::kThreads, 0, stream>>>(__VA_ARGS__);           \
      break;                                                                 \
    case segreduce::kMax:                                                    \
      KERNEL<segreduce::kMax>                                                \
          <<<grid, segreduce::kThreads, 0, stream>>>(__VA_ARGS__);           \
      break;                                                                 \
    default:                                                                 \
      return static_cast<int>(cudaErrorInvalidValue);                        \
  }

}  // namespace

extern "C" int chunk_walk_tiles(const float* vals, const int* tids,
                                const int* mask, const int* atom_starts,
                                const int* tile_starts, const int* chunks,
                                const int* counts, int num_physical,
                                int max_chunks, int window, int local_tiles,
                                int combiner, float* out,
                                cudaStream_t stream) {
  DISPATCH_COMBINER(combiner, chunk_walk_tiles_kernel, num_physical, stream,
                    vals, tids, mask, atom_starts, tile_starts, chunks,
                    counts, max_chunks, window, local_tiles, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chunk_walk_atoms(const float* vals, const int* mask,
                                const int* atom_starts, const int* chunks,
                                const int* counts, int num_physical,
                                int max_chunks, int window, int combiner,
                                float* out, cudaStream_t stream) {
  DISPATCH_COMBINER(combiner, chunk_walk_atoms_kernel, num_physical, stream,
                    vals, mask, atom_starts, chunks, counts, max_chunks,
                    window, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chunk_walk_compact(const float* vals, const int* idx,
                                  const int* starts, const int* chunks,
                                  const int* counts, int num_physical,
                                  int max_chunks, int window, int combiner,
                                  float* out, cudaStream_t stream) {
  const int slices = (window + kSlice - 1) / kSlice;
  const long long grid =
      static_cast<long long>(num_physical) * max_chunks * slices;
  if (grid <= 0 || grid > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DISPATCH_COMBINER(combiner, chunk_walk_compact_kernel,
                    static_cast<unsigned>(grid), stream, vals, idx, starts,
                    chunks, counts, max_chunks, window, slices, out);
  return static_cast<int>(cudaGetLastError());
}
