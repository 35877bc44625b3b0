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
//   Hopper the per-slot gather is an ordinary indexed load.
//
// Bound on the H100: bytes.  tiles reads each atom's value, tile id and
// mask once and writes C * L partials; atoms and compact read the chunk's
// values (and mask, or index) once and write C * window.  Three
// instantiations per mode, one per combiner.
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

template <int C>
__global__ void __launch_bounds__(segreduce::kThreads)
chunk_walk_compact_kernel(const float* __restrict__ vals,
                          const int* __restrict__ idx,
                          const int* __restrict__ starts,
                          const int* __restrict__ chunks,
                          const int* __restrict__ counts, int max_chunks,
                          int window, float* __restrict__ out) {
  const int p = blockIdx.x;
  const int count = counts[p];
  for (int i = 0; i < count; ++i) {
    const int c = chunks[static_cast<long long>(p) * max_chunks + i];
    const long long base = starts[c];
    const long long end = starts[c + 1];
    float* row = out + static_cast<long long>(c) * window;
    for (int j = threadIdx.x; j < window; j += blockDim.x) {
      const long long s = base + j;
      row[j] = s < end ? vals[idx[s]] : identity<C>();
    }
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
  DISPATCH_COMBINER(combiner, chunk_walk_compact_kernel, num_physical,
                    stream, vals, idx, starts, chunks, counts, max_chunks,
                    window, out);
  return static_cast<int>(cudaGetLastError());
}
