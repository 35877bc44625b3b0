// Merge-path SpMV block kernel (K1).
//
// Replaces: src/repro/kernels/spmv_merge/kernel.py::spmv_merge_stream
// (_spmv_block_kernel), the Pallas TPU kernel.
//
// Computes: block b of the merged (rows + nnz) work-item stream is items
// [b * block_items, (b + 1) * block_items); its per-row partial sums go to
// out[b, 0 : r_loc], bin r - row_base[b] for stream row r, 0 in bins no
// item falls in.  Stream rows are non-decreasing, so each row's items are
// one contiguous run.  The stream build and the cross-block fixup stay in
// PyTorch, as they were XLA in the reference.
//
// Bound on the H100: bytes.  It reads every stream item once (4-byte value
// + 4-byte row) and writes G * r_loc partials; no arithmetic to speak of.
//
// Design: one CTA per block, the sorted-window reduction of segreduce.cuh
// (coalesced reads, warp-segmented scans, no atomics, fixed order).
#include "segreduce.cuh"

namespace {

__global__ void __launch_bounds__(segreduce::kThreads)
merge_stream_kernel(const float* __restrict__ vals,
                    const int* __restrict__ rows,
                    const int* __restrict__ row_base, int block_items,
                    int r_loc, float* __restrict__ out) {
  __shared__ segreduce::Pieces pieces;
  const int b = blockIdx.x;
  float* row = out + static_cast<long long>(b) * r_loc;
  for (int l = threadIdx.x; l < r_loc; l += blockDim.x) row[l] = 0.0f;
  __syncthreads();
  const long long lo = static_cast<long long>(b) * block_items;
  segreduce::reduce_sorted_window<segreduce::kSum>(
      vals, rows, row_base[b], nullptr, lo, lo + block_items, row, r_loc,
      pieces);
}

}  // namespace

extern "C" int spmv_merge_stream_partials(const float* vals, const int* rows,
                                          const int* row_base, int grid,
                                          int block_items, int r_loc,
                                          float* out, cudaStream_t stream) {
  merge_stream_kernel<<<grid, segreduce::kThreads, 0, stream>>>(
      vals, rows, row_base, block_items, r_loc, out);
  return static_cast<int>(cudaGetLastError());
}
