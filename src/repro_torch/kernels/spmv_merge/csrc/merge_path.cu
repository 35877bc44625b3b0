// Merge-path SpMV (K1): y = A @ x straight from the CSR.
//
// Replaces: src/repro/kernels/spmv_merge/kernel.py::spmv_merge_stream
// (_spmv_block_kernel), the Pallas TPU kernel, together with the stream
// build and the fixup around it.
//
// Computes: y[r] = sum over row r's non-zeros of values[nz] * x[cols[nz]],
// each product rounded before it is added (__fmul_rn: no contraction into
// an FMA, as the plain version rounds values * x[cols]); every sum starts
// from +0.0, so an empty row, or one whose only product is -0.0, holds
// +0.0.
//
// Why the diagonals are searched: the TPU needs static VMEM windows, so the
// reference materialises the merged (rows + nnz) stream with XLA scatters
// and reduces fixed windows of it.  On the H100 that stream, the per-block
// bins and the fixup's ids cost ~1 GB of traffic around a 0.4 GB product.
// Here each CTA finds where its tile of the merge path starts by a search
// over the row end offsets (Merrill & Garland's merge-based CsrMV, which
// the reference reformulated), and reads the CSR itself.
//
// Bound on the H100: bytes.  It reads row_offsets, cols, values and x once
// and writes y once; two flops per non-zero.
//
// Design.
// * Tiles: CTA b takes merge items [b * kTile, (b + 1) * kTile) of the
//   path that interleaves the row end offsets row_offsets[1:] with the
//   non-zero indices 0..nnz-1 (row r's non-zeros, then its end).  Two
//   warps find the tile's start and end (row, nz) with a 32-way search in
//   global memory (the row end + row index is strictly increasing).
// * Loads before use: a thread's kItems cols and values of the tile (lane-
//   contiguous, so each warp load is one 128-byte line, and streaming, so
//   L2 evicts them before x) are all issued before the x gathers, which
//   are all issued before the products go to shared memory.  The gathers
//   of a dense run of columns are lane-contiguous too; x (16.8 MB at the
//   smoke graph) stays in the 50 MB L2.  The tile's row ends are staged
//   beside the products; each thread searches its own diagonal there.
//   (Lane-contiguous 4-byte loads timed faster than 16-byte quads or
//   cp.async staging here: a quad per lane spreads a dense run's gathers
//   over four lines per warp load.)
// * Rows: a thread walks kItems merge items, adding a product or ending a
//   row.  A row that starts and ends in the thread is written to y
//   directly.  The first row a thread ends may have begun in earlier
//   threads: a CTA-wide segmented scan of the threads' open rows gives its
//   carry-in.  The row still open at the tile's end goes out as a carry
//   (row, partial) to a per-tile scratch array.
// * Carries: a second kernel (segreduce::add_carries_kernel) adds every
//   run of equal carry rows (they are non-decreasing in tile order) into y
//   with a segmented scan, one carry per thread; a run longer than a CTA's
//   share is summed by the CTA where it ends, walking back over the
//   earlier carries.
// * Every row is written exactly once by the first kernel; no atomics, so
//   y has the same bits on every run.
#include "segreduce.cuh"

namespace {

// Timed on the H100 at the smoke graph: 256 x 8 beat 128 x 8, 128 x 16,
// 256 x 12, 256 x 16 and 512 x 4; 6 CTAs per SM (40 registers, no spills)
// beat the 46-register build's 5.
constexpr int kThreads = 256;
constexpr int kItems = 8;                       // merge items per thread
constexpr int kTile = kThreads * kItems;        // merge items per CTA
constexpr int kBlocksPerSM = 6;

using segreduce::block_seg_sum;
using segreduce::kCarryThreads;

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
merge_path_kernel(const int* __restrict__ row_offsets,
                  const int* __restrict__ cols,
                  const float* __restrict__ vals,
                  const float* __restrict__ x, int num_rows, int nnz,
                  float* __restrict__ y, int* __restrict__ carry_row,
                  float* __restrict__ carry_val) {
  __shared__ int s_row_end[kTile + 1];
  __shared__ float s_prod[kTile];
  __shared__ float s_scan[kThreads];
  __shared__ int s_coord[4];
  __shared__ int s_wkey[kThreads / 32];
  __shared__ float s_wval[kThreads / 32];

  const int tid = static_cast<int>(threadIdx.x);
  const int total = num_rows + nnz;
  const int d0 = static_cast<int>(blockIdx.x) * kTile;
  const int d1 = total - d0 > kTile ? d0 + kTile : total;
  const int warp = tid >> 5;
  if (warp < 2) {
    const int d = warp == 0 ? d0 : d1;
    // rows fully consumed before d
    const int r = segreduce::warp_merge_search(row_offsets + 1, num_rows, d);
    if ((tid & 31) == 0) {
      s_coord[2 * warp] = r;
      s_coord[2 * warp + 1] = d - r < nnz ? d - r : nnz;
    }
  }
  __syncthreads();
  const int r0 = s_coord[0], j0 = s_coord[1];
  const int r1 = s_coord[2], j1 = s_coord[3];
  const int tile_rows = r1 - r0;                 // rows that end in the tile

  // -- the tile's non-zeros: cols and values, then x, then the products --
  const int tile_nnz = j1 - j0;
  int c[kItems];
  float v[kItems];
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int k = tid + s * kThreads;
    c[s] = k < tile_nnz ? __ldcs(cols + j0 + k) : 0;
    v[s] = k < tile_nnz ? __ldcs(vals + j0 + k) : 0.0f;
  }
  // the row ends of the tile; the open row's end is past every non-zero
  for (int k = tid; k <= tile_rows; k += kThreads) {
    s_row_end[k] = k < tile_rows ? __ldcs(row_offsets + r0 + 1 + k) : INT_MAX;
  }
  float xv[kItems];
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    xv[s] = tid + s * kThreads < tile_nnz ? __ldg(x + c[s]) : 0.0f;
  }
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int k = tid + s * kThreads;
    if (k < tile_nnz) s_prod[k] = __fmul_rn(v[s], xv[s]);
  }
  __syncthreads();

  // -- the thread's kItems merge items --
  const int span = d1 - d0;
  const int t0 = tid * kItems < span ? tid * kItems : span;
  const int t1 = t0 + kItems < span ? t0 + kItems : span;
  int lo = 0;
  int hi = t0 < tile_rows ? t0 : tile_rows;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_row_end[mid] + r0 + mid < d0 + t0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int first_row = lo;                      // tile-local row
  int k = lo;
  int q = t0 - lo;                               // tile-local non-zero
  float acc = 0.0f;
  float head = 0.0f;
  bool ended = false;
  int row_end = s_row_end[k];
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    if (t0 + s < t1) {
      if (j0 + q < row_end) {
        acc += s_prod[q];
        ++q;
      } else {
        if (ended) {
          y[r0 + k] = 0.0f + acc;
        } else {
          head = acc;
          ended = true;
        }
        acc = 0.0f;
        row_end = s_row_end[++k];
      }
    }
  }

  // -- the first row each thread ends, with its carry-in; the tile's carry --
  const float incl = block_seg_sum<kThreads>(k, acc, s_wkey, s_wval);
  s_scan[tid] = incl;
  __syncthreads();
  if (ended) {
    const float carry_in = tid > 0 ? s_scan[tid - 1] : 0.0f;
    y[r0 + first_row] = 0.0f + (carry_in + head);
  }
  if (tid == kThreads - 1) {
    carry_row[blockIdx.x] = r0 + k;
    carry_val[blockIdx.x] = incl;
  }
}

}  // namespace

extern "C" int spmv_merge_csr_tile() { return kTile; }

// carry_row / carry_val: int32 / f32 scratch of ceil((num_rows + nnz) /
// kTile) entries.  y: f32 [num_rows], written in full.
extern "C" int spmv_merge_csr(const int* row_offsets, const int* cols,
                              const float* vals, const float* x,
                              int num_rows, int nnz, int* carry_row,
                              float* carry_val, float* y,
                              cudaStream_t stream) {
  const long long total = static_cast<long long>(num_rows) + nnz;
  if (total <= 0 || total >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = static_cast<int>((total + kTile - 1) / kTile);
  merge_path_kernel<<<grid, kThreads, 0, stream>>>(
      row_offsets, cols, vals, x, num_rows, nnz, y, carry_row, carry_val);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segreduce::add_carries_kernel<float>
      <<<(grid + kCarryThreads - 1) / kCarryThreads, kCarryThreads, 0,
         stream>>>(carry_row, carry_val, grid, num_rows, 1, y);
  return static_cast<int>(cudaGetLastError());
}
