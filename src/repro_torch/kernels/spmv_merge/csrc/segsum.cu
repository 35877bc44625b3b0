// Ordered segment sum: out[s] = the sum of the values whose sorted segment
// id is s, added in the order of the sorted items; 0 for an empty segment.
//
// Port glue, not a port of a TPU kernel: the JAX package's segment sums
// (XLA's scatter-add on the TPU) give the same bits on every run, and an
// index_add_ on the card adds in atomic order, which differs from run to
// run wherever a segment has more than two addends.  segops.segment_reduce
// sorts the ids with a stable sort (whose output is unique) and hands this
// kernel the sorted ids and the sort order.
//
// Computes: keys int32 [n] non-decreasing in [0, num_segments); item i has
// the value vals[perm[i]].  Every sum starts from +0.0, so an empty
// segment, or one whose only value is -0.0, holds +0.0, as index_add_ into
// zeros gives.  With cols > 1, vals is [*, cols] and out [num_segments,
// cols] row-major: the sort is shared, and each column is summed by its own
// CTAs (blockIdx.x = tile * cols + column, the columns of a tile side by
// side so they share its keys and value rows in L2) with the tile cuts and
// additions of the one-column sum, so column j has the bits of the call on
// column j alone.
//
// Bound on the H100: bytes.  It reads keys, perm and the values once and
// writes each segment once; one add per item.
//
// Design: K1's merge path (merge_path.cu) with the segments as rows and the
// items as non-zeros.  Item i sits at path position i + keys[i] (after the
// i items and keys[i] segment ends before it), so each CTA finds its tile's
// start and end by a warp search over the sorted keys themselves; no CSR
// offsets are built.  A thread walks kItems path items, adding a value or
// ending a segment: a segment that starts and ends in the thread is written
// directly, the first one it ends takes its carry-in from a CTA-wide
// segmented scan, and the one open at the tile's end goes out as a carry
// that segreduce::add_carries_kernel adds in.  Empty segments are path
// items like any other, so long gaps are spread over the tiles too.  No
// atomics: every segment is written once by the first kernel (and once
// more by the carry kernel where it crosses tiles), in a fixed order.
#include "segreduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                       // path items per thread
constexpr int kTile = kThreads * kItems;        // path items per CTA

using segreduce::block_seg_sum;
using segreduce::kCarryThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_sorted_kernel(const int* __restrict__ keys,
                          const long long* __restrict__ perm,
                          const T* __restrict__ vals, int n,
                          int num_segments, int cols, T* __restrict__ out,
                          int* __restrict__ carry_row,
                          T* __restrict__ carry_val) {
  __shared__ int s_key[kTile + 1];
  __shared__ T s_val[kTile];
  __shared__ T s_scan[kThreads];
  __shared__ int s_coord[2];
  __shared__ int s_wkey[kThreads / 32];
  __shared__ T s_wval[kThreads / 32];

  const int tid = static_cast<int>(threadIdx.x);
  const int total = num_segments + n;
  const int tile = static_cast<int>(blockIdx.x / cols);
  const int col = static_cast<int>(blockIdx.x % cols);
  const int d0 = tile * kTile;
  const int d1 = total - d0 > kTile ? d0 + kTile : total;
  const int warp = tid >> 5;
  if (warp < 2) {
    // items before the tile's start (warp 0) and end (warp 1)
    const int j = segreduce::warp_merge_search(keys, n, warp == 0 ? d0 : d1);
    if ((tid & 31) == 0) s_coord[warp] = j;
  }
  __syncthreads();
  const int j0 = s_coord[0], j1 = s_coord[1];
  const int r0 = d0 - j0;                        // the tile's first segment
  const int tile_items = j1 - j0;

  // the tile's keys (a sentinel past the last: every later path item there
  // is a segment end) and values, in sorted order; keys and perm are read
  // once with one column (evict first) and by every column's CTA otherwise
  for (int i = tid; i <= tile_items; i += kThreads) {
    s_key[i] = i == tile_items ? INT_MAX
               : cols == 1     ? __ldcs(keys + j0 + i)
                               : __ldg(keys + j0 + i);
  }
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int i = tid + s * kThreads;
    if (i < tile_items) {
      const long long src = cols == 1 ? __ldcs(perm + j0 + i)
                                      : __ldg(perm + j0 + i);
      s_val[i] = vals[src * cols + col];
    }
  }
  __syncthreads();

  // -- the thread's kItems path items --
  const int span = d1 - d0;
  const int t0 = tid * kItems < span ? tid * kItems : span;
  const int t1 = t0 + kItems < span ? t0 + kItems : span;
  int lo = 0;
  int hi = t0 < tile_items ? t0 : tile_items;
  while (lo < hi) {                              // items before d0 + t0
    const int mid = (lo + hi) >> 1;
    if (s_key[mid] + j0 + mid < d0 + t0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int q = lo;                                    // tile-local item
  int seg = r0 + t0 - lo;                        // the open segment
  const int first_seg = seg;
  T acc = T(0);
  T head = T(0);
  bool ended = false;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    if (t0 + s < t1) {
      if (s_key[q] == seg) {
        acc += s_val[q];
        ++q;
      } else {
        if (ended) {
          out[static_cast<long long>(seg) * cols + col] = T(0) + acc;
        } else {
          head = acc;
          ended = true;
        }
        acc = T(0);
        ++seg;
      }
    }
  }

  // -- the first segment each thread ends, with its carry-in; the tile's
  // carry --
  const T incl = block_seg_sum<kThreads>(seg, acc, s_wkey, s_wval);
  s_scan[tid] = incl;
  __syncthreads();
  if (ended) {
    const T carry_in = tid > 0 ? s_scan[tid - 1] : T(0);
    out[static_cast<long long>(first_seg) * cols + col] =
        T(0) + (carry_in + head);
  }
  if (tid == kThreads - 1) {
    if (col == 0) carry_row[tile] = seg;
    carry_val[static_cast<long long>(tile) * cols + col] = incl;
  }
}

template <typename T>
int launch(const int* keys, const long long* perm, const void* vals, int n,
           int num_segments, int cols, int* carry_row, void* carry_val,
           void* out, cudaStream_t stream) {
  const int grid = (num_segments + n + kTile - 1) / kTile;
  const int carry_grid = (grid + kCarryThreads - 1) / kCarryThreads;
  if (static_cast<long long>(grid) * cols >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  segment_sum_sorted_kernel<T><<<grid * cols, kThreads, 0, stream>>>(
      keys, perm, static_cast<const T*>(vals), n, num_segments, cols,
      static_cast<T*>(out), carry_row, static_cast<T*>(carry_val));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segreduce::add_carries_kernel<T>
      <<<carry_grid * cols, kCarryThreads, 0, stream>>>(
          carry_row, static_cast<const T*>(carry_val), grid, num_segments,
          cols, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int segment_sum_sorted_tile() { return kTile; }

// dtype codes: 0 = float32, 1 = float64.  perm: int64 [n].  vals: [*,
// cols].  carry_row: int32 scratch of G = ceil((num_segments + n) / kTile)
// entries; carry_val: dtype scratch of G * cols.  out: [num_segments,
// cols], written in full.  Returns a cudaError_t code.
extern "C" int segment_sum_sorted(const int* keys, const long long* perm,
                                  const void* vals, int dtype, int n,
                                  int num_segments, int cols, int* carry_row,
                                  void* carry_val, void* out,
                                  cudaStream_t stream) {
  const long long total = static_cast<long long>(num_segments) + n;
  if (n < 0 || num_segments <= 0 || cols <= 0 || total >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch<float>(keys, perm, vals, n, num_segments, cols, carry_row,
                         carry_val, out, stream);
  }
  if (dtype == 1) {
    return launch<double>(keys, perm, vals, n, num_segments, cols,
                          carry_row, carry_val, out, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
