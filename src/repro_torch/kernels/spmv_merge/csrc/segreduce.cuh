// Shared device code of the merge-path and chunk-walk kernels: the
// combiners of the chunk walk, and what the merge-path passes (the SpMV of
// merge_path.cu, the ordered segment sum of segsum.cu) share: the diagonal
// search, the segmented sums over sorted keys that combine their threads'
// open rows, and the carry kernel.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace segreduce {

enum Combiner { kSum = 0, kMin = 1, kMax = 2 };

template <int C>
__device__ __forceinline__ float identity() {
  return C == kSum ? 0.0f : (C == kMin ? CUDART_INF_F : -CUDART_INF_F);
}

// min and max keep a NaN whichever operand holds it, as jnp.min/jnp.max
// and torch's amin/amax do (a bare comparison drops a NaN in b).
template <int C>
__device__ __forceinline__ float combine(float a, float b) {
  if (C == kSum) return a + b;
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return C == kMin ? (b < a ? b : a) : (b > a ? b : a);
}

// A sum starts from +0.0, as a segmented sum does: a bin whose only value
// is -0.0 holds +0.0.
template <int C>
__device__ __forceinline__ float finish(float v) {
  return C == kSum ? 0.0f + v : v;
}

// Inclusive segmented sum over the warp: lanes with equal keys form one run
// (keys non-decreasing in lane order), added earliest lane first.
template <typename T>
__device__ __forceinline__ T warp_seg_sum(int key, T val) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T v_up = __shfl_up_sync(full, val, off);
    const int k_up = __shfl_up_sync(full, key, off);
    if (lane >= off && k_up == key) val = v_up + val;
  }
  return val;
}

// The same over a block of NT threads (keys non-decreasing in thread
// order).  s_key and s_val hold one entry per warp.  Every thread of the
// block calls this (it synchronises).
template <int NT, typename T>
__device__ T block_seg_sum(int key, T val, int* s_key, T* s_val) {
  constexpr int kBlockWarps = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  val = warp_seg_sum(key, val);
  if (lane == 31) {
    s_key[warp] = key;
    s_val[warp] = val;
  }
  __syncthreads();
  if (warp == 0) {
    const int k = lane < kBlockWarps ? s_key[lane] : INT_MAX;
    const T v = warp_seg_sum(k, lane < kBlockWarps ? s_val[lane] : T(0));
    if (lane < kBlockWarps) s_val[lane] = v;
  }
  __syncthreads();
  // keys are sorted: an equal key in the previous warp's last lane means
  // this lane's run reaches back across the whole of its own warp
  if (warp > 0 && s_key[warp - 1] == key) val = s_val[warp - 1] + val;
  return val;
}

// The number of sorted entries that come before merge diagonal d:
// #{i < n : ends[i] + i < d}, for non-decreasing ends.  On the merge path
// of a CSR, with ends = the row end offsets, that is the rows fully
// consumed before d; with ends = the sorted segment ids of the items, it
// is the items before d.  One warp, 32 probes per round.
__device__ int warp_merge_search(const int* __restrict__ ends, int n,
                                 int d) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int lo = 0;
  int hi = d < n ? d : n;                        // the answer is in [lo, hi]
  while (lo < hi) {
    const int p = lo + static_cast<int>(
        (static_cast<long long>(hi - lo) * (lane + 1)) / 33);
    const bool before = __ldg(ends + p) + p < d;
    const int c = __popc(__ballot_sync(full, before));
    const int p_below = __shfl_sync(full, p, c > 0 ? c - 1 : 0);
    const int p_above = __shfl_sync(full, p, c < 32 ? c : 31);
    if (c > 0) lo = p_below + 1;
    if (c < 32) hi = p_above;
  }
  return lo;
}

// Carries of a merge-path pass: tile b left (row carry_row[b], partial
// carry_val[b]) open at its end, rows non-decreasing in b.  The tile where
// a row ends wrote y[row] with its own part; this adds every run of equal
// carry rows into y[row] with a segmented scan, one carry per thread.  CTA
// c takes carries [c * kCarryThreads, (c + 1) * kCarryThreads) and adds
// each run that ends there.  The chunk's first run may have begun in
// earlier chunks (a row longer than many tiles): then the CTA first sums
// those earlier carries, kCarryBack per thread at a time.  Rows at or past
// num_rows are dropped.  With cols > 1 the values are [*, cols] row-major
// and blockIdx.x % cols picks the column (carry_val [grid, cols], y
// [num_rows, cols]); every column has the same rows, so carry_row is
// shared.
constexpr int kCarryThreads = 256;
constexpr int kCarryBack = 8;

template <typename T>
__global__ void __launch_bounds__(kCarryThreads)
add_carries_kernel(const int* __restrict__ carry_row,
                   const T* __restrict__ carry_val, int grid, int num_rows,
                   int cols, T* __restrict__ y) {
  __shared__ int s_wkey[kCarryThreads / 32];
  __shared__ T s_wval[kCarryThreads / 32];
  __shared__ T s_part[kCarryThreads];
  const int tid = static_cast<int>(threadIdx.x);
  const int col = static_cast<int>(blockIdx.x % cols);
  const int c0 = static_cast<int>(blockIdx.x / cols) * kCarryThreads;
  const int c1 = grid - c0 > kCarryThreads ? c0 + kCarryThreads : grid;
  const int b = c0 + tid;
  const int row = b < c1 ? carry_row[b] : INT_MAX;
  const T val = b < c1 ? carry_val[static_cast<long long>(b) * cols + col]
                       : T(0);
  const int after = b + 1 < grid ? carry_row[b + 1] : INT_MAX;
  const T sum = block_seg_sum<kCarryThreads>(row, val, s_wkey, s_wval);

  // the earlier part of the chunk's first run, where that run ends here
  const int first = carry_row[c0];
  const int past = c1 < grid ? carry_row[c1] : INT_MAX;
  const bool look_back = c0 > 0 && carry_row[c0 - 1] == first &&
                         (carry_row[c1 - 1] != first || past != first);
  T back = T(0);
  if (look_back) {                               // uniform over the CTA
    T part = T(0);
    for (int base = c0 - 1 - tid;; base -= kCarryThreads * kCarryBack) {
      int r[kCarryBack];
      T v[kCarryBack];
#pragma unroll
      for (int i = 0; i < kCarryBack; ++i) {
        const int p = base - i * kCarryThreads;
        r[i] = p >= 0 ? carry_row[p] : -1;
        v[i] = p >= 0 ? carry_val[static_cast<long long>(p) * cols + col]
                      : T(0);
      }
      bool all_in = true;
#pragma unroll
      for (int i = 0; i < kCarryBack; ++i) {
        if (r[i] == first) {
          part = part + v[i];
        } else {
          all_in = false;
        }
      }
      if (!__syncthreads_and(all_in)) break;
    }
    s_part[tid] = part;
    __syncthreads();
    for (int half = kCarryThreads / 2; half > 0; half >>= 1) {
      if (tid < half) s_part[tid] = s_part[tid] + s_part[tid + half];
      __syncthreads();
    }
    back = s_part[0];
  }
  if (b < c1 && after != row && row < num_rows) {
    T& out = y[static_cast<long long>(row) * cols + col];
    out = out + (row == first ? back + sum : sum);
  }
}

}  // namespace segreduce
