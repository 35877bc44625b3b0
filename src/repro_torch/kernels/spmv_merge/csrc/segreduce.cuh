// Shared device code of the merge-path and chunk-walk kernels: the
// combiners, a block-wide reduction of a window of atoms whose bin keys
// are non-decreasing (tile-sorted atoms) into per-bin results, and what the
// merge-path passes (the SpMV of merge_path.cu, the ordered segment sum of
// segsum.cu) share: the diagonal search, the segmented sums over sorted
// keys that combine their threads' open rows, and the carry kernel.
//
// Design.  The TPU kernels reduce a window with a one-hot matrix product
// (a matrix-unit idiom); here the window is read once, coalesced.  The
// block's warps split the window into contiguous slices.  Each warp walks
// its slice 32 atoms at a time with a warp-segmented inclusive scan
// (shuffles; keys are sorted, so equal keys are contiguous) and carries the
// open run from one step to the next in registers.  A run that is a whole
// bin is written by the lane that ends it.  A run cut by a slice boundary
// is left as a piece in shared memory, and one thread merges the pieces in
// atom order.  Every bin is written exactly once, in a fixed order, with no
// atomics: the result does not depend on scheduling, and integer-valued
// sums are exact.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace segreduce {

enum Combiner { kSum = 0, kMin = 1, kMax = 2 };

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNoKey = INT_MIN;      // an empty piece / no open run
constexpr int kPastEnd = INT_MAX;    // the key of lanes past the slice

template <int C>
__device__ __forceinline__ float identity() {
  return C == kSum ? 0.0f : (C == kMin ? CUDART_INF_F : -CUDART_INF_F);
}

template <int C>
__device__ __forceinline__ float combine(float a, float b) {
  if (C == kSum) return a + b;
  if (C == kMin) return b < a ? b : a;
  return b > a ? b : a;
}

// A sum starts from +0.0, as a segmented sum does: a bin whose only value
// is -0.0 holds +0.0.
template <int C>
__device__ __forceinline__ float finish(float v) {
  return C == kSum ? 0.0f + v : v;
}

// Two pieces per warp: [2w] the run at the slice's start that began in an
// earlier slice, [2w+1] the run at its end that goes on in a later one.
struct Pieces {
  int key[2 * kWarps];
  float val[2 * kWarps];
};

// Reduce atoms [lo, hi) into out[0, L).  Atom a falls in bin
// keys[a] - key_base (non-decreasing in a) with value vals[a], or the
// identity where mask is given and mask[a] == 0.  Bins outside [0, L) are
// dropped; bins no atom falls in are not written, so out must already hold
// the identity.  Every thread of the block calls this (it synchronises).
template <int C>
__device__ void reduce_sorted_window(const float* __restrict__ vals,
                                     const int* __restrict__ keys,
                                     int key_base,
                                     const int* __restrict__ mask,
                                     long long lo, long long hi,
                                     float* __restrict__ out, int L,
                                     Pieces& pieces) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < 2 * kWarps) pieces.key[threadIdx.x] = kNoKey;
  __syncthreads();

  const long long n = hi > lo ? hi - lo : 0;
  const long long per = (n + kWarps - 1) / kWarps;
  const long long s0 = lo + (warp * per < n ? warp * per : n);
  const long long s1 = lo + ((warp + 1) * per < n ? (warp + 1) * per : n);
  if (s0 < s1) {
    const int first_key = keys[s0] - key_base;
    const int last_key = keys[s1 - 1] - key_base;
    const bool head_open = s0 > lo && keys[s0 - 1] - key_base == first_key;
    const bool tail_open = s1 < hi && keys[s1] - key_base == last_key;
    int carry_key = kNoKey;
    float carry_val = identity<C>();
    for (long long t = s0; t < s1; t += 32) {
      const long long a = t + lane;
      const bool active = a < s1;
      const int k = active ? keys[a] - key_base : kPastEnd;
      float v = identity<C>();
      if (active && (mask == nullptr || mask[a] != 0)) v = vals[a];
      if (lane == 0 && k == carry_key) v = combine<C>(carry_val, v);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v_up = __shfl_up_sync(full, v, off);
        const int k_up = __shfl_up_sync(full, k, off);
        if (lane >= off && k_up == k) v = combine<C>(v_up, v);
      }
      int k_next = __shfl_down_sync(full, k, 1);
      if (lane == 31) k_next = a + 1 < s1 ? keys[a + 1] - key_base : kPastEnd;
      const bool run_end = active && k_next != k;
      if (run_end) {
        if (k == first_key && head_open) {
          pieces.key[2 * warp] = k;
          pieces.val[2 * warp] = v;
        } else if (a == s1 - 1 && tail_open) {
          pieces.key[2 * warp + 1] = k;
          pieces.val[2 * warp + 1] = v;
        } else if (k >= 0 && k < L) {
          out[k] = finish<C>(v);
        }
      }
      carry_key = __shfl_sync(full, run_end || !active ? kNoKey : k, 31);
      carry_val = __shfl_sync(full, v, 31);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int key = kNoKey;
    float acc = identity<C>();
    for (int s = 0; s < 2 * kWarps; ++s) {
      const int k = pieces.key[s];
      if (k == kNoKey) continue;
      if (k == key) {
        acc = combine<C>(acc, pieces.val[s]);
        continue;
      }
      if (key != kNoKey && key >= 0 && key < L) out[key] = finish<C>(acc);
      key = k;
      acc = pieces.val[s];
    }
    if (key != kNoKey && key >= 0 && key < L) out[key] = finish<C>(acc);
  }
  __syncthreads();
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
// num_rows are dropped.
constexpr int kCarryThreads = 256;
constexpr int kCarryBack = 8;

template <typename T>
__global__ void __launch_bounds__(kCarryThreads)
add_carries_kernel(const int* __restrict__ carry_row,
                   const T* __restrict__ carry_val, int grid, int num_rows,
                   T* __restrict__ y) {
  __shared__ int s_wkey[kCarryThreads / 32];
  __shared__ T s_wval[kCarryThreads / 32];
  __shared__ T s_part[kCarryThreads];
  const int tid = static_cast<int>(threadIdx.x);
  const int c0 = static_cast<int>(blockIdx.x) * kCarryThreads;
  const int c1 = grid - c0 > kCarryThreads ? c0 + kCarryThreads : grid;
  const int b = c0 + tid;
  const int row = b < c1 ? carry_row[b] : INT_MAX;
  const T val = b < c1 ? carry_val[b] : T(0);
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
        v[i] = p >= 0 ? carry_val[p] : T(0);
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
    y[row] = y[row] + (row == first ? back + sum : sum);
  }
}

}  // namespace segreduce
