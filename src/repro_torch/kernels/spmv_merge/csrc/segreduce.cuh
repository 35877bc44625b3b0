// Shared device code of the merge-path and chunk-walk kernels: the
// combiners and a block-wide reduction of a window of atoms whose bin keys
// are non-decreasing (tile-sorted atoms, merge-path stream rows) into
// per-bin results.
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

}  // namespace segreduce
