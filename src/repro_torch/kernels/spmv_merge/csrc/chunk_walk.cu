// Chunk-walk kernels (K2 tiles, K3 atoms, K4 compact): the native
// executor behind every schedule.
//
// Replaces: src/repro/kernels/spmv_merge/kernel.py::chunk_walk_reduce
// (_chunk_walk_kernel) with emit="tiles", "atoms" and "compact".
//
// The queues: block p pops chunks[p * max_chunks + i] for i < counts[p]
// (the inverted block map of a dynamic schedule, or the identity queue of
// a static one), and only the rows of popped chunks are written.  A chunk's
// row is a function of that chunk alone, so no kernel walks a queue in
// order: each launches over (queue slot, part of the chunk), a CTA whose
// slot is past its queue's count returns at once, and all of a queue's
// chunks run side by side.
//
// * tiles (K2): chunk c's atoms [atom_starts[c], min(atom_starts[c+1],
//   atom_starts[c] + window)) are tile-sorted, so each of the L local bins
//   (key tids[a] - tile_starts[c]) is one contiguous run; out[c, k] is the
//   sum/min/max of bin k's values, masked atoms giving the identity, bins
//   with no atom the identity.
//   A team of CTAs shares a chunk.  CTA t takes slice t of its atoms and
//   owns the bins whose first atom lies in that slice (the team's last CTA
//   also owns the empty bins after the chunk's last key): it skips the
//   atoms at its slice's start that belong to a bin owned earlier (a
//   32-ary warp search) and reads on past its slice's end to the end of
//   its last bin.  So every bin is reduced whole by one CTA and written
//   once, with no second pass and no atomics.  Inside the CTA the 8 warps
//   split that range evenly; a run cut by a warp boundary is left as a
//   piece in shared memory, and after one barrier warp 0 merges the pieces
//   in atom order with a segmented scan.  An empty bin is written with the
//   identity by the thread whose atom starts the next run (a warp together
//   for a long gap), or by the CTA after its last run: no fill pass.
//   One column: a lane takes kItems consecutive atoms a step, as 16-byte
//   loads of keys, values and mask where the addresses allow (scalar
//   loads elsewhere), with the next step's loads issued before this step's
//   scan.  It folds its runs in registers and writes those that start and
//   end inside it; a warp-segmented scan over the lanes' last runs
//   (reduce by key) finishes the runs that cross lanes, and the warp's
//   open run is carried in registers to the next step.
//   B columns (values [A + window, B], out [C, L, B]): a CTA takes 128
//   columns (blockIdx.y) and a lane 4 of them (one 16-byte load and store
//   where B % 4 == 0); each warp walks its atoms in order, kUnroll atoms
//   in flight, reading a key and a mask once for all of its columns.
//   The order of the additions in a bin is a function of the chunk's atoms
//   and B alone, so every run gives the same bits.
// * atoms (K3): out[c, j] = vals[atom_starts[c] + j] where that atom is
//   inside the chunk and unmasked, else the identity.  One CTA per (queue
//   slot, 2,048-slot slice of the window); a thread takes 4 consecutive
//   slots on a 16-byte boundary of the output row (a row's first slots up
//   to the boundary go one by one), so every store but those is one
//   16-byte store whatever the window; values are read only for unmasked
//   atoms inside the chunk, as one 16-byte load (with a 16-byte mask load)
//   where the atoms too are aligned, scalar loads elsewhere.  A copy, so
//   bitwise equal to the plain version.
// * compact (K4): the chunk bounds run over compacted slots; out[c, j] =
//   vals[idx[starts[c] + j]] inside the chunk, else the identity.  The same
//   grid and thread shape as K3: one 16-byte index load where the window
//   and the chunk start are multiples of 4, all four gathers issued before
//   the first is stored, one 16-byte store; scalar accesses elsewhere.
//
// Bound on the H100: bytes.  tiles reads each atom's values, tile id and
// mask once and writes C * L * B partials; atoms and compact read the
// chunk's values (and mask, or index) once and write C * window.  Three
// instantiations per mode, one per combiner.
#include <climits>
#include <cstdint>

#include "segreduce.cuh"

namespace {

using segreduce::combine;
using segreduce::finish;
using segreduce::identity;

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// K2: tiles
// ---------------------------------------------------------------------------

// Sizes timed best at PageRank's and the forest's shapes on the H100
// (swept: kItems 4/8/16, slices of 4,096-32,768 atoms, 4-6 CTAs an SM;
// kUnroll 2/4/8/16, 1,024-16,384 values a warp, 1-3 CTAs an SM).
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kPieces = 2 * kTileWarps;  // a head and a tail piece per warp
constexpr int kItems = 4;                // one column: atoms a lane, a step
constexpr int kStep = 32 * kItems;       // one column: atoms a warp, a step
constexpr int kSliceAtoms = 16384;       // one column: atoms a CTA owns
constexpr int kOneColumnCtas = 5;        // one column: CTAs an SM (48 regs)
constexpr int kCols = 128;               // B columns: columns a CTA takes
constexpr int kUnroll = 4;               // B columns: atoms a warp in flight
constexpr int kColumnsCtas = 3;          // B columns: CTAs an SM (78 regs)
constexpr int kWarpValues = 2048;        // B columns: values a warp reads
constexpr int kSmallGap = 4;             // empty bins a lane writes alone
constexpr int kNoKey = INT_MIN;          // an empty piece
constexpr int kPastEnd = INT_MAX;        // the key of a lane with no atom

// Atoms of a CTA's slice: kSliceAtoms for one column; for B columns 8
// warps of kWarpValues / B atoms (8 to 512, a multiple of 8), so a slice
// moves about as many bytes whatever B is.
int tile_slice(int cols) {
  if (cols == 1) return kSliceAtoms;
  int per = kWarpValues / cols;
  per = per < 8 ? 8 : (per > 512 ? 512 : per);
  return kTileWarps * (per & ~7);
}

// The first atom a in [from, to) whose key tids[a] - kbase is >= k, or to
// (keys are non-decreasing).  One warp; every lane returns the answer.
// The first round probes the 32 atoms at from (bins are usually short),
// then each round narrows the range 33-fold.
__device__ int warp_lower_bound(const int* __restrict__ tids, int kbase,
                                int from, int to, int k) {
  const int lane = threadIdx.x & 31;
  const int a = from + lane;
  const bool ge = a >= to || __ldg(tids + a) - kbase >= k;
  const unsigned hit = __ballot_sync(kFull, ge);
  if (hit != 0) return from + __ffs(hit) - 1;
  int lo = from + 32;                            // the answer is in [lo, hi]
  int hi = to;
  while (lo < hi) {
    const int p = lo + static_cast<int>(
        (static_cast<long long>(hi - lo) * (lane + 1)) / 33);
    const bool below = __ldg(tids + p) - kbase < k;
    const int n = __popc(__ballot_sync(kFull, below));
    const int p_below = __shfl_sync(kFull, p, n > 0 ? n - 1 : 0);
    const int p_above = __shfl_sync(kFull, p, n < 32 ? n : 31);
    if (n > 0) lo = p_below + 1;
    if (n < 32) hi = p_above;
  }
  return lo;
}

// What a warp knows of its share [lo, hi) of the CTA's atoms: the key
// before it, its first and last keys, and whether its first run began in
// the previous warp (head_open) or its last run goes on in the next one
// (tail_open); such runs become pieces.  Keys are local (minus kbase).
struct Share {
  float* row;      // out + c * L * cols
  int L;
  int cols;
  int warp;
  int prev;        // the key before the share (k_first - 1 for warp 0)
  int first;
  int last;
  bool head_open;
  bool tail_open;
};

// One column: a finished run of key k with value v.
template <int C>
__device__ __forceinline__ void put_run(const Share& s, int k, float v,
                                        int* s_key, float* s_val) {
  if (s.head_open && k == s.first) {
    s_key[2 * s.warp] = k;
    s_val[2 * s.warp] = v;
  } else if (s.tail_open && k == s.last) {
    s_key[2 * s.warp + 1] = k;
    s_val[2 * s.warp + 1] = v;
  } else if (k >= 0 && k < s.L) {
    s.row[k] = finish<C>(v);
  }
}

// One column: lane's kItems atoms from a0 (a multiple of 4): local keys and
// values, masked atoms holding the identity.  Atoms past a_pad are not read.
template <int C>
__device__ __forceinline__ void load_items(const float* __restrict__ vals,
                                           const int* __restrict__ tids,
                                           const int* __restrict__ mask,
                                           int kbase, int a_pad, bool vec,
                                           int a0, int (&k)[kItems],
                                           float (&v)[kItems]) {
  if (vec && a0 + kItems <= a_pad) {
#pragma unroll
    for (int q = 0; q < kItems; q += 4) {
      const int4 kk = __ldg(reinterpret_cast<const int4*>(tids + a0 + q));
      const float4 vv = __ldg(reinterpret_cast<const float4*>(vals + a0 + q));
      k[q] = kk.x - kbase;
      k[q + 1] = kk.y - kbase;
      k[q + 2] = kk.z - kbase;
      k[q + 3] = kk.w - kbase;
      v[q] = vv.x;
      v[q + 1] = vv.y;
      v[q + 2] = vv.z;
      v[q + 3] = vv.w;
      if (mask != nullptr) {
        const int4 mm = __ldg(reinterpret_cast<const int4*>(mask + a0 + q));
        if (mm.x == 0) v[q] = identity<C>();
        if (mm.y == 0) v[q + 1] = identity<C>();
        if (mm.z == 0) v[q + 2] = identity<C>();
        if (mm.w == 0) v[q + 3] = identity<C>();
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int a = a0 + j;
    k[j] = 0;
    v[j] = identity<C>();
    if (a < a_pad) {
      k[j] = __ldg(tids + a) - kbase;
      if (mask == nullptr || __ldg(mask + a) != 0) v[j] = __ldg(vals + a);
    }
  }
}

// One column: the warp reduces atoms [lo, hi) of its share, kStep a step.
template <int C>
__device__ void walk_atoms(const float* __restrict__ vals,
                           const int* __restrict__ tids,
                           const int* __restrict__ mask, int kbase,
                           int a_pad, bool vec, const Share& s, int lo,
                           int hi, int* s_key, float* s_val) {
  const int lane = threadIdx.x & 31;
  int carry_key = s.prev;          // the key of the atom before the step
  float carry_val = identity<C>(); // the open run's value so far
  bool carry_run = false;          // the open run holds atoms of this warp
  const int start = lo & ~3;
  int nk[kItems];
  float nv[kItems];
  load_items<C>(vals, tids, mask, kbase, a_pad, vec, start + lane * kItems,
                nk, nv);
  for (int step = start; step < hi; step += kStep) {
    int k[kItems];
    float v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      k[j] = nk[j];
      v[j] = nv[j];
    }
    if (step + kStep < hi) {
      load_items<C>(vals, tids, mask, kbase, a_pad, vec,
                    step + kStep + lane * kItems, nk, nv);
    }
    const int a0 = step + lane * kItems;
    int kf = kPastEnd;               // the lane's first and last keys
    int kl = kPastEnd;
    bool any = false;
#pragma unroll
    for (int j = kItems - 1; j >= 0; --j) {
      if (a0 + j >= lo && a0 + j < hi) {
        kf = k[j];
        if (!any) kl = k[j];
        any = true;
      }
    }
    int prev = __shfl_up_sync(kFull, kl, 1);
    if (lane == 0) prev = carry_key;
    // the carried run ends where this step starts a new one
    if (lane == 0 && carry_run && kf != carry_key) {
      put_run<C>(s, carry_key, carry_val, s_key, s_val);
    }

    // fold the lane's atoms: runs that start and end here are written now;
    // the first run (head) and the last (tail) may cross lanes
    int cur = prev;
    float val = identity<C>();
    float head = identity<C>();
    bool started = false;
    bool multi = false;              // the first run ends inside the lane
    int gap0[kItems];                // empty bins [gap0, gap1) before atom j
    int gap1[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      gap0[j] = 0;
      gap1[j] = 0;
      if (a0 + j < lo || a0 + j >= hi) continue;
      if (k[j] == cur) {
        val = started ? combine<C>(val, v[j]) : v[j];
        started = true;
        continue;
      }
      if (started) {
        if (multi) {
          put_run<C>(s, cur, val, s_key, s_val);
        } else {
          head = val;
          multi = true;
        }
      }
      gap0[j] = max(cur + 1, 0);
      gap1[j] = min(k[j], s.L);
      cur = k[j];
      val = v[j];
      started = true;
    }

    // segmented scan of the lanes' tail runs, the carry entering lane 0
    float scan = any ? val : identity<C>();
    bool flag = !any || multi || kf != prev;  // the tail run starts here
    if (lane == 0) {
      if (!flag) scan = combine<C>(carry_val, scan);
      flag = true;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(kFull, scan, off);
      const int flag_up = __shfl_up_sync(kFull, static_cast<int>(flag), off);
      if (lane >= off) {
        if (!flag) scan = combine<C>(up, scan);
        flag = flag || flag_up != 0;
      }
    }
    float before = __shfl_up_sync(kFull, scan, 1);
    if (lane == 0) before = carry_val;
    if (any && multi) {
      put_run<C>(s, kf, kf == prev ? combine<C>(before, head) : head, s_key,
                 s_val);
    }
    const int next_first = __shfl_down_sync(kFull, kf, 1);
    if (any && lane < 31 && next_first != kl) {
      put_run<C>(s, kl, scan, s_key, s_val);
    }
    carry_key = __shfl_sync(kFull, kl, 31);
    carry_val = __shfl_sync(kFull, scan, 31);
    carry_run = __shfl_sync(kFull, static_cast<int>(any), 31) != 0;

    // empty bins: short gaps by their lane, long ones by the whole warp
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int len = gap1[j] - gap0[j];
      if (len > 0 && len <= kSmallGap) {
        for (int b = gap0[j]; b < gap1[j]; ++b) s.row[b] = identity<C>();
      }
      unsigned big = __ballot_sync(kFull, len > kSmallGap);
      while (big != 0) {
        const int src = __ffs(big) - 1;
        big &= big - 1;
        const int b0 = __shfl_sync(kFull, gap0[j], src);
        const int b1 = __shfl_sync(kFull, gap1[j], src);
        for (int b = b0 + lane; b < b1; b += 32) s.row[b] = identity<C>();
      }
    }
  }
  if (lane == 0 && carry_run) {
    put_run<C>(s, carry_key, carry_val, s_key, s_val);
  }
}

// B columns: the lane's 4 columns of one atom (identity where masked).
template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ vals,
                                         const int* __restrict__ mask,
                                         long long a, int cols, int col,
                                         int ncol, bool vec, float (&v)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = identity<C>();
  if (ncol == 0 || (mask != nullptr && __ldg(mask + a) == 0)) return;
  const float* src = vals + a * cols + col;
  if (vec && ncol == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < ncol) v[q] = __ldg(src + q);
  }
}

template <int C>
__device__ __forceinline__ void store_row(float* dst, int ncol, bool vec,
                                          const float (&v)[4]) {
  if (vec && ncol == 4) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(finish<C>(v[0]), finish<C>(v[1]), finish<C>(v[2]),
                    finish<C>(v[3]));
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < ncol) dst[q] = finish<C>(v[q]);
  }
}

// B columns: a finished run (all the warp's lanes call this together).
template <int C>
__device__ __forceinline__ void put_row(const Share& s, int k,
                                        const float (&v)[4], int col,
                                        int ncol, bool vec, int* s_key,
                                        float* s_val) {
  const int lane = threadIdx.x & 31;
  int piece = -1;
  if (s.head_open && k == s.first) {
    piece = 2 * s.warp;
  } else if (s.tail_open && k == s.last) {
    piece = 2 * s.warp + 1;
  }
  if (piece >= 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) s_val[piece * kCols + 4 * lane + q] = v[q];
    if (lane == 0) s_key[piece] = k;
  } else if (k >= 0 && k < s.L) {
    store_row<C>(s.row + static_cast<long long>(k) * s.cols + col, ncol,
                 vec, v);
  }
}

// B columns: empty bins [b0, b1) get the identity in the lane's columns.
template <int C>
__device__ __forceinline__ void fill_rows(const Share& s, int b0, int b1,
                                          int col, int ncol, bool vec,
                                          int stride) {
  float id[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) id[q] = identity<C>();
  for (int b = max(b0, 0); b < min(b1, s.L); b += stride) {
    store_row<C>(s.row + static_cast<long long>(b) * s.cols + col, ncol,
                 vec, id);
  }
}

// B columns: the warp reduces atoms [lo, hi) of its share in order,
// kUnroll atoms in flight; the lane holds columns [col, col + ncol).
template <int C>
__device__ void walk_columns(const float* __restrict__ vals,
                             const int* __restrict__ tids,
                             const int* __restrict__ mask, int kbase,
                             bool vec, const Share& s, int lo, int hi,
                             int col, int ncol, int* s_key, float* s_val) {
  int cur = s.prev;
  float acc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = identity<C>();
  bool open = false;
  int nk[kUnroll];
  float nv[kUnroll][4];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    nk[u] = lo + u < hi ? __ldg(tids + lo + u) - kbase : kPastEnd;
    load_row<C>(vals, mask, lo + u < hi ? lo + u : lo, s.cols, col,
                lo + u < hi ? ncol : 0, vec, nv[u]);
  }
  for (int step = lo; step < hi; step += kUnroll) {
    int k[kUnroll];
    float v[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      k[u] = nk[u];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[u][q] = nv[u][q];
    }
    const int next = step + kUnroll;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = next + u < hi;
      nk[u] = in ? __ldg(tids + next + u) - kbase : kPastEnd;
      load_row<C>(vals, mask, in ? next + u : lo, s.cols, col, in ? ncol : 0,
                  vec, nv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (step + u >= hi) break;
      if (k[u] == cur) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[q] = open ? combine<C>(acc[q], v[u][q]) : v[u][q];
        }
        open = true;
        continue;
      }
      if (open) put_row<C>(s, cur, acc, col, ncol, vec, s_key, s_val);
      fill_rows<C>(s, cur + 1, k[u], col, ncol, vec, 1);
      cur = k[u];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = v[u][q];
      open = true;
    }
  }
  if (open) put_row<C>(s, cur, acc, col, ncol, vec, s_key, s_val);
}

template <int C, bool kBatch>
__global__ void
__launch_bounds__(kTileThreads, kBatch ? kColumnsCtas : kOneColumnCtas)
chunk_walk_tiles_kernel(const float* __restrict__ vals,
                        const int* __restrict__ tids,
                        const int* __restrict__ mask,
                        const int* __restrict__ atom_starts,
                        const int* __restrict__ tile_starts,
                        const int* __restrict__ chunks,
                        const int* __restrict__ counts, int max_chunks,
                        int window, int L, int cols, int slice, int team,
                        int a_pad, bool vec, float* __restrict__ out) {
  __shared__ int s_range[2];
  __shared__ int s_key[kPieces];
  __shared__ float s_val[kPieces * (kBatch ? kCols : 1)];

  // the chunk, this CTA's slice of it, and the bins it owns
  const long long slot = blockIdx.x / team;
  const int t = static_cast<int>(blockIdx.x % team);
  const int p = static_cast<int>(slot / max_chunks);
  if (slot % max_chunks >= counts[p]) return;
  const int c = chunks[slot];
  const int base = atom_starts[c];
  const int len = min(atom_starts[c + 1] - base, window);
  const int end = base + len;
  const long long cut0 = static_cast<long long>(t) * slice;
  if (t > 0 && cut0 >= len) return;
  const int p0 = base + static_cast<int>(cut0);
  const int p1 =
      base + static_cast<int>(cut0 + slice < len ? cut0 + slice : len);
  const bool last = p1 == end;
  const int kbase = tile_starts[c];
  const int k_first = t == 0 ? 0 : __ldg(tids + p0 - 1) - kbase + 1;
  const int k_stop = last ? L : __ldg(tids + p1 - 1) - kbase + 1;
  if (k_stop <= k_first) return;       // the slice is inside an earlier bin

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 0) {
    const int lo =
        t == 0 ? base : warp_lower_bound(tids, kbase, p0, end, k_first);
    if (lane == 0) s_range[0] = lo;
  } else if (warp == 1) {
    const int hi =
        last ? end : warp_lower_bound(tids, kbase, p1, end, k_stop);
    if (lane == 0) s_range[1] = hi;
  }
  if (lane < 2) s_key[2 * warp + lane] = kNoKey;
  __syncthreads();
  const int lo = s_range[0];
  const int hi = s_range[1];

  // the warp's share of [lo, hi)
  const int n = hi - lo;
  const int per = ((n + kTileWarps - 1) / kTileWarps + 3) & ~3;
  const int lo_w = lo + min(warp * per, n);
  const int hi_w = lo + min((warp + 1) * per, n);
  Share s;
  s.row = out + static_cast<long long>(c) * L * cols;
  s.L = L;
  s.cols = cols;
  s.warp = warp;
  const int col = static_cast<int>(blockIdx.y) * kCols + 4 * lane;
  const int ncol = kBatch ? max(0, min(4, cols - col)) : 0;
  if (lo_w < hi_w) {
    s.prev = lo_w > lo ? __ldg(tids + lo_w - 1) - kbase : k_first - 1;
    s.first = __ldg(tids + lo_w) - kbase;
    s.last = __ldg(tids + hi_w - 1) - kbase;
    s.head_open = lo_w > lo && s.prev == s.first;
    s.tail_open = hi_w < hi && __ldg(tids + hi_w) - kbase == s.last;
    if constexpr (kBatch) {
      walk_columns<C>(vals, tids, mask, kbase, vec, s, lo_w, hi_w, col, ncol,
                      s_key, s_val);
    } else {
      walk_atoms<C>(vals, tids, mask, kbase, a_pad, vec, s, lo_w, hi_w,
                    s_key, s_val);
    }
  }
  __syncthreads();

  // warp 0 merges the pieces in atom order
  if (warp == 0) {
    if constexpr (kBatch) {
      int cur = kNoKey;
      float acc[4] = {identity<C>(), identity<C>(), identity<C>(),
                      identity<C>()};
      for (int i = 0; i < kPieces; ++i) {
        const int k = s_key[i];
        if (k == kNoKey) continue;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = s_val[i * kCols + 4 * lane + q];
        if (k == cur) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = combine<C>(acc[q], v[q]);
          continue;
        }
        if (cur >= 0 && cur < L) {
          store_row<C>(s.row + static_cast<long long>(cur) * cols + col,
                       ncol, vec, acc);
        }
        cur = k;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = v[q];
      }
      if (cur != kNoKey && cur >= 0 && cur < L) {
        store_row<C>(s.row + static_cast<long long>(cur) * cols + col, ncol,
                     vec, acc);
      }
    } else {
      const int k = lane < kPieces ? s_key[lane] : kNoKey;
      const bool has = k != kNoKey;
      float v = has ? s_val[lane] : identity<C>();
      const unsigned present = __ballot_sync(kFull, has);
      const unsigned below = present & ((1u << lane) - 1u);
      const unsigned above = lane == 31 ? 0u : present & (~0u << (lane + 1));
      const int k_before = __shfl_sync(kFull, k, below ? 31 - __clz(below) : 0);
      const int k_after = __shfl_sync(kFull, k, above ? __ffs(above) - 1 : 0);
      bool flag = has && (below == 0 || k_before != k);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(kFull, v, off);
        const int flag_up = __shfl_up_sync(kFull, static_cast<int>(flag), off);
        if (lane >= off) {
          if (!flag) v = combine<C>(up, v);
          flag = flag || flag_up != 0;
        }
      }
      if (has && (above == 0 || k_after != k) && k >= 0 && k < L) {
        s.row[k] = finish<C>(v);
      }
    }
  }

  // the empty bins after the CTA's last run
  const int tail0 =
      max(n > 0 ? __ldg(tids + hi - 1) - kbase + 1 : k_first, 0);
  if constexpr (kBatch) {
    fill_rows<C>(s, tail0 + warp, k_stop, col, ncol, vec, kTileWarps);
  } else {
    for (int b = tail0 + static_cast<int>(threadIdx.x); b < min(k_stop, L);
         b += kTileThreads) {
      s.row[b] = identity<C>();
    }
  }
}

// ---------------------------------------------------------------------------
// K3 (atoms) and K4 (compact): one CTA per (queue slot, slice of kSlice
// window slots); a thread takes kVec consecutive slots (4 timed faster
// than 2 or 8 for K4 at delta-stepping's shape on the H100).
// ---------------------------------------------------------------------------

constexpr int kGatherThreads = 512;
constexpr int kVec = 4;
constexpr int kSlice = kGatherThreads * kVec;

template <int C>
__device__ __forceinline__ float atom_or_identity(
    const float* __restrict__ vals, const int* __restrict__ mask,
    long long a, long long end) {
  return a < end && (mask == nullptr || __ldg(mask + a) != 0)
             ? __ldg(vals + a)
             : identity<C>();
}

template <int C>
__global__ void __launch_bounds__(kGatherThreads)
chunk_walk_atoms_kernel(const float* __restrict__ vals,
                        const int* __restrict__ mask,
                        const int* __restrict__ atom_starts,
                        const int* __restrict__ chunks,
                        const int* __restrict__ counts, int max_chunks,
                        int window, int slices, bool vec_load,
                        float* __restrict__ out) {
  const long long slot = blockIdx.x / slices;    // p * max_chunks + i
  const int p = static_cast<int>(slot / max_chunks);
  const int i = static_cast<int>(slot % max_chunks);
  if (i >= counts[p]) return;
  const int slice = static_cast<int>(blockIdx.x % slices);
  const int c = chunks[slot];
  const long long base = atom_starts[c];
  const long long end = atom_starts[c + 1];
  float* row = out + static_cast<long long>(c) * window;
  // groups of 4 slots on 16-byte boundaries of the row, after its first
  // `head` slots (out is 16-byte aligned, a row starts at c * window)
  const int head =
      static_cast<int>((4 - static_cast<long long>(c) * window % 4) % 4);
  if (slice == 0 && threadIdx.x == 0) {
    for (int j = 0; j < head && j < window; ++j) {
      row[j] = atom_or_identity<C>(vals, mask, base + j, end);
    }
  }
  const int j0 = head + kVec * (slice * kGatherThreads + threadIdx.x);
  if (j0 >= window) return;
  if (j0 + kVec > window) {
    for (int j = j0; j < window; ++j) {
      row[j] = atom_or_identity<C>(vals, mask, base + j, end);
    }
    return;
  }
  const long long a0 = base + j0;
  float f[kVec];
  if (vec_load && a0 % 4 == 0 && a0 + kVec <= end) {
    int4 m = make_int4(1, 1, 1, 1);
    if (mask != nullptr) m = __ldg(reinterpret_cast<const int4*>(mask + a0));
    if (m.x != 0 && m.y != 0 && m.z != 0 && m.w != 0) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(vals + a0));
      f[0] = v.x;
      f[1] = v.y;
      f[2] = v.z;
      f[3] = v.w;
    } else {
      f[0] = m.x != 0 ? __ldg(vals + a0) : identity<C>();
      f[1] = m.y != 0 ? __ldg(vals + a0 + 1) : identity<C>();
      f[2] = m.z != 0 ? __ldg(vals + a0 + 2) : identity<C>();
      f[3] = m.w != 0 ? __ldg(vals + a0 + 3) : identity<C>();
    }
  } else {
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      f[q] = atom_or_identity<C>(vals, mask, a0 + q, end);
    }
  }
  *reinterpret_cast<float4*>(row + j0) = make_float4(f[0], f[1], f[2], f[3]);
}

template <int C>
__global__ void __launch_bounds__(kGatherThreads)
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

#define DISPATCH_COMBINER(combiner, KERNEL, grid, threads, stream, ...)      \
  switch (combiner) {                                                        \
    case segreduce::kSum:                                                    \
      KERNEL<segreduce::kSum><<<grid, threads, 0, stream>>>(__VA_ARGS__);    \
      break;                                                                 \
    case segreduce::kMin:                                                    \
      KERNEL<segreduce::kMin><<<grid, threads, 0, stream>>>(__VA_ARGS__);    \
      break;                                                                 \
    case segreduce::kMax:                                                    \
      KERNEL<segreduce::kMax><<<grid, threads, 0, stream>>>(__VA_ARGS__);    \
      break;                                                                 \
    default:                                                                 \
      return static_cast<int>(cudaErrorInvalidValue);                        \
  }

// K2 with one column (kBatch false) or B columns.
template <bool kBatch>
int launch_tiles(int combiner, dim3 grid, cudaStream_t stream,
                 const float* vals, const int* tids, const int* mask,
                 const int* atom_starts, const int* tile_starts,
                 const int* chunks, const int* counts, int max_chunks,
                 int window, int L, int cols, int slice, int team, int a_pad,
                 bool vec, float* out) {
#define TILES(C)                                                             \
  chunk_walk_tiles_kernel<C, kBatch><<<grid, kTileThreads, 0, stream>>>(     \
      vals, tids, mask, atom_starts, tile_starts, chunks, counts,            \
      max_chunks, window, L, cols, slice, team, a_pad, vec, out)
  switch (combiner) {
    case segreduce::kSum:
      TILES(segreduce::kSum);
      break;
    case segreduce::kMin:
      TILES(segreduce::kMin);
      break;
    case segreduce::kMax:
      TILES(segreduce::kMax);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TILES
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The (queue slot, CTA of the slot's team) grid of K3 and K4, or 0 when it
// does not fit a 1-D grid.
unsigned slot_grid(int num_physical, int max_chunks, int per_slot) {
  const long long grid =
      static_cast<long long>(num_physical) * max_chunks * per_slot;
  return grid <= 0 || grid > INT_MAX ? 0u : static_cast<unsigned>(grid);
}

}  // namespace

// vals: f32 [a_pad] (cols == 1) or [a_pad, cols]; out: [C, L] or [C, L,
// cols].  Returns a cudaError_t code.
extern "C" int chunk_walk_tiles(const float* vals, const int* tids,
                                const int* mask, const int* atom_starts,
                                const int* tile_starts, const int* chunks,
                                const int* counts, int num_physical,
                                int max_chunks, int window, int local_tiles,
                                int cols, int a_pad, int combiner, float* out,
                                cudaStream_t stream) {
  if (cols <= 0 || window <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slice = tile_slice(cols);
  const int team = (window + slice - 1) / slice;
  const unsigned blocks = slot_grid(num_physical, max_chunks, team);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(vals) && aligned16(tids) && aligned16(mask);
  if (cols == 1) {
    return launch_tiles<false>(combiner, dim3(blocks), stream, vals, tids,
                               mask, atom_starts, tile_starts, chunks,
                               counts, max_chunks, window, local_tiles, cols,
                               slice, team, a_pad, vec, out);
  }
  return launch_tiles<true>(
      combiner, dim3(blocks, (cols + kCols - 1) / kCols), stream, vals, tids,
      mask, atom_starts, tile_starts, chunks, counts, max_chunks, window,
      local_tiles, cols, slice, team, a_pad,
      vec && aligned16(out) && cols % 4 == 0, out);
}

extern "C" int chunk_walk_atoms(const float* vals, const int* mask,
                                const int* atom_starts, const int* chunks,
                                const int* counts, int num_physical,
                                int max_chunks, int window, int combiner,
                                float* out, cudaStream_t stream) {
  const int slices = (window + kSlice - 1) / kSlice;
  const unsigned grid = slot_grid(num_physical, max_chunks, slices);
  if (grid == 0 || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_load = aligned16(vals) && aligned16(mask);
  DISPATCH_COMBINER(combiner, chunk_walk_atoms_kernel, grid, kGatherThreads,
                    stream, vals, mask, atom_starts, chunks, counts,
                    max_chunks, window, slices, vec_load, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chunk_walk_compact(const float* vals, const int* idx,
                                  const int* starts, const int* chunks,
                                  const int* counts, int num_physical,
                                  int max_chunks, int window, int combiner,
                                  float* out, cudaStream_t stream) {
  const int slices = (window + kSlice - 1) / kSlice;
  const unsigned grid = slot_grid(num_physical, max_chunks, slices);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH_COMBINER(combiner, chunk_walk_compact_kernel, grid,
                    kGatherThreads, stream, vals, idx, starts, chunks, counts,
                    max_chunks, window, slices, out);
  return static_cast<int>(cudaGetLastError());
}
