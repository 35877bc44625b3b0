// Ordered segment sums: out[s] = the sum of the items of segment s, added
// in the order of the items; +0.0 for an empty segment.  Two entries share
// one kernel:
//
// * segment_sum_sorted: the items come sorted by segment (int32 keys,
//   non-decreasing, in [0, num_segments)) with their value rows
//   vals[order[i]] (order int64: the indices of the stable sort that gave
//   the keys; kept as int32 in shared memory).  core.segops.ordered_sum
//   sorts and calls it.
// * segment_sum_fixup: core.execute.fixup_partials without a sort.  Chunk
//   c's partials [L, B] sit at tiles tile_starts[c] + l (l < L); a bin at
//   or past num_tiles is dropped.  The sorted route would sort those tile
//   ids with a stable sort, which leaves the items of tile t in ascending
//   chunk order.  For non-decreasing tile_starts the chunks that reach
//   tile t are [lo(t), hi(t)) with lo(t) = #{c : tile_starts[c] <= t - L},
//   hi(t) = #{c : tile_starts[c] <= t}, and the items of tiles before t
//   number off(t) = sum_c clamp(t - tile_starts[c], 0, L) = L lo(t) +
//   (hi(t) - lo(t)) t - (S[hi(t)] - S[lo(t)]), S the prefix sums of
//   tile_starts.  Item j of tile t is chunk lo(t) + j at bin t -
//   tile_starts[lo(t) + j].  Tile t's first path item sits at Pos(t) =
//   off(t) + t, which is linear in t between two chunk events (a chunk's
//   first tile, or the tile L after it).  A first kernel writes S and
//   each chunk's two event positions; the tile at diagonal d is then the
//   largest t with Pos(t) <= d: two binary searches over the event
//   positions give hi(t) and lo(t), and the line between the events t.
//   So the kernel walks the sorted route's merge path itself, with the
//   same tile cuts and the same additions, and gives its bits at every
//   width, with no sort, no keys and no order.
//
// Port glue, not a port of a TPU kernel: the JAX package's segment sums
// (XLA's scatter-add on the TPU, src/repro/core/segops.py segment_sum and
// the fixup_partials of src/repro/core/execute.py) give the same bits on
// every run; index_add_ on the card adds in atomic order, which differs
// from run to run wherever a segment has more than two addends.
//
// Values: [*, cols] row-major, float32 or float64; out [num_segments,
// cols].  Column j has the bits of the call on column j alone.
//
// Bound on the H100: bytes.  The sorted entry reads keys, order and the
// values once and writes each segment once; the fixup reads tile_starts,
// the partials of the bins before num_tiles and writes each tile once.
// One add per item and column.
//
// Design: K1's merge path (merge_path.cu) with the segments as rows and
// the items as non-zeros.  A CTA takes a tile of kTile path items and a
// group of up to kGroup columns.  A small kernel first finds every tile's
// first item, one thread a cut (a binary search of the sorted keys, or of
// the fixup's event positions), so a CTA starts from two loads; it then
// lays out the tile in shared memory once for all its columns: the items'
// value rows (the order, or for the fixup each item's chunk and bin), and
// for each of its threads the path items it walks as a bitmask (item or
// segment end).  The columns go in passes of kPassBytes of a row (one
// 32-byte sector: 8 float32 columns), each pass's rows gathered by
// cp.async (16-byte pieces where the row allows, else one value a copy;
// lanes take (item, piece) pairs, piece fastest) into a two-stage ring,
// so that the next pass's gathers overlap this pass's adds.  The adds of
// every pass and column are those of the one-column sum: a thread walks
// kItems path items, adding a value or ending a segment; a segment that
// starts and ends in the thread is finished directly, the first one it
// ends takes its carry-in from a CTA-wide segmented scan (all the pass's
// columns in one scan, on one key), and the one open at the tile's end
// goes out as a carry that segreduce::add_carries_kernel adds in.  The
// pass's finished segments go to shared memory first and out as whole
// rows of the pass (lanes take (segment, piece) pairs): written from the
// threads, B scattered 4-byte stores a segment cost more than the
// gathers.  Shared rows keep their two 16-byte pieces swapped on every
// other four rows, against bank conflicts.  Empty segments are path items
// like any other, so long gaps are spread over the tiles too.  No
// atomics: every segment is written once by the first kernel (and once
// more by the carry kernel where it crosses tiles), in a fixed order.
#include <cstdint>
#include <type_traits>

#include "segreduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                       // path items per thread
constexpr int kTile = kThreads * kItems;        // path items per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;                      // columns per CTA
constexpr int kPassBytes = 32;                  // of a value row per pass
constexpr int kOneColumnBlocks = 8;             // CTAs an SM: one column
constexpr int kColumnBlocks = 3;                // CTAs an SM: B columns
constexpr int kCoordThreads = 256;

using segreduce::kCarryThreads;

// Shared memory: the items' value rows; then the sorted keys (or the
// fixup's items before each tile, and its first chunk of each tile),
// which the pass loop reuses for its finished rows; then the value ring.
template <typename T, int NC>
struct Smem {
  static constexpr int kIndex = (2 * kTile + 3) * 4;
  static constexpr int kOut = kTile * NC * static_cast<int>(sizeof(T));
  static constexpr int kSrc = kTile * 4;
  static constexpr int kRing =
      kSrc + ((kIndex > kOut ? kIndex : kOut) + 15) / 16 * 16;
  static size_t bytes(int stages) {
    return kRing + static_cast<size_t>(stages) * kTile * NC * sizeof(T);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(kBytes) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <typename T>
using Vec16 = typename std::conditional<sizeof(T) == 4, float4,
                                        double2>::type;

template <typename T>
struct Args {
  const T* vals;           // [*, cols]
  T* out;                  // [num_segments, cols]
  int* carry_row;          // [grid]
  T* carry_val;            // [grid, cols]
  int num_segments;
  int cols;
  int groups;              // column groups: CTAs a tile
  int stages;              // value ring stages (1 or 2)
  int vec;                 // 16-byte copies (cols and vals allow them)
  const int* coords;       // the tile cuts: [grid + 1] (sorted) or
                           // [grid + 1, 3] (fixup), tile_coords_kernel's
  // sorted entry
  const int* keys;         // [n]
  const long long* order;  // [n]
  int n;
  // fixup entry
  const int* tile_starts;  // [chunks + 1], non-decreasing
  const long long* prefix; // [chunks + 1]: S[c] = sum of tile_starts[:c]
  const int* events;       // [2, chunks]: Pos(ts[c]), Pos(ts[c] + L)
  const int* num_items;    // [1]: off(num_segments)
  int chunks;
  int local_tiles;
};

// #{c in [a, b) : ts[c] <= x} + a (for ts[c] <= x on every c < a and on
// none from b on)
__device__ __forceinline__ int count_le(const int* __restrict__ ts, int a,
                                        int b, long long x) {
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (__ldg(ts + mid) <= x) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  return a;
}

// off(t) of the fixup from hi = hi(t) and lo = lo(t) (a chunk that starts
// on t adds t - ts[c] = 0, so hi(t) serves for #{c : ts[c] < t}).  Plain
// loads: the events kernel reads the prefix sums it wrote itself.
__device__ __forceinline__ long long fixup_off(const long long* prefix,
                                               int local_tiles, int t,
                                               int hi, int lo) {
  return static_cast<long long>(local_tiles) * lo +
         static_cast<long long>(hi - lo) * t - (prefix[hi] - prefix[lo]);
}

// The fixup's tile at diagonal d: the largest t <= num_segments with
// Pos(t) <= d, which is also the segment ends before d.  hi = #{c :
// Pos(ts[c]) <= d} and lo = #{c : Pos(ts[c] + L) <= d} are hi(t) and
// lo(t), so Pos is the line K0 + (hi - lo + 1) t up to the next event.
template <typename T>
__device__ int fixup_tile_at(const Args<T>& a, int d, int hi, int lo) {
  const long long k0 =
      static_cast<long long>(a.local_tiles) * lo -
      (__ldg(a.prefix + hi) - __ldg(a.prefix + lo));
  long long t = (d - k0) / (hi - lo + 1);
  long long cap = a.num_segments;
  if (hi < a.chunks) cap = min(cap, __ldg(a.tile_starts + hi) - 1LL);
  if (lo < a.chunks) {
    cap = min(cap, __ldg(a.tile_starts + lo) +
                       static_cast<long long>(a.local_tiles) - 1);
  }
  return static_cast<int>(t < cap ? t : cap);
}

// Rows of NC values in shared memory (the value ring, the finished rows).
// A thread's items and segments lie about two rows apart from the next
// thread's, so with two 16-byte pieces a row, row r keeps its pieces
// swapped where bit 2 of r is set: a quarter warp's 16-byte accesses then
// meet two ways at most in a bank, not four.
template <typename T, int NC>
struct Rows {
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  static constexpr int kPieces = NC * static_cast<int>(sizeof(T)) / 16;
  // the place of value e of row r
  static __device__ __forceinline__ int at(int r, int e) {
    if constexpr (kPieces == 2) {
      return r * NC + (((e / kPer) ^ ((r >> 2) & 1)) * kPer) + e % kPer;
    } else {
      return r * NC + e;
    }
  }
  static __device__ __forceinline__ void load(const T* base, int r,
                                              T (&v)[NC]) {
    if constexpr (kPieces >= 1) {
#pragma unroll
      for (int k = 0; k < kPieces; ++k) {
        const Vec16<T> w =
            *reinterpret_cast<const Vec16<T>*>(base + at(r, k * kPer));
        const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
        for (int i = 0; i < kPer; ++i) v[k * kPer + i] = e[i];
      }
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) v[c] = base[r * NC + c];
    }
  }
  static __device__ __forceinline__ void store(T* base, int r,
                                               const T (&v)[NC]) {
    if constexpr (kPieces >= 1) {
#pragma unroll
      for (int k = 0; k < kPieces; ++k) {
        Vec16<T> w;
        T* e = reinterpret_cast<T*>(&w);
#pragma unroll
        for (int i = 0; i < kPer; ++i) e[i] = v[k * kPer + i];
        *reinterpret_cast<Vec16<T>*>(base + at(r, k * kPer)) = w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) base[r * NC + c] = v[c];
    }
  }
};

template <typename T, int NC, bool kFixup>
__global__ void __launch_bounds__(kThreads, NC == 1 ? kOneColumnBlocks
                                                   : kColumnBlocks)
segsum_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using S = Smem<T, NC>;
  int* s_src = reinterpret_cast<int*>(smem);     // the items' value rows
  int* s_a = s_src + kTile;                       // keys / items before
  int* s_b = s_a + kTile + 2;                     // first chunk of a tile
  T* s_out = reinterpret_cast<T*>(s_a);           // a pass's finished rows
  T* s_val = reinterpret_cast<T*>(smem + S::kRing);  // [stages][kTile][NC]
  __shared__ int s_wkey[kWarps];
  __shared__ T s_wval[kWarps][NC];
  __shared__ T s_last[kWarps][NC];

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = static_cast<int>(blockIdx.x) / a.groups;
  const int group = static_cast<int>(blockIdx.x) % a.groups;
  const int cols = a.cols;
  const int c0 = group * kGroup;
  const int c_end = cols - c0 > kGroup ? c0 + kGroup : cols;
  const int segs = a.num_segments;
  const int total = segs + (kFixup ? __ldg(a.num_items) : a.n);
  const int d0 = tile * kTile;
  if (d0 >= total) {
    // past the path (the fixup's grid is a bound): an empty carry
    if (tid == 0 && group == 0) a.carry_row[tile] = segs;
    if (c0 + tid < c_end) {
      a.carry_val[static_cast<long long>(tile) * cols + c0 + tid] = T(0);
    }
    return;
  }
  const int d1 = total - d0 > kTile ? d0 + kTile : total;

  // -- the tile's first and last item (tile_coords_kernel's cuts) --
  constexpr int kW = kFixup ? 3 : 1;
  const int r0 = __ldg(a.coords + kW * tile);    // the tile's first segment
  const int r1 = __ldg(a.coords + kW * (tile + 1));  // open at its end
  const int j0 = d0 - r0;                        // its first item
  const int tile_items = d1 - r1 - j0;

  // -- the tile's items in shared memory --
  if constexpr (kFixup) {
    // off and lo of tiles r0 .. r1, searched between their values at the
    // tile's two ends; past r1 a sentinel (every later path item there
    // is an item of r1)
    const int nseg = r1 - r0 + 1;
    const int hi_a = __ldg(a.coords + 3 * tile + 1);
    const int lo_a = __ldg(a.coords + 3 * tile + 2);
    const int hi_b = __ldg(a.coords + 3 * tile + 4);
    const int lo_b = __ldg(a.coords + 3 * tile + 5);
    for (int k = tid; k <= nseg; k += kThreads) {
      const int t = r0 + k;                      // t <= r1 <= segs
      if (k == nseg) {
        s_a[k] = INT_MAX;
        continue;
      }
      const int hi = count_le(a.tile_starts, hi_a, hi_b, t);
      const int lo = count_le(a.tile_starts, lo_a, lo_b,
                              static_cast<long long>(t) - a.local_tiles);
      s_a[k] = static_cast<int>(fixup_off(a.prefix, a.local_tiles, t, hi,
                                          lo));
      s_b[k] = lo;
    }
  } else {
    // the sorted keys (a sentinel past the last: every later path item
    // there is a segment end) and the value rows; read once with one
    // column group (evict first) and by every group's CTA otherwise
    const bool once = a.groups == 1;
    for (int i = tid; i <= tile_items; i += kThreads) {
      s_a[i] = i == tile_items ? INT_MAX
               : once          ? __ldcs(a.keys + j0 + i)
                               : __ldg(a.keys + j0 + i);
      if (i < tile_items) {              // int32 here: n fits
        s_src[i] = static_cast<int>(once ? __ldcs(a.order + j0 + i)
                                         : __ldg(a.order + j0 + i));
      }
    }
  }
  __syncthreads();

  // -- the thread's kItems path items: where they start, and which are
  // items (a bitmask); the fixup also writes their value rows --
  const int span = d1 - d0;
  const int t0 = tid * kItems < span ? tid * kItems : span;
  const int t1 = t0 + kItems < span ? t0 + kItems : span;
  int q0, seg0;                                  // tile-local item, segment
  {
    int lo = 0;
    if constexpr (kFixup) {                      // segment ends before t0
      int hi = t0 < r1 - r0 ? t0 : r1 - r0;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_a[mid + 1] + r0 + mid < d0 + t0) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      seg0 = r0 + lo;
      q0 = t0 - lo;
    } else {                                     // items before t0
      int hi = t0 < tile_items ? t0 : tile_items;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_a[mid] + j0 + mid < d0 + t0) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      q0 = lo;
      seg0 = r0 + t0 - lo;
    }
  }
  unsigned mask = 0;
  {
    int q = q0, seg = seg0;
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
      if (t0 + s < t1) {
        bool item;
        if constexpr (kFixup) {
          const int k = seg - r0;
          item = j0 + q < s_a[k + 1];
          if (item) {
            const int c = s_b[k] + (j0 + q - s_a[k]);
            s_src[q] = c * a.local_tiles + (seg - __ldg(a.tile_starts + c));
          }
        } else {
          item = s_a[q] == seg;
        }
        if (item) {
          mask |= 1u << s;
          ++q;
        } else {
          ++seg;
        }
      }
    }
  }
  __syncthreads();               // s_src complete; s_a, s_b free for s_out

  // -- the columns, a pass of NC at a time, gathered a pass ahead --
  using R = Rows<T, NC>;
  const int passes = (c_end - c0 + NC - 1) / NC;
  const int rows = r1 - r0;                      // segments ending here
  const T* __restrict__ vals = a.vals;
  auto gather = [&](int p) {
    const int col = c0 + p * NC;
    const int nc = c_end - col < NC ? c_end - col : NC;
    T* dst = s_val + (p % a.stages) * (kTile * NC);
    if (R::kPieces >= 1 && a.vec) {
      const int pieces = nc / R::kPer;
      for (int u = tid; u < tile_items * pieces; u += kThreads) {
        const int q = u / pieces;
        const int k = u - q * pieces;
        cp_async<16>(dst + R::at(q, k * R::kPer),
                     vals + static_cast<long long>(s_src[q]) * cols + col +
                         k * R::kPer);
      }
    } else {
      for (int u = tid; u < tile_items * nc; u += kThreads) {
        const int q = u / nc;
        const int k = u - q * nc;
        cp_async<sizeof(T)>(dst + R::at(q, k),
                            vals + static_cast<long long>(s_src[q]) * cols +
                                col + k);
      }
    }
    cp_async_commit();
  };

  gather(0);
  for (int p = 0; p < passes; ++p) {
    if (p + 1 < passes) {
      gather(p + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sv = s_val + (p % a.stages) * (kTile * NC);
    const int col = c0 + p * NC;
    const int nc = c_end - col < NC ? c_end - col : NC;

    T acc[NC], head[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c] = T(0);
      head[c] = T(0);
    }
    bool ended = false;
    int q = q0, seg = seg0;
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
      if (t0 + s < t1) {
        if ((mask >> s) & 1u) {
          T v[NC];
          R::load(sv, q, v);
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[c] += v[c];
          ++q;
        } else {
          if (ended) {
            T done[NC];
#pragma unroll
            for (int c = 0; c < NC; ++c) done[c] = T(0) + acc[c];
            R::store(s_out, seg - r0, done);
          } else {
#pragma unroll
            for (int c = 0; c < NC; ++c) head[c] = acc[c];
            ended = true;
          }
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[c] = T(0);
          ++seg;
        }
      }
    }

    // -- the first segment each thread ends, with its carry-in (the
    // inclusive scan of the thread before); the tile's carry --
    segreduce::block_seg_sum_cols<kThreads, NC, T>(seg, acc, s_wkey, s_wval);
    if (lane == 31) {
#pragma unroll
      for (int c = 0; c < NC; ++c) s_last[warp][c] = acc[c];
    }
    __syncthreads();
    T first[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const T up = __shfl_up_sync(0xffffffffu, acc[c], 1);
      const T carry_in = lane > 0 ? up
                         : warp > 0 ? s_last[warp - 1][c]
                                    : T(0);
      first[c] = T(0) + (carry_in + head[c]);
    }
    if (ended) R::store(s_out, seg0 - r0, first);
    if (tid == kThreads - 1) {
      if (group == 0 && p == 0) a.carry_row[tile] = seg;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nc) {
          a.carry_val[static_cast<long long>(tile) * cols + col + c] = acc[c];
        }
      }
    }
    __syncthreads();

    // -- the pass's finished rows, [rows, nc] of out --
    T* out = a.out + static_cast<long long>(r0) * cols + col;
    if (R::kPieces >= 1 && a.vec) {
      const int pieces = nc / R::kPer;
      for (int u = tid; u < rows * pieces; u += kThreads) {
        const int r = u / pieces;
        const int k = u - r * pieces;
        *reinterpret_cast<Vec16<T>*>(out + static_cast<long long>(r) * cols +
                                     k * R::kPer) =
            *reinterpret_cast<const Vec16<T>*>(s_out + R::at(r, k * R::kPer));
      }
    } else {
      for (int u = tid; u < rows * nc; u += kThreads) {
        const int r = u / nc;
        const int k = u - r * nc;
        out[static_cast<long long>(r) * cols + k] = s_out[R::at(r, k)];
      }
    }
    __syncthreads();              // the stage, s_out and the scan free
  }
}

// The fixup's chunk events, one CTA: S[c] = ts[0] + ... + ts[c - 1] for c
// in [0, chunks]; then Pos(ts[c]) and Pos(ts[c] + L) for every chunk
// (INT_MAX where ts[c] + L is past num_tiles), Pos(t) = off(t) + t; then
// the item count off(num_tiles).
constexpr int kEventThreads = 1024;

__global__ void __launch_bounds__(kEventThreads)
fixup_events_kernel(const int* __restrict__ ts, int chunks, int local_tiles,
                    int num_tiles, long long* __restrict__ prefix,
                    int* __restrict__ events, int* __restrict__ num_items) {
  __shared__ long long s_warp[kEventThreads / 32];
  const unsigned full = 0xffffffffu;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  long long running = 0;
  for (int base = 0; base < chunks; base += kEventThreads) {
    const int i = base + tid;
    const long long v = i < chunks ? ts[i] : 0;
    long long x = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long up = __shfl_up_sync(full, x, off);
      if (lane >= off) x += up;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long w = s_warp[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const long long up = __shfl_up_sync(full, w, off);
        if (lane >= off) w += up;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    if (warp > 0) x += s_warp[warp - 1];
    if (i < chunks) prefix[i] = running + x - v;
    running += s_warp[kEventThreads / 32 - 1];
    __syncthreads();
  }
  if (tid == 0) prefix[chunks] = running;
  __syncthreads();
  // Pos(t) = off(t) + t for a chunk's two event tiles (t <= num_tiles),
  // hi and lo of both found by four binary searches in lockstep
  auto pos2 = [&](long long t0, long long t1, int* out0, int* out1) {
    const long long x[4] = {t0, t0 - local_tiles, t1, t1 - local_tiles};
    int lo[4] = {0, 0, 0, 0}, hi[4] = {chunks, chunks, chunks, chunks};
    for (int width = chunks; width > 0; width >>= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (lo[j] < hi[j]) {
          const int mid = (lo[j] + hi[j]) >> 1;
          if (ts[mid] <= x[j]) {
            lo[j] = mid + 1;
          } else {
            hi[j] = mid;
          }
        }
      }
    }
    *out0 = static_cast<int>(
        fixup_off(prefix, local_tiles, static_cast<int>(t0), lo[0], lo[1]) +
        t0);
    *out1 = static_cast<int>(
        fixup_off(prefix, local_tiles, static_cast<int>(t1), lo[2], lo[3]) +
        t1);
  };
  for (int c = tid; c < chunks; c += kEventThreads) {
    const long long start = ts[c];
    const long long stop = start + local_tiles;
    int at_start, at_stop;
    pos2(start, stop <= num_tiles ? stop : start, &at_start, &at_stop);
    events[c] = at_start;
    events[chunks + c] = stop <= num_tiles ? at_stop : INT_MAX;
  }
  if (tid == 0) {
    int at_end, unused;
    pos2(num_tiles, num_tiles, &at_end, &unused);
    *num_items = at_end - num_tiles;
  }
}

// The tile cuts, one thread a cut k in [0, grid]: at diagonal d = min(k
// kTile, total), the segment ends before d (the sorted entry: a binary
// search of the keys), or for the fixup the largest tile t with Pos(t) <=
// d and hi(t), lo(t) (binary searches of the chunk events).
template <typename T, bool kFixup>
__global__ void __launch_bounds__(kCoordThreads)
tile_coords_kernel(const Args<T> a, int grid, int* __restrict__ coords) {
  const int k = static_cast<int>(blockIdx.x) * kCoordThreads +
                static_cast<int>(threadIdx.x);
  if (k > grid) return;
  const int segs = a.num_segments;
  const int total = segs + (kFixup ? __ldg(a.num_items) : a.n);
  const long long kd = static_cast<long long>(k) * kTile;
  const int d = kd < total ? static_cast<int>(kd) : total;
  if constexpr (kFixup) {
    int bounds[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {                // #{c : event e of c <= d}
      const int* pos = a.events + e * a.chunks;
      int lo = 0, hi = a.chunks;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(pos + mid) <= d) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      bounds[e] = lo;
    }
    coords[3 * k] = fixup_tile_at(a, d, bounds[0], bounds[1]);
    coords[3 * k + 1] = bounds[0];
    coords[3 * k + 2] = bounds[1];
  } else {                                       // items before d
    int lo = 0, hi = d < a.n ? d : a.n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(a.keys + mid) + mid < d) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    coords[k] = d - lo;
  }
}

template <typename T, int NC, bool kFixup>
int launch_tiles(const Args<T>& a, int grid, cudaStream_t stream) {
  const size_t smem = Smem<T, NC>::bytes(a.stages);
  auto kernel = segsum_kernel<T, NC, kFixup>;
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  kernel<<<grid * a.groups, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kFixup>
int launch(Args<T> a, int grid, cudaStream_t stream) {
  constexpr int kNC = kPassBytes / static_cast<int>(sizeof(T));
  a.groups = (a.cols + kGroup - 1) / kGroup;
  if (static_cast<long long>(grid) * a.groups >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tile_coords_kernel<T, kFixup>
      <<<grid / kCoordThreads + 1, kCoordThreads, 0, stream>>>(
          a, grid, const_cast<int*>(a.coords));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (a.cols == 1) {
    a.stages = 1;
    a.vec = 0;
    err = launch_tiles<T, 1, kFixup>(a, grid, stream);
  } else {
    const int width = a.cols < kGroup ? a.cols : kGroup;
    a.stages = width > kNC ? 2 : 1;
    a.vec = a.cols % (16 / static_cast<int>(sizeof(T))) == 0 &&
            reinterpret_cast<uintptr_t>(a.vals) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
    err = launch_tiles<T, kNC, kFixup>(a, grid, stream);
  }
  if (err != 0) return err;
  const int carry_grid = (grid + kCarryThreads - 1) / kCarryThreads;
  segreduce::add_carries_kernel<T>
      <<<carry_grid * a.cols, kCarryThreads, 0, stream>>>(
          a.carry_row, a.carry_val, grid, a.num_segments, a.cols, a.out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Args<T> common(const void* vals, int num_segments, int cols, int* carry_row,
               void* carry_val, void* out) {
  Args<T> a{};
  a.vals = static_cast<const T*>(vals);
  a.out = static_cast<T*>(out);
  a.carry_row = carry_row;
  a.carry_val = static_cast<T*>(carry_val);
  a.num_segments = num_segments;
  a.cols = cols;
  return a;
}

}  // namespace

extern "C" int segment_sum_tile() { return kTile; }

// dtype codes: 0 = float32, 1 = float64.  keys: int32 [n], sorted.  order:
// int64 [n].  vals: [*, cols].  carry_row: int32
// scratch of G = ceil((num_segments + n) / kTile) entries; coords: int32
// scratch of 3 (G + 1); carry_val: dtype scratch of G * cols.  out:
// [num_segments, cols], written in full.  Returns a cudaError_t code.
extern "C" int segment_sum_sorted(const int* keys, const long long* order,
                                  const void* vals, int dtype,
                                  int n, int num_segments, int cols,
                                  int* carry_row, int* coords,
                                  void* carry_val, void* out,
                                  cudaStream_t stream) {
  const long long total = static_cast<long long>(num_segments) + n;
  if (n < 0 || num_segments <= 0 || cols <= 0 || total >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = static_cast<int>((total + kTile - 1) / kTile);
  if (dtype == 0 || dtype == 1) {
    if (dtype == 0) {
      Args<float> a = common<float>(vals, num_segments, cols, carry_row,
                                    carry_val, out);
      a.coords = coords;
      a.keys = keys;
      a.order = order;
      a.n = n;
      return launch<float, false>(a, grid, stream);
    }
    Args<double> a = common<double>(vals, num_segments, cols, carry_row,
                                    carry_val, out);
    a.coords = coords;
    a.keys = keys;
    a.order = order;
    a.n = n;
    return launch<double, false>(a, grid, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// partials: [chunks, local_tiles, cols] (dtype codes as above).
// tile_starts: int32 [chunks + 1], non-decreasing.  prefix: int64 scratch
// of chunks + 1; events: int32 scratch of 2 * chunks; num_items: int32
// scratch of 1.  carry_row / coords / carry_val: as above with G =
// ceil((chunks * local_tiles + num_tiles) / kTile).  out: [num_tiles,
// cols], written in full.  Returns a cudaError_t code.
extern "C" int segment_sum_fixup(const void* partials, int dtype,
                                 const int* tile_starts, int chunks,
                                 int local_tiles, int num_tiles, int cols,
                                 long long* prefix, int* events,
                                 int* num_items, int* carry_row, int* coords,
                                 void* carry_val, void* out,
                                 cudaStream_t stream) {
  const long long total =
      static_cast<long long>(chunks) * local_tiles + num_tiles;
  if (chunks < 0 || local_tiles <= 0 || num_tiles <= 0 || cols <= 0 ||
      total >= INT_MAX || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fixup_events_kernel<<<1, kEventThreads, 0, stream>>>(
      tile_starts, chunks, local_tiles, num_tiles, prefix, events,
      num_items);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>((total + kTile - 1) / kTile);
  if (dtype == 0) {
    Args<float> a = common<float>(partials, num_tiles, cols, carry_row,
                                  carry_val, out);
    a.coords = coords;
    a.tile_starts = tile_starts;
    a.prefix = prefix;
    a.events = events;
    a.num_items = num_items;
    a.chunks = chunks;
    a.local_tiles = local_tiles;
    return launch<float, true>(a, grid, stream);
  }
  Args<double> a = common<double>(partials, num_tiles, cols, carry_row,
                                  carry_val, out);
  a.coords = coords;
  a.tile_starts = tile_starts;
  a.prefix = prefix;
  a.events = events;
  a.num_items = num_items;
  a.chunks = chunks;
  a.local_tiles = local_tiles;
  return launch<double, true>(a, grid, stream);
}
