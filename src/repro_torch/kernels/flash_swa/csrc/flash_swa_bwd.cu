// The backward of banded causal sliding-window attention on the CUDA
// cores: K7's gradient for float32 inputs (TF32 would round them) and for
// bfloat16 heads of 129-256.  bfloat16 heads up to 128 take the
// tensor-core backward, flash_swa_bwd_mma.cu; the wrapper
// (kernel.py::flash_swa_bwd) routes between the two by dtype and head
// width.
//
// Replaces: the gradient that JAX takes of the reference's banded attention
// (src/repro/models/layers.py, attention(swa_banded=True)); the TPU kernel
// src/repro/kernels/flash_swa/kernel.py::flash_swa has no backward, so the
// port's forward kernels (flash_swa.cu, flash_swa_mma.cu) get these.
//
// q, dq [B, S, H, hd]; k, v, dk, dv [B, S, Hkv, hd] (H % Hkv == 0, query
// head h reads KV head h / (H / Hkv), no repeated copy); out and dout [B,
// S, H, hd]; all float32 or all bfloat16.  lse [B, H, S] float32 is the
// forward's row log-sum-exp.  Query i sees key j iff i - window < j <= i.
// With scale = hd^-1/2 and, for each query row i (all in float32):
//   D_i      = sum_d dout_i,d out_i,d                    (the D pass)
//   P_ij     = exp(scale q_i . k_j - lse_i), 0 outside the band
//   dP_ij    = dout_i . v_j
//   dS_ij    = P_ij (dP_ij - D_i)
//   dq_i     = scale sum_j dS_ij k_j
//   dk_j     = scale sum_{h in the group} sum_i dS_ij q_i
//   dv_j     = sum_{h in the group} sum_i P_ij dout_i
// bfloat16 is converted to float32 on load; every product and sum is
// float32 (expf, fmaf); outputs are rounded to the input type once.
//
// Design (CUDA cores), two kernels on the
// stream, both 256 threads, tiles of R = 64 rows (R = 32 for heads wider
// than 128) held in shared memory as float32 rows of stride ld (hd rounded
// up to 4, padded so that ld / 4 is odd: eight float4 rows of a quarter
// warp hit distinct banks), zero past hd and past S:
// * dq_kernel, one CTA per (R-row query tile, head, batch): first the D
//   pass for its rows (out and dout tiles, a warp a row), written to the
//   D scratch; then it walks the R-row KV tiles of its band, [max(0, q0 -
//   window + 1), q_last], as the forward does.  Thread t computes S and dP
//   for queries (t >> 4) + 16a and keys (t & 15) + 16b (a, b < R / 16:
//   sixteen consecutive key rows a warp, so the float4 loads do not
//   conflict), writes dS^T to shared memory, and then accumulates dq for
//   four consecutive query rows and 4 NJ columns (float4 along hd);
// * dkdv_kernel, one CTA per (R-row KV tile, KV head, batch), launched after
//   dq_kernel (it reads D): for each of the H / Hkv query heads of its KV
//   head, it walks the query tiles whose band holds its keys (queries j <=
//   i < j + window), recomputes P and dS as above, writes P and dS to
//   shared memory, and accumulates dv and dk for four consecutive key rows
//   and 4 NJ columns.  The GQA sum over the group's heads happens inside
//   the CTA, in a fixed order.
// No float atomics: each output element is written by one CTA, after sums
// in a fixed order, so two runs give the same bits.
//
// Bound on the H100: operations.  Per head and (query, key) pair of the
// band, 10 hd useful flop (q.k, dout.v, P^T dout, dS^T q, dS k); dq_kernel
// recomputes q.k and dout.v, so the kernels execute 14 hd.  At Danube's
// training shape (S 8,192, window 4,096, 32 heads of 120) that is 0.97
// TFLOP useful: 0.98 ms at the 989 TFLOP/s bf16 tensor-core peak, 14.5 ms
// at the 67 TFLOP/s float32 CUDA-core peak this kernel can reach.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [row0, row0 + nrows) of a [S, row_stride] matrix (columns 0..hd-1 of
// each row) -> dst [nrows][ld] float32, zero past hd and past S.
template <typename T>
__device__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                          size_t row_stride, int row0, int nrows, int S,
                          int hd, int ld) {
  for (int idx = threadIdx.x; idx < nrows * ld; idx += kThreads) {
    const int r = idx / ld, d = idx % ld;
    const int row = row0 + r;
    float v = 0.0f;
    if (d < hd && row < S) v = to_f32(src[static_cast<size_t>(row) *
                                          row_stride + d]);
    dst[idx] = v;
  }
}

// The tile geometry: R rows a tile, MT = R / 16 rows and keys a thread in
// the score step, KG = R / 4 groups of four rows and CT = 256 / KG column
// threads in the accumulation step, NJ float4 columns of stride 4 CT (so
// 128 columns at R = 64, 256 at R = 32).
template <int R>
struct Tile {
  static constexpr int MT = R / 16;
  static constexpr int KG = R / 4;
  static constexpr int CT = kThreads / KG;
  static constexpr int NJ = 2;
  static constexpr int LDP = R + 4;      // P / dS rows: float4-aligned
};

// s[a][b] = qs[qi(a)] . ks[kj(b)], dp[a][b] = dos[qi(a)] . vs[kj(b)] with
// qi(a) = (t >> 4) + 16 a, kj(b) = (t & 15) + 16 b.
template <int R>
__device__ __forceinline__ void scores(const float* __restrict__ qs,
                                       const float* __restrict__ dos,
                                       const float* __restrict__ ks,
                                       const float* __restrict__ vs, int ld,
                                       int hd, float (&s)[R / 16][R / 16],
                                       float (&dp)[R / 16][R / 16]) {
  constexpr int MT = Tile<R>::MT;
  const int qi0 = threadIdx.x >> 4, kj0 = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < MT; ++a) {
#pragma unroll
    for (int b = 0; b < MT; ++b) s[a][b] = dp[a][b] = 0.0f;
  }
  for (int d = 0; d < hd; d += 4) {     // columns past hd are zero
    float4 qa[MT], oa[MT];
#pragma unroll
    for (int a = 0; a < MT; ++a) {
      qa[a] = ld4(qs + (qi0 + 16 * a) * ld + d);
      oa[a] = ld4(dos + (qi0 + 16 * a) * ld + d);
    }
#pragma unroll
    for (int b = 0; b < MT; ++b) {
      const float4 kb = ld4(ks + (kj0 + 16 * b) * ld + d);
      const float4 vb = ld4(vs + (kj0 + 16 * b) * ld + d);
#pragma unroll
      for (int a = 0; a < MT; ++a) {
        s[a][b] = dot4(qa[a], kb, s[a][b]);
        dp[a][b] = dot4(oa[a], vb, dp[a][b]);
      }
    }
  }
}

// P and scale * dS of the score step's entries; rows q0 + qi, keys kt + kj.
template <int R>
__device__ __forceinline__ void probs(const float (&s)[R / 16][R / 16],
                                      const float (&dp)[R / 16][R / 16],
                                      const float* __restrict__ lse_s,
                                      const float* __restrict__ d_s, int q0,
                                      int kt, int S, int window, float scale,
                                      float (&p)[R / 16][R / 16],
                                      float (&ds)[R / 16][R / 16]) {
  constexpr int MT = Tile<R>::MT;
  const int qi0 = threadIdx.x >> 4, kj0 = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < MT; ++a) {
    const int qi = qi0 + 16 * a, qpos = q0 + qi;
#pragma unroll
    for (int b = 0; b < MT; ++b) {
      const int kpos = kt + kj0 + 16 * b;
      const bool valid = qpos < S && kpos <= qpos && kpos > qpos - window;
      const float pr = valid ? expf(s[a][b] * scale - lse_s[qi]) : 0.0f;
      p[a][b] = pr;
      ds[a][b] = pr * (dp[a][b] - d_s[qi]) * scale;
    }
  }
}

// dq for one (R-row query tile, head, batch); writes D for its rows first.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ out,
          const T* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ dsum, T* __restrict__ dq, int S, int H,
          int Hkv, int hd, int ld, int window, float scale) {
  using G = Tile<R>;
  constexpr int MT = G::MT, CT = G::CT, NJ = G::NJ;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [R][ld]
  float* dos = qs + R * ld;       // [R][ld]
  float* ks = dos + R * ld;       // [R][ld]
  float* vs = ks + R * ld;        // [R][ld]
  float* dst = vs + R * ld;       // [R keys][LDP]: scale * dS^T
  float* lse_s = dst + R * G::LDP;  // [R]
  float* d_s = lse_s + R;           // [R]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(Hkv) * hd;
  const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                       static_cast<size_t>(h) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride +
                        static_cast<size_t>(hk) * hd;
  const size_t row_off = (static_cast<size_t>(b) * H + h) * S;

  // the D pass: out into ks for now, dout into dos (kept)
  load_tile(ks, out + q_off, q_stride, q0, R, S, hd, ld);
  load_tile(dos, dout + q_off, q_stride, q0, R, S, hd, ld);
  load_tile(qs, q + q_off, q_stride, q0, R, S, hd, ld);
  __syncthreads();
  for (int r = warp; r < R; r += kWarps) {
    float acc = 0.0f;
    for (int d = lane; d < hd; d += 32) acc = fmaf(dos[r * ld + d],
                                                   ks[r * ld + d], acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      const int qpos = q0 + r;
      d_s[r] = acc;
      lse_s[r] = qpos < S ? lse[row_off + qpos] : 0.0f;
      if (qpos < S) dsum[row_off + qpos] = acc;
    }
  }

  // dq accumulators: rows 4 rg .. 4 rg + 3, columns 4 ct + 4 CT j (+0..3)
  const int rg = tid / CT, ct = tid % CT;
  float acc[4][NJ][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      acc[r][j][0] = acc[r][j][1] = acc[r][j][2] = acc[r][j][3] = 0.0f;

  const int q_last = min(q0 + R, S) - 1;
  const int lo = max(0, q0 - window + 1);
  for (int kt = (lo / R) * R; kt <= q_last; kt += R) {
    __syncthreads();   // the previous tile's K/V and dS^T are consumed
    load_tile(ks, k + kv_off, kv_stride, kt, R, S, hd, ld);
    load_tile(vs, v + kv_off, kv_stride, kt, R, S, hd, ld);
    __syncthreads();

    float s[MT][MT], dp[MT][MT], p[MT][MT], ds[MT][MT];
    scores<R>(qs, dos, ks, vs, ld, hd, s, dp);
    probs<R>(s, dp, lse_s, d_s, q0, kt, S, window, scale, p, ds);
    const int qi0 = tid >> 4, kj0 = tid & 15;
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int bb = 0; bb < MT; ++bb)
        dst[(kj0 + 16 * bb) * G::LDP + qi0 + 16 * a] = ds[a][bb];
    __syncthreads();

    // dq[r][c] += sum_kj dS[r][kj] k[kj][c]
    for (int kj = 0; kj < R; ++kj) {
      const float4 w = ld4(dst + kj * G::LDP + 4 * rg);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = 4 * ct + 4 * CT * j;
        if (c >= ld) continue;
        const float4 kk = ld4(ks + kj * ld + c);
        const float wr[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][j][0] = fmaf(wr[r], kk.x, acc[r][j][0]);
          acc[r][j][1] = fmaf(wr[r], kk.y, acc[r][j][1]);
          acc[r][j][2] = fmaf(wr[r], kk.z, acc[r][j][2]);
          acc[r][j][3] = fmaf(wr[r], kk.w, acc[r][j][3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + 4 * rg + r;
    if (qpos >= S) continue;
    T* row = dq + q_off + static_cast<size_t>(qpos) * q_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * ct + 4 * CT * j + e;
        if (c < hd) store(row + c, acc[r][j][e]);
      }
    }
  }
}

// dk and dv for one (R-row KV tile, KV head, batch), over the group's query
// heads and the query tiles whose band holds the tile's keys.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            T* __restrict__ dk, T* __restrict__ dv, int S, int H, int Hkv,
            int hd, int ld, int window, float scale) {
  using G = Tile<R>;
  constexpr int MT = G::MT, CT = G::CT, NJ = G::NJ;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [R][ld]
  float* dos = qs + R * ld;       // [R][ld]
  float* ks = dos + R * ld;       // [R][ld]
  float* vs = ks + R * ld;        // [R][ld]
  float* ps = vs + R * ld;        // [R queries][LDP]: P
  float* dss = ps + R * G::LDP;   // [R queries][LDP]: scale * dS
  float* lse_s = dss + R * G::LDP;  // [R]
  float* d_s = lse_s + R;           // [R]

  const int tid = threadIdx.x;
  const int kt = blockIdx.x * R, hk = blockIdx.y, b = blockIdx.z;
  const int groups = H / Hkv;
  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(Hkv) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride +
                        static_cast<size_t>(hk) * hd;

  load_tile(ks, k + kv_off, kv_stride, kt, R, S, hd, ld);
  load_tile(vs, v + kv_off, kv_stride, kt, R, S, hd, ld);

  // accumulators: keys 4 rg .. 4 rg + 3, columns 4 ct + 4 CT j (+0..3)
  const int rg = tid / CT, ct = tid % CT;
  float adk[4][NJ][4], adv[4][NJ][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[r][j][e] = adv[r][j][e] = 0.0f;

  // queries i with kt <= i <= min(S - 1, kt + R - 1 + window - 1)
  const int q_end = min(S - 1, kt + R - 1 + window - 1);
  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                         static_cast<size_t>(h) * hd;
    const size_t row_off = (static_cast<size_t>(b) * H + h) * S;
    for (int q0 = kt; q0 <= q_end; q0 += R) {
      __syncthreads();   // the previous tile's Q/dout and P/dS are consumed
      load_tile(qs, q + q_off, q_stride, q0, R, S, hd, ld);
      load_tile(dos, dout + q_off, q_stride, q0, R, S, hd, ld);
      for (int r = tid; r < R; r += kThreads) {
        const int qpos = q0 + r;
        lse_s[r] = qpos < S ? lse[row_off + qpos] : 0.0f;
        d_s[r] = qpos < S ? dsum[row_off + qpos] : 0.0f;
      }
      __syncthreads();

      float s[MT][MT], dp[MT][MT], p[MT][MT], ds[MT][MT];
      scores<R>(qs, dos, ks, vs, ld, hd, s, dp);
      probs<R>(s, dp, lse_s, d_s, q0, kt, S, window, scale, p, ds);
      const int qi0 = tid >> 4, kj0 = tid & 15;
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int bb = 0; bb < MT; ++bb) {
          ps[(qi0 + 16 * a) * G::LDP + kj0 + 16 * bb] = p[a][bb];
          dss[(qi0 + 16 * a) * G::LDP + kj0 + 16 * bb] = ds[a][bb];
        }
      __syncthreads();

      // dv[r][c] += sum_qi P[qi][r] dout[qi][c]; dk likewise with dS, q
      for (int qi = 0; qi < R; ++qi) {
        const float4 pw = ld4(ps + qi * G::LDP + 4 * rg);
        const float4 sw = ld4(dss + qi * G::LDP + 4 * rg);
        const float pr[4] = {pw.x, pw.y, pw.z, pw.w};
        const float sr[4] = {sw.x, sw.y, sw.z, sw.w};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = 4 * ct + 4 * CT * j;
          if (c >= ld) continue;
          const float4 o = ld4(dos + qi * ld + c);
          const float4 x = ld4(qs + qi * ld + c);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            adv[r][j][0] = fmaf(pr[r], o.x, adv[r][j][0]);
            adv[r][j][1] = fmaf(pr[r], o.y, adv[r][j][1]);
            adv[r][j][2] = fmaf(pr[r], o.z, adv[r][j][2]);
            adv[r][j][3] = fmaf(pr[r], o.w, adv[r][j][3]);
            adk[r][j][0] = fmaf(sr[r], x.x, adk[r][j][0]);
            adk[r][j][1] = fmaf(sr[r], x.y, adk[r][j][1]);
            adk[r][j][2] = fmaf(sr[r], x.z, adk[r][j][2]);
            adk[r][j][3] = fmaf(sr[r], x.w, adk[r][j][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kpos = kt + 4 * rg + r;
    if (kpos >= S) continue;
    const size_t off = kv_off + static_cast<size_t>(kpos) * kv_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * ct + 4 * CT * j + e;
        if (c < hd) {
          store(dk + off + c, adk[r][j][e]);
          store(dv + off + c, adv[r][j][e]);
        }
      }
    }
  }
}

// float stride of a shared-memory row: hd rounded up to 4, then padded so
// that the stride in float4 units is odd.
int row_stride(int hd) {
  int ld = (hd + 3) / 4 * 4;
  return (ld / 4) % 2 == 1 ? ld : ld + 4;
}

template <typename F>
cudaError_t allow_smem(F* kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int R>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int B, int S, int H, int Hkv, int hd,
           int window, float scale, cudaStream_t stream) {
  using G = Tile<R>;
  const int ld = row_stride(hd);
  // both kernels: four [R][ld] tiles, two [R][LDP] (dq uses one), lse, D
  const size_t smem = (static_cast<size_t>(4 * R * ld + 2 * R * G::LDP +
                                           2 * R)) * sizeof(float);
  auto kq = dq_kernel<T, R>;
  auto kkv = dkdv_kernel<T, R>;
  cudaError_t err = allow_smem(kq, smem);
  if (err == cudaSuccess) err = allow_smem(kkv, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + R - 1) / R;
  kq<<<dim3(tiles, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(out),
      static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dq), S, H, Hkv,
      hd, ld, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kkv<<<dim3(tiles, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, Hkv, hd, ld, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_width(const void* q, const void* k, const void* v,
                 const void* out, const void* dout, const float* lse,
                 float* dsum, void* dq, void* dk, void* dv, int B, int S,
                 int H, int Hkv, int hd, int window, float scale,
                 cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    // bf16 heads up to 128 take the tensor-core kernels (kernel.py)
    if (hd <= 128) return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (hd <= 128)
      return launch<T, 64>(q, k, v, out, dout, lse, dsum, dq, dk, dv, B, S,
                           H, Hkv, hd, window, scale, stream);
  }
  if (hd <= 256)
    return launch<T, 32>(q, k, v, out, dout, lse, dsum, dq, dk, dv, B, S, H,
                         Hkv, hd, window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  dsum: float32 [B, H, S] scratch
// (D, written by the first kernel, read by the second).  Returns a
// cudaError_t code.
extern "C" int flash_swa_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const float* lse, float* dsum, void* dq,
                             void* dk, void* dv, int dtype, int B, int S,
                             int H, int Hkv, int hd, int window, float scale,
                             cudaStream_t stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || hd <= 0 || window <= 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_width<float>(q, k, v, out, dout, lse, dsum, dq, dk, dv, B,
                               S, H, Hkv, hd, window, scale, stream);
  if (dtype == 1)
    return launch_width<__nv_bfloat16>(q, k, v, out, dout, lse, dsum, dq, dk,
                                       dv, B, S, H, Hkv, hd, window, scale,
                                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
