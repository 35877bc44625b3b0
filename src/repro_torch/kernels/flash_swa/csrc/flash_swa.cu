// Banded causal sliding-window attention with an online softmax: K7.
//
// Replaces: src/repro/kernels/flash_swa/kernel.py::flash_swa
// (_flash_swa_kernel).
//
// q [B, S, H, hd], k/v [B, S, Hkv, hd] (H % Hkv == 0, query head h reads KV
// head h / (H / Hkv); no repeated copy of k/v), all float32 or all
// bfloat16; out [B, S, H, hd] in the same type.  Positions are 0..S-1.  For
// each query row i:
//   scores_j = (q_i . k_j) * scale, masked to -1e30 unless
//              j <= i and j > i - window;
//   out_i = sum_j exp(scores_j - m) v_j / max(sum_j exp(scores_j - m), 1e-30)
// with the running max m and normaliser carried across KV tiles, as the
// reference does (including its -1e30 fill: a row that a tile masks
// completely gets weight exp(0) there, which the next tile's correction
// exp(-1e30 - m) cancels; every row sees itself, so every row has a later
// valid score).  bfloat16 is converted to float32 on load; every product
// and sum is float32 (expf, not __expf).
//
// Design (a simple kernel, CUDA cores only): one CTA of 256 threads per
// (64-row query tile, head, batch).  It walks only the 64-row KV tiles that
// intersect the tile's band, [max(0, q0 - window + 1), q_last]; the TPU
// grid's clamped tiles (kernel.py:94) do not exist here.  Q, K and V tiles
// live in dynamic shared memory as float32 rows of stride ld (hd rounded up
// to 4 and padded so that ld / 4 is odd: eight float4 rows of a quarter
// warp hit distinct banks), zero beyond hd and beyond S.  Warp w owns query
// rows 8w..8w+7: lane c computes the scores of KV columns c and c + 32 for
// those rows (float4 loads along hd), the row max and sum are warp
// shuffles, the probabilities go through a per-warp slice of shared memory,
// and lane c accumulates output columns c + 32j (j < NCOL) of the 8 rows.
// head_dim up to 256 (NCOL = 1, 2, 4 or 8); 120 takes NCOL = 4 and masks
// the columns past 120.
//
// Bound on the H100: operations.  The band holds sum_i min(i + 1, window)
// (query, key) pairs per head, 4 * hd flop each (two products); at
// Danube's prefill (S = 32768, window 4096, 32 heads of 120) that is
// 1.93 TFLOP: 28.8 ms at the 67 TFLOP/s float32 CUDA-core peak that this
// kernel can reach, 1.95 ms at the 989 TFLOP/s bf16 tensor-core peak that a
// wgmma kernel could.  Bytes (q, k, v read once, out written once) are
// 0.63 GB, 0.19 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;               // query rows per warp
constexpr int kBQ = kWarps * kRows;    // query rows per CTA: 64
constexpr int kBK = 64;                // KV rows per tile: two per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

template <typename T, int NCOL>
__global__ void __launch_bounds__(kThreads, NCOL <= 4 ? 2 : 1)
flash_swa_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int H,
                 int Hkv, int hd, int ld, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [kBQ][ld]
  float* ks = qs + kBQ * ld;      // [kBK][ld]
  float* vs = ks + kBK * ld;      // [kBK][ld]
  float* ps = vs + kBK * ld;      // [kBQ][kBK] probabilities

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(Hkv) * hd;
  const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                       static_cast<size_t>(h) * hd;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride +
                        static_cast<size_t>(hk) * hd;

  load_tile(qs, q + q_off, q_stride, q0, kBQ, S, hd, ld);

  const int r0 = warp * kRows;
  float m[kRows], l[kRows], acc[kRows][NCOL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) acc[r][j] = 0.0f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int lo = max(0, q0 - window + 1);
  for (int kt = (lo / kBK) * kBK; kt <= q_last; kt += kBK) {
    __syncthreads();   // the previous tile's K/V are consumed
    load_tile(ks, k + kv_off, kv_stride, kt, kBK, S, hd, ld);
    load_tile(vs, v + kv_off, kv_stride, kt, kBK, S, hd, ld);
    __syncthreads();

    // scores of rows r0..r0+7 against KV columns lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.0f;
    const float* k0 = ks + lane * ld;
    const float* k1 = ks + (lane + 32) * ld;
    for (int d = 0; d < hd; d += 4) {   // columns past hd are zero
      const float4 a = *reinterpret_cast<const float4*>(k0 + d);
      const float4 c = *reinterpret_cast<const float4*>(k1 + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 x =
            *reinterpret_cast<const float4*>(qs + (r0 + r) * ld + d);
        s[r][0] = fmaf(x.x, a.x, s[r][0]);
        s[r][0] = fmaf(x.y, a.y, s[r][0]);
        s[r][0] = fmaf(x.z, a.z, s[r][0]);
        s[r][0] = fmaf(x.w, a.w, s[r][0]);
        s[r][1] = fmaf(x.x, c.x, s[r][1]);
        s[r][1] = fmaf(x.y, c.y, s[r][1]);
        s[r][1] = fmaf(x.z, c.z, s[r][1]);
        s[r][1] = fmaf(x.w, c.w, s[r][1]);
      }
    }

    // mask, online softmax, probabilities to this warp's rows of ps
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + r0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = kt + lane + 32 * c;
        const bool valid = kpos <= qpos && kpos > qpos - window;
        s[r][c] = valid ? s[r][c] * scale : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float corr = expf(m[r] - m_new);
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NCOL; ++j) acc[r][j] *= corr;
      ps[(r0 + r) * kBK + lane] = p0;
      ps[(r0 + r) * kBK + lane + 32] = p1;
    }
    __syncwarp();

    // acc[r][j] += sum_c p[r][c] * v[c][lane + 32 j]
    for (int c = 0; c < kBK; c += 4) {
      float4 p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        p[r] = *reinterpret_cast<const float4*>(ps + (r0 + r) * kBK + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[NCOL];
#pragma unroll
        for (int j = 0; j < NCOL; ++j) {
          const int d = lane + 32 * j;
          vv[j] = d < hd ? vs[(c + cc) * ld + d] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pr = cc == 0 ? p[r].x : cc == 1 ? p[r].y
                         : cc == 2 ? p[r].z : p[r].w;
#pragma unroll
          for (int j = 0; j < NCOL; ++j) acc[r][j] = fmaf(pr, vv[j], acc[r][j]);
        }
      }
    }
    __syncwarp();   // ps is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + r0 + r;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* row = out + q_off + static_cast<size_t>(qpos) * q_stride;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) store(row + d, acc[r][j] / denom);
    }
  }
}

// float stride of a shared-memory row: hd rounded up to 4, then padded so
// that the stride in float4 units is odd (conflict-free float4 loads of
// eight consecutive rows).
int row_stride(int hd) {
  int ld = (hd + 3) / 4 * 4;
  return (ld / 4) % 2 == 1 ? ld : ld + 4;
}

template <typename T, int NCOL>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Hkv, int hd, int window, float scale,
           cudaStream_t stream) {
  const int ld = row_stride(hd);
  const size_t smem = static_cast<size_t>(3 * kBQ * ld + kBQ * kBK) *
                      sizeof(float);
  auto kernel = flash_swa_kernel<T, NCOL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, Hkv, hd, ld,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_width(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int H, int Hkv, int hd, int window,
                 float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 1>(q, k, v, out, B, S, H, Hkv, hd, window, scale, stream);
  if (hd <= 64)
    return launch<T, 2>(q, k, v, out, B, S, H, Hkv, hd, window, scale, stream);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, out, B, S, H, Hkv, hd, window, scale, stream);
  if (hd <= 256)
    return launch<T, 8>(q, k, v, out, B, S, H, Hkv, hd, window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t code.
extern "C" int flash_swa_fwd(const void* q, const void* k, const void* v,
                             void* out, int dtype, int B, int S, int H,
                             int Hkv, int hd, int window, float scale,
                             cudaStream_t stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || hd <= 0 || window <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_width<float>(q, k, v, out, B, S, H, Hkv, hd, window, scale,
                               stream);
  if (dtype == 1)
    return launch_width<__nv_bfloat16>(q, k, v, out, B, S, H, Hkv, hd,
                                       window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
