// Hopper's Tensor Memory Accelerator and the mbarriers that report its
// copies, for the port's warp-specialised kernels (K5/K6's bf16 x bf16
// route, segmm/csrc/segmm_wgmma.cu; K7 and its backward,
// flash_swa/csrc/flash_swa_wgmma.cu and flash_swa_bwd_wgmma.cu).
//
// * Device: mbarrier init / arrive / arrive.expect_tx / wait on a phase
//   parity, and 2-D, 3-D and 4-D tiled TMA loads global -> shared that
//   complete on an mbarrier.  A wait that sees no progress for
//   kWaitLimitNs traps, so a pipeline fault ends the launch with an error
//   instead of hanging the card (mbar_wait; mbar_wait_spin spins without a
//   limit, for consumers whose kernel keeps the guard in its producer).
// * Host: encode_tiled() fills a CUtensorMap through the driver's
//   cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint*, so the
//   library links against the runtime only (no -lcuda).  A map is built
//   per call and passed to the kernel as a __grid_constant__ parameter.
//
// Out-of-bounds boxes: TMA fills the elements of a box that lie outside the
// tensor's dims with zeros and still counts the whole box's bytes on the
// mbarrier.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

constexpr unsigned long long kWaitLimitNs = 4000000000ull;   // 4 s

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Make initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Arrive once and add `bytes` to the transaction count of this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const unsigned long long start = global_ns();
  while (!mbar_try_wait(addr, parity)) {
    if (global_ns() - start > kWaitLimitNs) __trap();
  }
}

// Box at coordinates (c0 innermost, c1) of a 2-D map into shared `dst`.
// mbar_wait without the timeout, for the consumer warpgroups of a kernel
// that raises their registers with setmaxnreg: a trap in their code makes
// ptxas size their wgmma pipelining by the launch's register budget (168 a
// thread of a 384-thread CTA) whatever setmaxnreg gives them, so that it
// serialises the wgmmas and spills.  The kernel keeps its hang guard in
// the producer, which waits (mbar_wait) until the consumers release the
// last stages.
__device__ __forceinline__ void mbar_wait_spin(uint64_t* bar,
                                               uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  while (!mbar_try_wait(addr, parity)) {
  }
}

__device__ __forceinline__ void load_2d(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Box at coordinates (c0 innermost, c1, c2) of a 3-D map into shared `dst`.
__device__ __forceinline__ void load_3d(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1,
                                        int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Box at coordinates (c0 innermost, c1, c2, c3) of a 4-D map into `dst`.
__device__ __forceinline__ void load_4d(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1,
                                        int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, or nullptr if the driver has none.
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map of `rank` dims (dims[0] innermost, strides in bytes of
// dims 1..rank-1) read in boxes `box` with a 128-byte swizzle (box[0] * 2
// must be 128 bytes or less); out-of-bounds elements read as zero.  Returns
// a cudaError_t value (cudaErrorInvalidValue when the driver refuses).
inline int encode_tiled(CUtensorMap* map, const void* base, int rank,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         static_cast<cuuint32_t>(rank),
                         const_cast<void*>(base), dims, strides, box,
                         elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tma
