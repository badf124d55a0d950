// Hopper (sm_90a) building blocks shared by the kernels that feed shared
// memory with the Tensor Memory Accelerator: mbarrier helpers, the 3-D TMA
// tile load, and the tensor-map encoder (cuTensorMapEncodeTiled).
//
// An mbarrier lives in shared memory.  A producer thread arms it with the
// bytes it expects (mbar_expect_tx) and issues TMA loads that complete
// those bytes on it; consumers wait on its phase parity (mbar_wait) and
// release a stage by arriving on a second barrier.  cuTensorMapEncodeTiled
// comes through cudaGetDriverEntryPoint, so no library needs -lcuda.
//
// _build.py hashes this header into the name of every library whose source
// includes it, so an edit here rebuilds them.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// returns once the barrier's phase of parity `parity` has completed; a
// phase that never completes (a lost TMA transaction) traps after ~2^26
// suspended tries instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// one box of a 3-D tensor map into shared memory at dst (128-byte
// aligned); its bytes complete on bar.  Coordinates are in elements,
// innermost first; a box past the tensor's edge is zero-filled.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                     12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a dense 3-D tensor of dims[0] x dims[1] x dims[2] elements of elem_bytes
// (innermost first), read in boxes of box[0] x box[1] x box[2]
inline cudaError_t make_map_3d(CUtensorMap* map, const void* ptr,
                               CUtensorMapDataType type, int elem_bytes,
                               const uint64_t (&dims)[3], const uint32_t (&box)[3],
                               CUtensorMapSwizzle swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 enc = tensor_map_encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  cuuint64_t gd[3] = {dims[0], dims[1], dims[2]};
  cuuint64_t strides[2] = {dims[0] * elem_bytes, dims[0] * dims[1] * elem_bytes};
  cuuint32_t bx[3] = {box[0], box[1], box[2]};
  cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = enc(map, type, 3, const_cast<void*>(ptr), gd, strides, bx, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
