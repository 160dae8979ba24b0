// Hopper (sm_90a) primitives shared by the kernels that feed warpgroup
// products (wgmma) from shared memory filled by the Tensor Memory
// Accelerator (TMA): wgmma's shared-memory descriptors and its fence,
// commit and wait, mbarriers, the TMA copies, and the driver's tensor-map
// encoder, which the library reaches through the runtime so that it needs
// no link to libcuda.
//
// Swizzles. TMA writes a tile whose rows are 64 or 128 bytes with the
// 16-byte chunks of row r permuted by XOR with bits of r (64 bytes: chunk
// c ^ ((r >> 1) & 3); 128 bytes: c ^ (r & 7)); wgmma's descriptor names
// the same layout (type 2 or 1), so the tensor cores read the tile where
// TMA left it. A tile starts on a repeat of its swizzle: 512 or 1024 bytes.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace tpu1x {

enum { GMMA_SWIZZLE_128B = 1, GMMA_SWIZZLE_64B = 2 };

// wgmma shared-memory matrix descriptor. sbo: bytes between groups of 8
// rows along the operand's strided axis (K-major: 8 rows of M or N;
// MN-major: 8 rows of K); lbo: bytes between swizzle atoms along the
// contiguous axis of an MN-major operand wider than one atom (64-byte rows
// hold 32 bf16 values, 128-byte rows 64), unused where one atom spans it.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t sbo,
                                              uint32_t lbo,
                                              int layout = GMMA_SWIZZLE_64B) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the registers across
// the wgmma fence and wait around them.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A compile-time flag as an argument: a generic lambda called with
// Flag<false>{} and Flag<true>{} is compiled as two functions.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Orders this thread's generic-proxy accesses of shared memory before
// later async-proxy ones (TMA, wgmma), and the other way round.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA: a box of a tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
// A box of shared memory out to a tensor map, in the issuing thread's bulk
// group (cp.async.bulk.commit_group / wait_group).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, "
      "%2}], [%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, "
      "%3, %4}], [%5];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
}
// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// An L2 policy for data read once: its lines are the first to go.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}
// bulk_load with an L2 policy (l2_evict_first).
__device__ __forceinline__ void bulk_load_hint(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The bulk stores of this thread have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled from the driver, found at first use through the
// runtime. The launchers with static state are `static`: each library that
// includes these headers keeps its own (an inline function's static would
// be one object in the whole process, shared by every library).
static inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// Makes the primary context of the calling thread's current card current,
// once a thread. The tensor-map encoder (cuTensorMapEncodeTiled) fails with
// no context current (autograd's backward thread, when a kernel's backward
// is the first thing it runs). A thread that changes cards later does so
// with cudaSetDevice, which makes the new card's context current. As for
// every launch of the port, the caller makes the card that holds the
// tensors current (torch.cuda.device). Once bound, a call costs one
// thread-local load: a rollout encodes some ten thousand maps.
inline cudaError_t bind_card() {
  thread_local bool bound = false;
  if (bound) return cudaSuccess;
  int current = 0;
  TPU1X_TRY(cudaGetDevice(&current));
  TPU1X_TRY(cudaSetDevice(current));
  bound = true;
  return cudaSuccess;
}

// A bf16 tensor map of `rank` dimensions (innermost first), strides in
// bytes of dimensions 1.., a box and a swizzle, encoded with the current
// card's context current (bind_card).
inline cudaError_t encode_map(CUtensorMap* map, const void* base, int rank,
                              const cuuint64_t* dims, const cuuint64_t* strides,
                              const cuuint32_t* box,
                              CUtensorMapSwizzle swizzle) {
  TPU1X_TRY(bind_card());
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The blocks of `kernel` that the card keeps resident, every SM.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  TPU1X_TRY(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  TPU1X_TRY(cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared));
  TPU1X_TRY(cudaGetDevice(&dev));
  TPU1X_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  TPU1X_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem));
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  return cudaSuccess;
}

}  // namespace tpu1x
