// Shared device code of the port's kernels: bf16 helpers, warp sums, the
// warp-level tensor-core primitives (ldmatrix, mma.sync m16n8k16, cp.async)
// that K1's qk-LN attention kernel runs on, the GELU and its derivative
// that the GEMM epilogues and the temporal+MLP block evaluate, the
// activation numbering, and TPU1X_TRY. Every weight product of the port
// runs on csrc/gemm_sm90.cuh (TMA, wgmma); the Hopper primitives are
// csrc/sm90.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpu1x {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the 4 lanes (xor 1, 2) that share one 32-channel head when each
// lane holds 8 channels.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Two floats as one bf16x2 register: `lo` in the low half, the element with
// the smaller column index in the mma fragments.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float gelu(float x, int act) {
  if (act == 1) {  // tanh approximation, jax.nn.gelu(approximate=True)
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
  }
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));  // exact
}

// d gelu(x) / dx for the same two forms. Both use erff itself: the TPU MLP
// kernel's rational erf stands in for an erf that its compiler lacks, and is
// not copied.
__device__ __forceinline__ float dgelu(float x, int tanh_form) {
  if (tanh_form) {
    const float k = 0.7978845608028654f;
    const float th = tanhf(k * (x + 0.044715f * x * x * x));
    const float du = k * (1.f + 3.f * 0.044715f * x * x);
    return 0.5f * (1.f + th) + 0.5f * x * (1.f - th * th) * du;
  }
  const float phi = __expf(-0.5f * x * x) * 0.3989422804014327f;
  return 0.5f * (1.f + erff(x * 0.7071067811865476f)) + x * phi;
}

enum { ACT_NONE = 0, ACT_GELU_TANH = 1, ACT_GELU_ERF = 2,
       ACT_DGELU_TANH = 3, ACT_DGELU_ERF = 4 };

}  // namespace tpu1x

#define TPU1X_TRY(expr)                 \
  do {                                  \
    cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)
