// Row LayerNorm, bf16 in and out, fp32 statistics with the variance taken as
// E[x^2] - E[x]^2 (the JAX package's formula, not torch's).
//
// Replaces the Pallas kernel tpu1x/ops/layernorm.py:layer_norm (_kernel).
// Bound on the H100: device memory, one read and one write of each row (67
// MB at the prefill's 32768 x 512). One warp per row, each lane 16-byte
// loads of 8 channels kept in registers between the statistics and the
// write, so each byte is read once; any row count (no multiple-of-8 rule).

#include "common.cuh"

using namespace tpu1x;

namespace {

constexpr int LN_MAXV = 8;  // chunks of 8 channels per lane: C <= 2048

__global__ void __launch_bounds__(256)
    layer_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, bf16* __restrict__ y,
                      int rows, int C, float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const bf16* xr = x + (long)row * C;
  float v[LN_MAXV][8];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int j = 0; j < LN_MAXV; ++j) {
    const int c = (j * 32 + lane) * 8;
    if (c < C) {
      load8(xr + c, v[j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s += v[j][i];
        ss += v[j][i] * v[j][i];
      }
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / C;
  const float rs = rsqrtf(ss / C - mu * mu + eps);
  bf16* yr = y + (long)row * C;
#pragma unroll
  for (int j = 0; j < LN_MAXV; ++j) {
    const int c = (j * 32 + lane) * 8;
    if (c < C) {
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = (v[j][i] - mu) * rs * g[c + i] + b[c + i];
      store8(yr + c, o);
    }
  }
}

}  // namespace

// x, y (rows, C) bf16; scale, bias (C,) fp32. Requires C % 8 == 0, C <= 2048.
extern "C" int tpu1x_layer_norm(const void* x, const void* scale,
                                const void* bias, void* y, int rows, int C,
                                float eps, void* stream) {
  if (C % 8 || C > LN_MAXV * 256) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  layer_norm_kernel<<<(rows + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<bf16*>(y), rows, C, eps);
  return cudaGetLastError();
}
