// Row LayerNorm: the kernel and its design are csrc/layer_norm.cuh.
//
// Replaces the Pallas kernel tpu1x/ops/layernorm.py:layer_norm (_kernel).

#include "layer_norm.cuh"

using namespace tpu1x;

// x, y (rows, C) bf16; scale, bias (C,) fp32, all 16-byte aligned. Requires
// C % 8 == 0, C <= MAX_C (4096; a pair of warps a row past 2048).
extern "C" int tpu1x_layer_norm(const void* x, const void* scale,
                                const void* bias, void* y, int rows, int C,
                                float eps, void* stream) {
  return launch_layer_norm(x, scale, bias, y, rows, C, eps,
                           static_cast<cudaStream_t>(stream));
}
