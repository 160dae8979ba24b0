// Causal attention over the frame axis of q, k, v shaped (B, T, S, C), heads
// flat in C (head_dim 32), computed in that layout with no transpose.
//
// Replaces the forward Pallas kernel tpu1x/ops/temporal_attention.py
// (_temporal_fwd -> _fwd_kernel). The TPU kernel reduced each head's dot
// products through a 0/1 head matrix on the MXU, a lane trick; here four
// lanes hold one head's 32 channels (8 each, 16-byte loads) and reduce with
// two shuffles. One block per (b, s): 64 threads cover C=512. Bound on the
// H100: device memory (q, k, v read once, out written once: 4 B T S C bytes,
// 134 MB at the prefill's B=16, T=8); the T <= 16 logits of a query stay in
// registers, and the re-reads of k and v for later queries hit L1.
// Probabilities are rounded to bf16 before the PV sum, as the reference does.

#include "common.cuh"

using namespace tpu1x;

namespace {

constexpr int TA_MAXT = 16;

// element (b, t, s, c) of q/k/v at ((b*T + t)*S + s)*ld + c; out contiguous.
__global__ void temporal_attention_kernel(const bf16* __restrict__ q,
                                          const bf16* __restrict__ k,
                                          const bf16* __restrict__ v,
                                          bf16* __restrict__ out, int T, int S,
                                          int C, int ld, float scale) {
  const int s = blockIdx.x, b = blockIdx.y, c0 = threadIdx.x * 8;
  auto at = [&](int t) { return ((long)(b * T + t) * S + s) * ld + c0; };
  for (int t = 0; t < T; ++t) {
    float qf[8];
    load8(q + at(t), qf);
    const int kmax = t + 1;
    float lg[TA_MAXT];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < TA_MAXT; ++j) {
      if (j < kmax) {
        float kf[8];
        load8(k + at(j), kf);
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d += qf[i] * kf[i];
        lg[j] = quad_sum(d) * scale;
        m = fmaxf(m, lg[j]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < TA_MAXT; ++j) {
      if (j < kmax) {
        lg[j] = __expf(lg[j] - m);
        sum += lg[j];
      }
    }
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < TA_MAXT; ++j) {
      if (j < kmax) {
        const float p = bf16r(lg[j] / sum);
        float vf[8];
        load8(v + at(j), vf);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += p * vf[i];
      }
    }
    store8(out + ((long)(b * T + t) * S + s) * C + c0, acc);
  }
}

}  // namespace

// Requires T <= 16, C % 256 == 0 (whole warps of 4-lane heads), ld % 8 == 0.
extern "C" int tpu1x_temporal_attention(const void* q, const void* k,
                                        const void* v, void* out, int B, int T,
                                        int S, int C, int ld, float scale,
                                        void* stream) {
  if (T > TA_MAXT || C % 256 || ld % 8) return cudaErrorInvalidValue;
  temporal_attention_kernel<<<dim3(S, B), C / 8, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), T, S, C, ld, scale);
  return cudaGetLastError();
}
