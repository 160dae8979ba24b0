// Stand-alone decode attention: one query frame (temporal_decode_attention)
// or a [prev, cur] pair (temporal_decode2_attention) against layer `layer`
// of the stacked (T, L, B, S, C) KV cache, bf16 or int8 with per-token
// scales, plus the in-pass keys; one joint fp32 softmax.
//
// Replaces the Pallas kernels tpu1x/ops/decode_attention.py:
// temporal_decode_attention (_kernel) and temporal_decode2_attention
// (_kernel2). The kernel is csrc/decode_attention.cuh, which the
// temporal+MLP block launches too; see there for the design (slot tiles
// bulk-copied into a ring of stages, one pass over K and V with an online
// softmax) and the bound (device memory: the valid cache slots, read once).
// q, k and v of a frame may each be a strided (B, S, C) view, so that
// column thirds of one qkv product, or its batch halves, feed the kernel
// without a copy.
//
// The TPU kernels multiply q and k in bf16 and round the probabilities to
// bf16 before PV; this kernel keeps both in fp32, as the references do.

#include "decode_attention.cuh"

using namespace tpu1x;

// q0, k0, v0 (and q1, k1, v1 with frames == 2): bf16 (B, S, C) views with
// element strides (sbq, ldq, 1), (sbk, ldk, 1), (sbv, ldv, 1), multiples of
// 8, 16-byte aligned. k_cache, v_cache (T, L, B, S, C), 16-byte aligned:
// bf16, or int8 when k_scale, v_scale (L, B, T, S) fp32 are given, 16-byte
// aligned, with S % 4 == 0. t_B (B,) int32. out0 (out1):
// bf16 views with strides (osb, old, 1). k_out, v_out: contiguous (B, S, C)
// copies of k0, v0, or null. D: head_dim, 32, 64, 72 or 128.
extern "C" int tpu1x_decode_attention(
    const void* q0, const void* q1, const void* k0, const void* k1,
    const void* v0, const void* v1, long sbq, long ldq, long sbk, long ldk,
    long sbv, long ldv, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* t_B, void* out0,
    void* out1, long osb, long old, void* k_out, void* v_out, int B,
    int frames, int S, int C, int D, int T, int L, int layer, float scale,
    void* stream) {
  if (sbq % 8 || ldq % 8 || sbk % 8 || ldk % 8 || sbv % 8 || ldv % 8 ||
      osb % 8 || old % 8 || (k_out == nullptr) != (v_out == nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return cudaErrorInvalidValue;
  DecodeAttnArgs d{};
  d.q[0] = static_cast<const bf16*>(q0);
  d.q[1] = static_cast<const bf16*>(q1);
  d.k[0] = static_cast<const bf16*>(k0);
  d.k[1] = static_cast<const bf16*>(k1);
  d.v[0] = static_cast<const bf16*>(v0);
  d.v[1] = static_cast<const bf16*>(v1);
  d.sb[0] = sbq, d.ld[0] = ldq;
  d.sb[1] = sbk, d.ld[1] = ldk;
  d.sb[2] = sbv, d.ld[2] = ldv;
  d.kc = k_cache;
  d.vc = v_cache;
  d.ksc = static_cast<const float*>(k_scale);
  d.vsc = static_cast<const float*>(v_scale);
  d.t_B = static_cast<const int*>(t_B);
  d.out[0] = static_cast<bf16*>(out0);
  d.out[1] = static_cast<bf16*>(out1);
  d.osb = osb;
  d.old = old;
  d.k_out = static_cast<bf16*>(k_out);
  d.v_out = static_cast<bf16*>(v_out);
  d.B = B, d.S = S, d.C = C, d.T = T, d.L = L, d.layer = layer, d.D = D;
  d.scale = scale;
  return launch_decode_attention(d, frames, static_cast<cudaStream_t>(stream));
}
