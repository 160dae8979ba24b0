// Decode-step second half of an STBlock, for one frame or a pair of frames:
//   qkv = x @ Wqkv (+ b); attention of each token over the KV cache slots
//   t < t_B[b] of `layer` plus the in-pass keys; x1 = x + proj(attn);
//   out = x1 + fc2(GELU(fc1(LN2(x1)))). Also writes frame 0's k and v,
//   unless their pointers are null.
//
// Replaces the Pallas kernels tpu1x/ops/temporal_mlp_block.py:
// temporal_mlp_block (_kernel_single) and temporal_mlp_block_pair
// (_kernel_pair), both through _common_call; one source here, the attention
// templated on frames per row (1, or 2 = [prev, cur]). With the pair, one
// read of the cache serves both frames: prev attends the cache plus itself,
// cur attends the cache, prev's k/v and itself.
//
// Launches: the shared GEMM (qkv), the cache attention, the GEMM with bias +
// residual (proj), the GEMM with the LN2 prologue + bias + GELU (fc1), the
// GEMM with bias + residual (fc2). The (rows, 4C) MLP hidden goes through
// device memory in this first version.
//
// Bound on the H100: the products are 2 F B S C (12 C) FLOP, 25.8 GFLOP for
// one frame at B=16, C=512 (26 us of tensor-core time); the cache read is
// 2 B S C bytes per slot (8.4 MB). The attention reads only slots t < t_B[b]
// of one layer: the TPU kernel streamed all T slots and masked, which is the
// same arithmetic on more bytes. The attention kernel is the one of
// csrc/decode_attention.cuh (four lanes per head, fp32 softmax over at most
// T + 2 logits in registers, probabilities fp32 through PV, as the
// reference's), shared with the stand-alone decode attention.

#include "decode_attention.cuh"

using namespace tpu1x;

// x, out (B, frames, S, C) bf16; caches (T, L, B, S, C) bf16; t_B (B,) int32;
// weights bf16 (in, out); biases bf16 or null; ln_scale/ln_bias fp32 (C,);
// scratch qkv_buf (B*frames*S, 3C), attn_buf and x1_buf (B*frames*S, C),
// h_buf (B*frames*S, F4); k_out/v_out (B, S, C), both null or neither.
// Requires frames in {1, 2}, T <= 16, C % 256 == 0, F4 % 64 == 0.
extern "C" int tpu1x_temporal_mlp_block(
    const void* x, const void* k_cache, const void* v_cache, const void* t_B,
    const void* wqkv, const void* bqkv, const void* wproj, const void* bproj,
    const void* ln_scale, const void* ln_bias, const void* wfc1,
    const void* bfc1, const void* wfc2, const void* bfc2, void* qkv_buf,
    void* attn_buf, void* x1_buf, void* h_buf, void* out, void* k_out,
    void* v_out, int B, int frames, int S, int C, int F4, int T, int L,
    int layer, int gelu_tanh, float scale, void* stream) {
  if ((frames != 1 && frames != 2) || F4 % GBN) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * frames * S;

  GemmParams a = gemm_params(x, wqkv, qkv_buf, M, 3 * C, C);
  a.bias = static_cast<const bf16*>(bqkv);
  TPU1X_TRY(launch_gemm(a, s));

  // q, k, v are column thirds of qkv_buf (B, frames, S, 3C)
  DecodeAttnArgs d{};
  const bf16* qkv = static_cast<const bf16*>(qkv_buf);
  for (int f = 0; f < frames; ++f) {
    d.q[f] = qkv + (long)f * S * 3 * C;
    d.k[f] = d.q[f] + C;
    d.v[f] = d.q[f] + 2 * C;
    d.out[f] = static_cast<bf16*>(attn_buf) + (long)f * S * C;
  }
  for (int i = 0; i < 3; ++i) {
    d.sb[i] = (long)frames * S * 3 * C;
    d.ld[i] = 3L * C;
  }
  d.osb = (long)frames * S * C;
  d.old = C;
  d.kc = k_cache;
  d.vc = v_cache;
  d.t_B = static_cast<const int*>(t_B);
  d.k_out = static_cast<bf16*>(k_out);
  d.v_out = static_cast<bf16*>(v_out);
  d.B = B, d.S = S, d.C = C, d.T = T, d.L = L, d.layer = layer;
  d.scale = scale;
  TPU1X_TRY(launch_decode_attention(d, frames, s));

  GemmParams p = gemm_params(attn_buf, wproj, x1_buf, M, C, C);
  p.bias = static_cast<const bf16*>(bproj);
  p.resid = static_cast<const bf16*>(x);
  TPU1X_TRY(launch_gemm(p, s));

  GemmParams f1 = gemm_params(x1_buf, wfc1, h_buf, M, F4, C);
  f1.bias = static_cast<const bf16*>(bfc1);
  f1.ln_scale = static_cast<const float*>(ln_scale);
  f1.ln_bias = static_cast<const float*>(ln_bias);
  f1.act = gelu_tanh ? ACT_GELU_TANH : ACT_GELU_ERF;
  TPU1X_TRY(launch_gemm(f1, s));

  GemmParams f2 = gemm_params(h_buf, wfc2, out, M, C, F4);
  f2.bias = static_cast<const bf16*>(bfc2);
  f2.resid = static_cast<const bf16*>(x1_buf);
  TPU1X_TRY(launch_gemm(f2, s));
  return cudaSuccess;
}
