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
// The TPU kernel keeps a tile of rows and every intermediate in VMEM. Here
// the work is six launches on one stream, the pattern of the spatial block
// (csrc/spatial_block.cu), whose intermediates (qkv, attn, x1, xn and the
// (rows, F4) MLP hidden: 12 + 4 + 4 + 4 + 16.8 MB for one frame at B=16,
// C=512, twice that for the pair) stay largely in the 50 MB L2:
//   (a) qkv = x @ Wqkv (+ bias), (rows, 3C), on csrc/gemm_sm90.cuh (TMA,
//       wgmma, persistent tiles);
//   (b) the cache attention of csrc/decode_attention.cuh (each valid
//       slot's K and V rows bulk-copied into a ring, one pass with an
//       online fp32 softmax, probabilities fp32 through PV, as the
//       reference's), shared with the stand-alone decode attention; it
//       reads q, k and v in place in qkv and writes frame 0's k and v;
//   (c) x1 = x + attn @ Wproj (+ bias), the GEMM's bias + residual epilogue;
//   (d) xn = LN2(x1), K5's row pass (csrc/layer_norm.cuh: fp32 statistics,
//       variance E[x^2] - E[x]^2, eps 1e-5, rounded to bf16);
//   (e) h = GELU(xn @ Wfc1 (+ bias)), (rows, F4), the GEMM's GELU epilogue
//       (tanh or exact erf; product, bias and GELU each rounded to bf16);
//   (f) out = x1 + h @ Wfc2 (+ bias), K = F4, bias + residual.
//
// Bound on the H100: the tensor cores for the products, 2 F B S C (12 C)
// FLOP, 25.8 GFLOP for one frame at B=16, C=512 (26 us at 989 TFLOP/s);
// the cache read is 2 B S C bytes per slot (8.4 MB, 2.5 us at 3.35 TB/s).
// The attention reads only slots t < t_B[b] of one layer: the TPU kernel
// streamed all T slots and masked, which is the same arithmetic on more
// bytes.

#include "decode_attention.cuh"
#include "gemm_sm90.cuh"
#include "layer_norm.cuh"

using namespace tpu1x;

// x, out (B, frames, S, C) bf16; caches (T, L, B, S, C) bf16; t_B (B,) int32;
// weights bf16 (in, out); biases bf16 or null; ln_scale/ln_bias fp32 (C,);
// scratch qkv_buf (B*frames*S, 3C), attn_buf, x1_buf and xn_buf
// (B*frames*S, C), h_buf (B*frames*S, F4); k_out/v_out (B, S, C), both null
// or neither. Requires frames in {1, 2}, T <= 32, head_dim D in {32, 64, 128},
// C % 256 == 0, F4 % 64 == 0.
extern "C" int tpu1x_temporal_mlp_block(
    const void* x, const void* k_cache, const void* v_cache, const void* t_B,
    const void* wqkv, const void* bqkv, const void* wproj, const void* bproj,
    const void* ln_scale, const void* ln_bias, const void* wfc1,
    const void* bfc1, const void* wfc2, const void* bfc2, void* qkv_buf,
    void* attn_buf, void* x1_buf, void* xn_buf, void* h_buf, void* out,
    void* k_out, void* v_out, int B, int frames, int S, int C, int D, int F4,
    int T, int L, int layer, int gelu_tanh, float scale, void* stream) {
  if ((frames != 1 && frames != 2) || T > DA_MAXT || C % 256 || F4 % G9_BN)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * frames * S;

  TPU1X_TRY(launch_gemm90(x, wqkv, qkv_buf, bqkv, nullptr, M, 3 * C, C, s));

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
  d.B = B, d.S = S, d.C = C, d.T = T, d.L = L, d.layer = layer, d.D = D;
  d.scale = scale;
  TPU1X_TRY(launch_decode_attention(d, frames, s));

  TPU1X_TRY(launch_gemm90(attn_buf, wproj, x1_buf, bproj, x, M, C, C, s));
  TPU1X_TRY(launch_layer_norm(x1_buf, ln_scale, ln_bias, xn_buf, M, C, 1e-5f,
                              s));
  TPU1X_TRY(launch_gemm90(xn_buf, wfc1, h_buf, bfc1, nullptr, M, F4, C, s,
                          gelu_tanh ? ACT_GELU_TANH : ACT_GELU_ERF));
  return launch_gemm90(h_buf, wfc2, out, bfc2, x1_buf, M, C, F4, s);
}
