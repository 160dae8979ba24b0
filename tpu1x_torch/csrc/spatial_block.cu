// Spatial half of an STBlock: out = x + proj(MHA(qkv(LN1(x)))), bidirectional
// over the S tokens of each of N frames, heads flat in C.
//
// Replaces the Pallas kernel tpu1x/ops/spatial_block.py:spatial_block
// (_kernel / _one_row). That kernel keeps one whole row (S x C) and every
// intermediate in VMEM. On the H100 one bf16 row at S=256, C=512 is 256 KB,
// more than the 227 KB of shared memory a block may use, so the work is cut
// into launches instead, whose intermediates (xn, qkv and the attention
// output, 4 + 12 + 4 MB at N = 16) stay in the 50 MB L2:
//   (a) with the pre-LN, LN1 as its own row pass (csrc/layer_norm.cuh, K5's
//       kernel: fp32 statistics, variance E[x^2] - E[x]^2, the result
//       rounded to bf16), xn (N S, C);
//   (b) qkv = xn @ Wqkv (+ bias), (N, S, 3C), on csrc/gemm_sm90.cuh (TMA,
//       wgmma, persistent tiles);
//   (c) with the per-head qk-LayerNorm of the qk_norm models, that LN as a
//       row pass over the q and k thirds of qkv in place (layer_norm.cuh's
//       head_norm_kernel: each head row of D channels, the one (D,) pair
//       shared by q, k and every head, fp32 statistics, rounded to bf16, as
//       the TPU kernel rounds the normalised rows before q k^T);
//   (d) attention per (frame, head): K9's flash forward
//       (csrc/flash_attention.cuh, head_dim 32, 64 or 128) on the q, k and v
//       thirds of qkv read in place; with the qk-LN its NORM form, which
//       rounds the normalised p to bf16 as the TPU kernel does (its
//       consumers quantize k and v to int8, where the unnormalised
//       rounding's bf16 differences become whole steps);
//   (e) out = x + attn @ Wproj (+ bias) on the same GEMM, its epilogue the
//       serving chain (round, + bias, round, + x, round).
// The (N, H, S, S) logits never reach device memory. Bound: tensor-core
// operations (2 N S C (4C + 2S) FLOP: 10.7 GFLOP at N=16 against 134 MB
// moved at most; at S = 1024, GENIE_138M-S1024's grid, 68.7 GFLOP, 0.0695
// ms at 989 TFLOP/s, where K9's exponentials, N H S^2 = 2.7e8, take 0.072
// ms); the transposed-qkv layout of the TPU kernel was a Mosaic
// workaround and is not carried over.
//
// The spatial train block's backward (tpu1x_torch/ops/spatial_train_block.py)
// has no kernel here: it sequences the LN row pass, this file's qkv product
// (tpu1x_gemm_sm90, the forward's rounding), K9's forward and K10's backward
// (flash_attention.cu) and the training forms of the GEMM (train_block.cu).

#include "flash_attention.cuh"
#include "gemm_sm90.cuh"
#include "layer_norm.cuh"

using namespace tpu1x;

// x, out (N, S, C); wqkv (C, 3C); wproj (C, C); biases bf16 or null;
// ln_scale/ln_bias fp32 (C,) or null (no pre-LN); qk_ln_scale/qk_ln_bias
// fp32 (D,) or null (no qk-LN); qkv_buf (N, S, 3C) and attn_buf (N, S, C)
// are scratch, and so is xn_buf (N, S, C), the pre-LN's output and then the
// flash forward's lse. Requires what K9 takes of S (64 <= S <= FA_MAXN =
// 4096, S % 64 == 0: whole frames in shared memory up to 256 tokens,
// streamed key chunks past it), head_dim D = C / H of 32, 64 or 128, C %
// 64 == 0. Every launch here indexes memory with 64-bit offsets (the GEMM's
// epilogue, the row passes, the flash forward) or through TMA coordinates
// of at most N S rows: at GENIE_138M-S1024's evaluator prefill (N = 256, S
// = 1024) qkv is 4.0e8 elements.
extern "C" int tpu1x_spatial_block(const void* x, const void* wqkv,
                                   const void* bqkv, const void* wproj,
                                   const void* bproj, const void* ln_scale,
                                   const void* ln_bias, const void* qk_ln_scale,
                                   const void* qk_ln_bias, void* xn_buf,
                                   void* qkv_buf, void* attn_buf, void* out,
                                   int N, int S, int C, int H, float scale,
                                   void* stream) {
  const bool pre_ln = ln_scale != nullptr, qk_ln = qk_ln_scale != nullptr;
  const int D = H > 0 ? C / H : 0;
  const long rs = (long)S * 3 * C, ts = 3L * C;
  const long strides[2] = {rs, ts};
  if (!flash_ok(S, D, strides, 2) || C != H * D || C % 64 ||
      pre_ln != (ln_bias != nullptr) || qk_ln != (qk_ln_bias != nullptr) ||
      xn_buf == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = N * S;
  const void* a = x;
  if (pre_ln) {
    TPU1X_TRY(launch_layer_norm(x, ln_scale, ln_bias, xn_buf, rows, C, 1e-5f,
                                s));
    a = xn_buf;
  }
  TPU1X_TRY(
      launch_gemm90(a, wqkv, qkv_buf, bqkv, nullptr, rows, 3 * C, C, s));
  if (qk_ln)
    TPU1X_TRY(launch_head_norm(qkv_buf, qk_ln_scale, qk_ln_bias, rows, C, D,
                               1e-5f, s));
  // the q, k, v thirds of each token's 3C values, as (N, S, H, D) views;
  // the lse that the forward writes (N H S floats, at most an eighth of
  // xn's bytes) goes to xn, which the qkv product has read
  const bf16* qkv = static_cast<const bf16*>(qkv_buf);
  TPU1X_TRY(launch_flash_fwd(qkv, qkv + C, qkv + 2 * C, attn_buf,
                             static_cast<float*>(xn_buf), rs, ts, rs, ts, rs,
                             ts, N, S, H, D, scale, false, s, qk_ln));
  return launch_gemm90(attn_buf, wproj, out, bproj, x, rows, C, C, s);
}

// C (M, N) = epilogue(A (M, K) B (K, N)) on the GEMM of the two products
// above (and of the temporal+MLP block's four; the spatial train block's
// backward recomputes qkv with it), all bf16 and contiguous:
// rounded, + bias (N,) if not null, rounded, GELU (act ACT_GELU_TANH or
// ACT_GELU_ERF; ACT_NONE: none), rounded, + resid (M, N) if not null,
// rounded.
extern "C" int tpu1x_gemm_sm90(const void* A, const void* B, void* C,
                               const void* bias, const void* resid, int M,
                               int N, int K, int act, void* stream) {
  return launch_gemm90(A, B, C, bias, resid, M, N, K,
                       static_cast<cudaStream_t>(stream), act);
}
