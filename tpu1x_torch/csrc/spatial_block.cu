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
//   (c) attention per (frame, head): with the pre-LN, K9's flash forward
//       (csrc/flash_attention.cuh) on the q, k and v thirds of qkv read in
//       place; with the per-head qk-LayerNorm of the qk_norm models,
//       spatial_attention_kernel below, per (frame, head, 64-query tile),
//       which normalises the head's q and k rows in shared memory;
//   (d) out = x + attn @ Wproj (+ bias) on the same GEMM, its epilogue the
//       serving chain (round, + bias, round, + x, round).
// The (N, H, S, S) logits never reach device memory. Bound: tensor-core
// operations (2 N S C (4C + 2S) FLOP: 10.7 GFLOP at N=16 against 134 MB
// moved at most); the transposed-qkv layout of the TPU kernel was a Mosaic
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

namespace {

constexpr int SB_S = 256;      // keys per head held in shared memory
constexpr int SB_D = 32;       // head_dim
constexpr int SB_QT = 64;      // queries per block: 4 warps x 16 rows
constexpr int SB_LD = SB_D + 8;

// qkv (N, S, 3C) -> out (N, S, C) with the qk-LN. grid (S / 64, H, N), 128
// threads. The fp32 LayerNorm over the 32 channels of the head, one pair of
// (32,) parameters shared by q and k and by all heads (variance
// E[x^2] - E[x]^2, eps 1e-5), is applied to the q and k rows in shared
// memory and rounded to bf16 before the q k^T product, as the TPU kernel
// does on its transposed rows; then the head's S=256 keys and values sit in
// shared memory, the 16 x 256 logits of each warp stay in registers,
// softmax in fp32, probabilities rounded to bf16 and fed straight from the
// logit registers into the PV product (mma.sync).
__global__ void __launch_bounds__(128)
    spatial_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                             int C, float scale, const float* __restrict__ qk_scale,
                             const float* __restrict__ qk_bias) {
  __shared__ __align__(16) bf16 Ks[SB_S * SB_LD];
  __shared__ __align__(16) bf16 Vs[SB_S * SB_LD];
  __shared__ __align__(16) bf16 Qs[SB_QT * SB_LD];
  const int n = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * SB_QT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long ld = 3L * C;
  const bf16* base = qkv + (long)n * SB_S * ld + h * SB_D;

  for (int c = tid; c < SB_S * 4; c += 128) {
    const int r = c >> 2, d = (c & 3) * 8;
    cp_async16(&Ks[r * SB_LD + d], base + r * ld + C + d, true);
    cp_async16(&Vs[r * SB_LD + d], base + r * ld + 2 * C + d, true);
  }
  for (int c = tid; c < SB_QT * 4; c += 128) {
    const int r = c >> 2, d = (c & 3) * 8;
    cp_async16(&Qs[r * SB_LD + d], base + (long)(q0 + r) * ld + d, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // one thread per row of K (256) and Q (64)
  for (int r = tid; r < SB_S + SB_QT; r += 128) {
    bf16* row = r < SB_S ? &Ks[r * SB_LD] : &Qs[(r - SB_S) * SB_LD];
    float f[SB_D];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int d = 0; d < SB_D; d += 8) load8(row + d, f + d);
#pragma unroll
    for (int d = 0; d < SB_D; ++d) {
      s1 += f[d];
      s2 += f[d] * f[d];
    }
    const float mu = s1 / SB_D;
    const float rs = rsqrtf(s2 / SB_D - mu * mu + 1e-5f);
#pragma unroll
    for (int d = 0; d < SB_D; ++d)
      f[d] = (f[d] - mu) * rs * qk_scale[d] + qk_bias[d];
#pragma unroll
    for (int d = 0; d < SB_D; d += 8) store8(row + d, f + d);
  }
  __syncthreads();

  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    ldmatrix_x4(qa[kk], &Qs[(warp * 16 + (lane & 15)) * SB_LD + kk * 16 +
                            (lane >> 4) * 8]);

  // logits of rows g and g + 8 of this warp's 16 queries against 8 keys
  // per tile: sc[j] = {(g, 8j + 2t), (g, 8j + 2t + 1), (g + 8, ...), ...}
  float sc[SB_S / 8][4];
#pragma unroll
  for (int j = 0; j < SB_S / 8; ++j) {
    sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    uint32_t kb[4];  // keys 8j..8j+7, d 0-7 | 8-15 | 16-23 | 24-31
    ldmatrix_x4(kb, &Ks[(j * 8 + (lane & 7)) * SB_LD + (lane >> 3) * 8]);
    mma_bf16(sc[j], qa[0], &kb[0]);
    mma_bf16(sc[j], qa[1], &kb[2]);
  }

  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < SB_S / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] *= scale;
    m0 = fmaxf(m0, fmaxf(sc[j][0], sc[j][1]));
    m1 = fmaxf(m1, fmaxf(sc[j][2], sc[j][3]));
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < SB_S / 8; ++j) {
    sc[j][0] = __expf(sc[j][0] - m0);
    sc[j][1] = __expf(sc[j][1] - m0);
    sc[j][2] = __expf(sc[j][2] - m1);
    sc[j][3] = __expf(sc[j][3] - m1);
    s0 += sc[j][0] + sc[j][1];
    s1 += sc[j][2] + sc[j][3];
  }
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
  const float i0 = 1.f / s0, i1 = 1.f / s1;

  // out (16 x 32) = P (16 x 256, bf16) @ V (256 x 32); the accumulator
  // layout of two key tiles is the A-operand layout of one k16 step
  float o[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < SB_S / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(sc[2 * kk][0] * i0, sc[2 * kk][1] * i0);
    pa[1] = pack_bf16(sc[2 * kk][2] * i1, sc[2 * kk][3] * i1);
    pa[2] = pack_bf16(sc[2 * kk + 1][0] * i0, sc[2 * kk + 1][1] * i0);
    pa[3] = pack_bf16(sc[2 * kk + 1][2] * i1, sc[2 * kk + 1][3] * i1);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, &Vs[(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                    SB_LD + nb * 16 + (lane >> 4) * 8]);
      mma_bf16(o[nb * 2], pa, &vb[0]);
      mma_bf16(o[nb * 2 + 1], pa, &vb[2]);
    }
  }

  const int g = lane >> 2, t4 = lane & 3;
  bf16* orow = out + ((long)n * SB_S + q0 + warp * 16 + g) * C + h * SB_D + t4 * 2;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    *reinterpret_cast<uint32_t*>(orow + nt * 8) = pack_bf16(o[nt][0], o[nt][1]);
    *reinterpret_cast<uint32_t*>(orow + 8L * C + nt * 8) =
        pack_bf16(o[nt][2], o[nt][3]);
  }
}

}  // namespace

// x, out (N, S, C); wqkv (C, 3C); wproj (C, C); biases bf16 or null;
// ln_scale/ln_bias fp32 (C,) or null (no pre-LN); qk_ln_scale/qk_ln_bias
// fp32 (32,) or null (no qk-LN); qkv_buf (N, S, 3C) and attn_buf (N, S, C)
// are scratch, and so is xn_buf (N, S, C), the pre-LN's output and then the
// flash forward's lse, null only with the qk-LN and no pre-LN. Requires
// S == 256, C == 32 * H, C % 64 == 0.
extern "C" int tpu1x_spatial_block(const void* x, const void* wqkv,
                                   const void* bqkv, const void* wproj,
                                   const void* bproj, const void* ln_scale,
                                   const void* ln_bias, const void* qk_ln_scale,
                                   const void* qk_ln_bias, void* xn_buf,
                                   void* qkv_buf, void* attn_buf, void* out,
                                   int N, int S, int C, int H, float scale,
                                   void* stream) {
  const bool pre_ln = ln_scale != nullptr, qk_ln = qk_ln_scale != nullptr;
  if (S != SB_S || C != H * SB_D || C % 64 ||
      pre_ln != (ln_bias != nullptr) || qk_ln != (qk_ln_bias != nullptr) ||
      ((pre_ln || !qk_ln) && xn_buf == nullptr))
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
  const bf16* qkv = static_cast<const bf16*>(qkv_buf);
  if (qk_ln) {
    spatial_attention_kernel<<<dim3(S / SB_QT, H, N), 128, 0, s>>>(
        qkv, static_cast<bf16*>(attn_buf), C, scale,
        static_cast<const float*>(qk_ln_scale),
        static_cast<const float*>(qk_ln_bias));
    TPU1X_TRY(cudaGetLastError());
  } else {
    // the q, k, v thirds of each token's 3C values, as (N, S, H, 32) views;
    // the lse that the forward writes (N H S floats, an eighth of xn's
    // bytes) goes to xn, which the qkv product has read
    const long rs = (long)S * 3 * C, ts = 3L * C;
    TPU1X_TRY(launch_flash_fwd(qkv, qkv + C, qkv + 2 * C, attn_buf,
                               static_cast<float*>(xn_buf), rs, ts, rs, ts,
                               rs, ts, N, S, H, SB_D, scale, false, s));
  }
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
