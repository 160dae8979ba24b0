// Spatial half of an STBlock: out = x + proj(MHA(qkv(LN1(x)))), bidirectional
// over the S tokens of each of N frames, heads flat in C.
//
// Replaces the Pallas kernel tpu1x/ops/spatial_block.py:spatial_block
// (_kernel / _one_row). That kernel keeps one whole row (S x C) and every
// intermediate in VMEM. On the H100 one bf16 row at S=256, C=512 is 256 KB,
// more than the 227 KB of shared memory a block may use, so the work is cut
// into three launches instead:
//   (a) GEMM with the LN1 prologue: qkv = LN1(x) @ Wqkv (+ bias), (N, S, 3C);
//   (b) attention per (frame, head, 64-query tile): the head's S=256 keys and
//       values sit in shared memory, the 16 x 256 logits of each warp stay in
//       registers, softmax in fp32, probabilities rounded to bf16 and fed
//       straight from the logit registers into the PV product;
//   (c) GEMM with the epilogue + bproj + residual x.
// The (N, H, S, S) logits never reach device memory; qkv and the attention
// output make one round trip each. Bound: tensor-core operations
// (2 N S C (4C + 2S) FLOP: 10.7 GFLOP at N=16 against 134 MB moved at most),
// so the products run on mma.sync; the transposed-qkv layout of the TPU
// kernel was a Mosaic workaround and is not carried over.

#include "common.cuh"

using namespace tpu1x;

namespace {

constexpr int SB_S = 256;      // keys per head held in shared memory
constexpr int SB_D = 32;       // head_dim
constexpr int SB_QT = 64;      // queries per block: 4 warps x 16 rows
constexpr int SB_LD = SB_D + 8;

// qkv (N, S, 3C) -> out (N, S, C). grid (S / 64, H, N), 128 threads.
__global__ void __launch_bounds__(128)
    spatial_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                             int C, float scale) {
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
// ln_scale/ln_bias fp32 (C,) or null; qkv_buf (N, S, 3C) and attn_buf
// (N, S, C) are scratch. Requires S == 256, C == 32 * H, C % 64 == 0.
extern "C" int tpu1x_spatial_block(const void* x, const void* wqkv,
                                   const void* bqkv, const void* wproj,
                                   const void* bproj, const void* ln_scale,
                                   const void* ln_bias, void* qkv_buf,
                                   void* attn_buf, void* out, int N, int S,
                                   int C, int H, float scale, void* stream) {
  if (S != SB_S || C != H * SB_D || C % GBN) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GemmParams a = gemm_params(x, wqkv, qkv_buf, N * S, 3 * C, C);
  a.bias = static_cast<const bf16*>(bqkv);
  a.ln_scale = static_cast<const float*>(ln_scale);
  a.ln_bias = static_cast<const float*>(ln_bias);
  TPU1X_TRY(launch_gemm(a, s));
  spatial_attention_kernel<<<dim3(S / SB_QT, H, N), 128, 0, s>>>(
      static_cast<const bf16*>(qkv_buf), static_cast<bf16*>(attn_buf), C, scale);
  TPU1X_TRY(cudaGetLastError());
  GemmParams b = gemm_params(attn_buf, wproj, out, N * S, C, C);
  b.bias = static_cast<const bf16*>(bproj);
  b.resid = static_cast<const bf16*>(x);
  TPU1X_TRY(launch_gemm(b, s));
  return cudaSuccess;
}
