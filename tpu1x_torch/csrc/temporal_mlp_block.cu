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
// same arithmetic on more bytes. Each head's 32-channel dot product lives in
// four lanes (8 channels each, 16-byte loads), which takes the place of the
// TPU's 0/1 head matrix; the fp32 softmax over at most T + 2 logits stays in
// registers. Probabilities stay fp32 through PV, as the reference's do.

#include "common.cuh"

using namespace tpu1x;

namespace {

constexpr int TM_MAXT = 16;

// qkv (B, F, S, 3C); caches (T, L, B, S, C); attn (B, F, S, C);
// k_out/v_out (B, S, C) get frame 0's k and v, when they are not null.
// grid (S, B), C/8 threads.
template <int F>
__global__ void decode_attention_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ kc,
    const bf16* __restrict__ vc, const int* __restrict__ t_B,
    bf16* __restrict__ attn, bf16* __restrict__ k_out, bf16* __restrict__ v_out,
    int B, int S, int C, int T, int L, int layer, float scale) {
  const int s = blockIdx.x, b = blockIdx.y, c0 = threadIdx.x * 8;
  const int tb = max(0, min(t_B[b], T));
  const long ld = 3L * C;

  float q[F][8], ks[F][8], vs[F][8];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const bf16* row = qkv + ((long)(b * F + f) * S + s) * ld + c0;
    load8(row, q[f]);
    load8(row + C, ks[f]);
    load8(row + 2 * C, vs[f]);
    if (f == 0 && k_out != nullptr) {
      const long o = ((long)b * S + s) * C + c0;
      *reinterpret_cast<uint4*>(k_out + o) = *reinterpret_cast<const uint4*>(row + C);
      *reinterpret_cast<uint4*>(v_out + o) =
          *reinterpret_cast<const uint4*>(row + 2 * C);
    }
  }
  auto slot = [&](int t) { return ((((long)t * L + layer) * B + b) * S + s) * C + c0; };

  float lg[F][TM_MAXT], m[F];
#pragma unroll
  for (int f = 0; f < F; ++f) m[f] = -INFINITY;
#pragma unroll
  for (int j = 0; j < TM_MAXT; ++j) {
    if (j < tb) {
      float kf[8];
      load8(kc + slot(j), kf);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d += q[f][i] * kf[i];
        lg[f][j] = quad_sum(d) * scale;
        m[f] = fmaxf(m[f], lg[f][j]);
      }
    }
  }
  // in-pass logits: each frame against itself; with a pair, cur against prev
  float ls[F], lp = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) d += q[f][i] * ks[f][i];
    ls[f] = quad_sum(d) * scale;
    m[f] = fmaxf(m[f], ls[f]);
  }
  if (F == 2) {
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) d += q[F - 1][i] * ks[0][i];
    lp = quad_sum(d) * scale;
    m[F - 1] = fmaxf(m[F - 1], lp);
  }

  float den[F], es[F], ep = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    den[f] = 0.f;
#pragma unroll
    for (int j = 0; j < TM_MAXT; ++j) {
      if (j < tb) {
        lg[f][j] = __expf(lg[f][j] - m[f]);
        den[f] += lg[f][j];
      }
    }
    es[f] = __expf(ls[f] - m[f]);
  }
  if (F == 2) {
    ep = __expf(lp - m[F - 1]);
    den[F - 1] += ep;
  }
#pragma unroll
  for (int f = 0; f < F; ++f) den[f] += es[f];

  float acc[F][8];
#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[f][i] = 0.f;
#pragma unroll
  for (int j = 0; j < TM_MAXT; ++j) {
    if (j < tb) {
      float vf[8];
      load8(vc + slot(j), vf);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float p = lg[f][j] / den[f];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[f][i] += p * vf[i];
      }
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float p = es[f] / den[f];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[f][i] += p * vs[f][i];
  }
  if (F == 2) {
    const float p = ep / den[F - 1];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[F - 1][i] += p * vs[0][i];
  }
#pragma unroll
  for (int f = 0; f < F; ++f)
    store8(attn + ((long)(b * F + f) * S + s) * C + c0, acc[f]);
}

}  // namespace

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
  if ((frames != 1 && frames != 2) || T > TM_MAXT || C % 256 || F4 % GBN ||
      layer < 0 || layer >= L)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * frames * S;

  GemmParams a = gemm_params(x, wqkv, qkv_buf, M, 3 * C, C);
  a.bias = static_cast<const bf16*>(bqkv);
  TPU1X_TRY(launch_gemm(a, s));

  const dim3 grid(S, B);
  const bf16* qkv = static_cast<const bf16*>(qkv_buf);
  if (frames == 1)
    decode_attention_kernel<1><<<grid, C / 8, 0, s>>>(
        qkv, static_cast<const bf16*>(k_cache), static_cast<const bf16*>(v_cache),
        static_cast<const int*>(t_B), static_cast<bf16*>(attn_buf),
        static_cast<bf16*>(k_out), static_cast<bf16*>(v_out), B, S, C, T, L,
        layer, scale);
  else
    decode_attention_kernel<2><<<grid, C / 8, 0, s>>>(
        qkv, static_cast<const bf16*>(k_cache), static_cast<const bf16*>(v_cache),
        static_cast<const int*>(t_B), static_cast<bf16*>(attn_buf),
        static_cast<bf16*>(k_out), static_cast<bf16*>(v_out), B, S, C, T, L,
        layer, scale);
  TPU1X_TRY(cudaGetLastError());

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
