// Building blocks of the three training sub-layer kernels (spatial, temporal
// and MLP train blocks, forward and backward), which replace the Pallas
// kernels tpu1x/ops/spatial_train_block.py:_spatial_bwd,
// tpu1x/ops/temporal_train_block.py:_ttb_fwd/_ttb_bwd and
// tpu1x/ops/mlp_train_block.py:_mlp_fwd/_mlp_bwd.
//
// Each TPU kernel runs one sequential program per row with the row, the
// weights and fp32 weight-gradient accumulators resident in VMEM. Neither
// carries over: a (256, 512) bf16 row is more than a block's shared memory,
// and CUDA blocks run in parallel, so nothing accumulates "across the grid".
// Each block is therefore a fixed sequence of launches over all rows at once,
// sequenced by its wrapper in tpu1x_torch/ops/:
//   tpu1x_gemm90_train  the training forms of csrc/gemm_sm90.cuh (TMA,
//                  wgmma), which carry every weight product of the three
//                  blocks but the spatial block's qkv recompute (the
//                  serving instantiation, tpu1x_gemm_sm90 in
//                  spatial_block.cu, the forward's rounding): A B (with
//                  bias; the GELU, optionally keeping the pre-activation;
//                  the residual), A B^T (d_o, d_ao, d_g with the GELU'
//                  epilogue, d_xn in fp32, dx with the residual) and A^T B
//                  (the weight gradients: the reduction over all rows split
//                  into chunks, combined with fp32 atomics);
//   tpu1x_col_sum  bias gradients: column sums of a bf16 (rows, N) tensor in
//                  fp32, per-block partial sums combined with atomics;
//   tpu1x_ln_fwd   LayerNorm of each row (fp32 statistics, variance
//                  E[x^2] - E[x]^2) -> bf16, and the row's mean and rstd;
//   tpu1x_ln_bwd   dx = rstd (d_xhat - mean(d_xhat) - xhat mean(d_xhat xhat))
//                  + dout, and the LN scale / bias gradients (column sums,
//                  per-warp register sums combined with atomics).
// The attention parts are other sources' kernels: K9's forward and K10's
// backward (flash_attention.cu) for the spatial block, K4 and K6
// (temporal_attention.cu) for the temporal block.
// Buffers that atomics add into are zeroed by the wrapper on the same
// stream. Bounds: the GEMMs by tensor-core operations, the other three by
// device memory (each reads its rows once). Rows are 64-bit offsets
// ((long)row * C): the train step of GENIE_138M-S1024 (S = 1024) has 131072
// rows of 512. K11 (the spatial backward) takes any S that K9 and K10 take
// (64 to 4096, S % 64 == 0); its bound at GENIE_138M-S1024's (128, 1024,
// 512) is 1.58 TFLOP of products, 1.60 ms at 989 TFLOP/s (0.243 at S =
// 256).

#include "gemm_sm90.cuh"

using namespace tpu1x;

namespace {

constexpr int LN_MAXC = 1024;  // 4 chunks of 8 channels per lane

// x (rows, C) bf16 -> xn (rows, C) bf16, stats (rows, 2) fp32 = mean, rstd.
// One warp per row.
__global__ void ln_fwd_kernel(const bf16* __restrict__ x,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              bf16* __restrict__ xn, float* __restrict__ stats,
                              int rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* xr = x + (long)row * C;
  float f[LN_MAXC / 256][8];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAXC / 256; ++i) {
    const int c = i * 256 + lane * 8;
    if (c < C) {
      load8(xr + c, f[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += f[i][e];
        ss += f[i][e] * f[i][e];
      }
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / C;
  const float rs = rsqrtf(ss / C - mu * mu + eps);
  if (lane == 0) {
    stats[2 * row] = mu;
    stats[2 * row + 1] = rs;
  }
#pragma unroll
  for (int i = 0; i < LN_MAXC / 256; ++i) {
    const int c = i * 256 + lane * 8;
    if (c < C) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        f[i][e] = (f[i][e] - mu) * rs * scale[c + e] + bias[c + e];
      store8(xn + (long)row * C + c, f[i]);
    }
  }
}

// x, dout, dx (rows, C) bf16; d_xn (rows, C) fp32; stats from ln_fwd;
// dscale, dbias (C,) fp32, zeroed by the caller. Each warp walks
// rows_per_block / 8 rows and keeps its column sums in registers.
__global__ void __launch_bounds__(256)
    ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ stats,
                  const float* __restrict__ scale, const float* __restrict__ d_xn,
                  const bf16* __restrict__ dout, bf16* __restrict__ dx,
                  float* __restrict__ dscale, float* __restrict__ dbias, int rows,
                  int C, int rows_per_block) {
  __shared__ float red[2][LN_MAXC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < C; c += blockDim.x) red[0][c] = red[1][c] = 0.f;
  __syncthreads();
  float gs[LN_MAXC / 256][8], gb[LN_MAXC / 256][8], sc[LN_MAXC / 256][8];
#pragma unroll
  for (int i = 0; i < LN_MAXC / 256; ++i) {
    const int c = i * 256 + lane * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gs[i][e] = gb[i][e] = 0.f;
      sc[i][e] = c < C ? scale[c + e] : 0.f;
    }
  }
  const int r_end = min(rows, (blockIdx.x + 1) * rows_per_block);
  for (int row = blockIdx.x * rows_per_block + warp; row < r_end; row += 8) {
    const float mu = stats[2 * row], rs = stats[2 * row + 1];
    float xh[LN_MAXC / 256][8], dh[LN_MAXC / 256][8];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < LN_MAXC / 256; ++i) {
      const int c = i * 256 + lane * 8;
      if (c < C) {
        load8(x + (long)row * C + c, xh[i]);
        const float4* d4 = reinterpret_cast<const float4*>(d_xn + (long)row * C + c);
        const float4 a = d4[0], b = d4[1];
        const float d[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          xh[i][e] = (xh[i][e] - mu) * rs;
          gs[i][e] += d[e] * xh[i][e];
          gb[i][e] += d[e];
          dh[i][e] = d[e] * sc[i][e];
          m1 += dh[i][e];
          m2 += dh[i][e] * xh[i][e];
        }
      }
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
#pragma unroll
    for (int i = 0; i < LN_MAXC / 256; ++i) {
      const int c = i * 256 + lane * 8;
      if (c < C) {
        float o[8];
        load8(dout + (long)row * C + c, o);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] += rs * (dh[i][e] - m1 - xh[i][e] * m2);
        store8(dx + (long)row * C + c, o);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < LN_MAXC / 256; ++i) {
    const int c = i * 256 + lane * 8;
    if (c < C) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        atomicAdd(&red[0][c + e], gs[i][e]);
        atomicAdd(&red[1][c + e], gb[i][e]);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    atomicAdd(dscale + c, red[0][c]);
    atomicAdd(dbias + c, red[1][c]);
  }
}

// out (N,) fp32 += column sums of x (rows, N) bf16 at row stride ld.
// grid (ceil(N / 256), row chunks), 256 threads: a warp covers 256 columns
// of one row per step.
__global__ void __launch_bounds__(256)
    col_sum_kernel(const bf16* __restrict__ x, float* __restrict__ out, int rows,
                   int N, long ld, int rows_per_block) {
  __shared__ float red[256];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  red[threadIdx.x] = 0.f;
  __syncthreads();
  const int c = blockIdx.x * 256 + lane * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c < N) {
    const int r_end = min(rows, (blockIdx.y + 1) * rows_per_block);
    for (int row = blockIdx.y * rows_per_block + warp; row < r_end; row += 8) {
      float f[8];
      load8(x + (long)row * ld + c, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += f[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) atomicAdd(&red[lane * 8 + e], acc[e]);
  }
  __syncthreads();
  const int oc = blockIdx.x * 256 + threadIdx.x;
  if (oc < N) atomicAdd(out + oc, red[threadIdx.x]);
}

}  // namespace

// The training forms of csrc/gemm_sm90.cuh, all operands contiguous: form G9_NN (A (M, K), B
// (K, N)), G9_NT (B stored (N, K)) or G9_TN (A stored (K, M)). TN adds
// A^T B into Cf (M, N) fp32, zeroed by the caller on the same stream, the
// reduction over K in as many chunks as fill the card; act
// ACT_NONE, C, pre, bias, resid and aux null. NT with Cf stores the fp32
// accumulators; act ACT_NONE, the bf16 pointers null. Otherwise the bf16
// training chain into C (M, N): + bias (N,) if not null, GELU (NN: act
// ACT_GELU_TANH or ACT_GELU_ERF) or times GELU'(aux (M, N)) (NT: act
// ACT_DGELU_TANH or ACT_DGELU_ERF), one rounding, + resid (M, N) if not
// null, rounded; pre (NN), if not null, receives the rounded acc + bias.
// At most one of pre, aux and resid: the epilogue stages it beside C.
extern "C" int tpu1x_gemm90_train(const void* A, const void* B, void* C,
                                  void* pre, void* Cf, const void* bias,
                                  const void* resid, const void* aux, int M,
                                  int N, int K, int form, int act,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % G9_BN || K % G9_BK || M < 0 || form < G9_NN || form > G9_TN ||
      act < ACT_NONE || act > ACT_DGELU_ERF)
    return cudaErrorInvalidValue;
  // the combinations that have an instantiation
  const bool dg = act == ACT_DGELU_TANH || act == ACT_DGELU_ERF;
  const bool no_epilogue = !C && !pre && !bias && !resid && !aux &&
                           act == ACT_NONE;
  bool ok;
  if (form == G9_TN)
    ok = Cf && no_epilogue && M % 8 == 0;
  else if (Cf)
    ok = form == G9_NT && no_epilogue;
  else
    ok = C && dg == (aux != nullptr) && (!pre || form == G9_NN) &&
         (form == G9_NN ? !dg : act == ACT_NONE || dg) &&
         (pre != nullptr) + (aux != nullptr) + (resid != nullptr) <= 1;
  if (!ok) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  // tc, t2: the staged epilogue's tiles (unread by the other epilogues)
  CUtensorMap ta, tb, tc = {}, t2 = {};
  TPU1X_TRY(form == G9_TN ? g9_map(&ta, A, K, M, 64)
                          : g9_map(&ta, A, M, K, G9_BM));
  TPU1X_TRY(form == G9_NT ? g9_map(&tb, B, N, K, 64) : g9_map(&tb, B, K, N, 64));
  if (C) TPU1X_TRY(g9_map(&tc, C, M, N, 64));
  const void* second = pre ? pre : aux ? aux : resid;
  if (second) TPU1X_TRY(g9_map(&t2, second, M, N, 64));
  Gemm90Args a{static_cast<bf16*>(C), static_cast<const bf16*>(bias),
               static_cast<const bf16*>(resid), M, N, K,
               static_cast<bf16*>(pre), static_cast<const bf16*>(aux),
               static_cast<float*>(Cf), 1};
  const int tiles = (M + G9_BM - 1) / G9_BM * (N / G9_BN);
  if (form == G9_TN)
    return launch_gemm90_act<ACT_NONE, G9_TN, G9_RED>(ta, tb, a, tiles, s,
                                                      tc, t2);
  if (Cf)
    return launch_gemm90_act<ACT_NONE, G9_NT, G9_F32>(ta, tb, a, tiles, s, tc,
                                                      t2);
  if (form == G9_NT) {
    if (act == ACT_DGELU_TANH)
      return launch_gemm90_act<ACT_DGELU_TANH, G9_NT, G9_FUSED>(ta, tb, a,
                                                                tiles, s, tc,
                                                                t2);
    if (act == ACT_DGELU_ERF)
      return launch_gemm90_act<ACT_DGELU_ERF, G9_NT, G9_FUSED>(ta, tb, a,
                                                               tiles, s, tc,
                                                               t2);
    return launch_gemm90_act<ACT_NONE, G9_NT, G9_FUSED>(ta, tb, a, tiles, s,
                                                        tc, t2);
  }
  if (act == ACT_GELU_TANH)
    return launch_gemm90_act<ACT_GELU_TANH, G9_NN, G9_FUSED>(ta, tb, a, tiles,
                                                             s, tc, t2);
  if (act == ACT_GELU_ERF)
    return launch_gemm90_act<ACT_GELU_ERF, G9_NN, G9_FUSED>(ta, tb, a, tiles,
                                                            s, tc, t2);
  return launch_gemm90_act<ACT_NONE, G9_NN, G9_FUSED>(ta, tb, a, tiles, s, tc,
                                                      t2);
}

// Requires N % 8 == 0, ld % 8 == 0.
extern "C" int tpu1x_col_sum(const void* x, void* out, int rows, int N, long ld,
                             void* stream) {
  if (N % 8 || ld % 8) return cudaErrorInvalidValue;
  const int rows_per_block = 256;
  col_sum_kernel<<<dim3((N + 255) / 256, (rows + rows_per_block - 1) / rows_per_block),
                   256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<float*>(out), rows, N, ld,
      rows_per_block);
  return cudaGetLastError();
}

// Requires C % 8 == 0, C <= 1024.
extern "C" int tpu1x_ln_fwd(const void* x, const void* scale, const void* bias,
                            void* xn, void* stats, int rows, int C, float eps,
                            void* stream) {
  if (C % 8 || C > LN_MAXC) return cudaErrorInvalidValue;
  ln_fwd_kernel<<<(rows + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<bf16*>(xn),
      static_cast<float*>(stats), rows, C, eps);
  return cudaGetLastError();
}

extern "C" int tpu1x_ln_bwd(const void* x, const void* stats, const void* scale,
                            const void* d_xn, const void* dout, void* dx,
                            void* dscale, void* dbias, int rows, int C,
                            void* stream) {
  if (C % 8 || C > LN_MAXC) return cudaErrorInvalidValue;
  const int rows_per_block = 64;
  ln_bwd_kernel<<<(rows + rows_per_block - 1) / rows_per_block, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(scale), static_cast<const float*>(d_xn),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dx),
      static_cast<float*>(dscale), static_cast<float*>(dbias), rows, C,
      rows_per_block);
  return cudaGetLastError();
}
