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

constexpr int LN_MAXV = 8;  // chunks of 8 channels a lane: a warp's row
                            // up to C = 2048, a pair's up to MAX_C
constexpr int LN_WARPS = 8;  // warps of a block (256 threads)

// The row passes take G warps a row: one up to C = LN_MAXV * 256 = 2048, a
// pair of neighbouring warps past it (up to MAX_C = 4096), so that a lane
// holds at most LN_MAXV chunks at every width (V = 12 or 16 in one warp
// would spill); the pair's two sums of a row meet in shared memory
// (`row_sums`). Lane p of a group, p = 32 (warp % G) + lane, holds chunk i
// of channels 256 G i + 8 p .. + 7; at G = 1 the arithmetic of one warp a
// row.

// x (rows, C) bf16 -> xn (rows, C) bf16, stats (rows, 2) fp32 = mean, rstd.
// One group of G warps per row, a lane holding V = ceil(C / (256 G))
// chunks of 8 channels.
template <int V, int G>
__global__ void ln_fwd_kernel(const bf16* __restrict__ x,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              bf16* __restrict__ xn, float* __restrict__ stats,
                              int rows, int C, float eps) {
  const int warp = threadIdx.x >> 5;
  const int p = (warp % G) * 32 + (threadIdx.x & 31);
  const int row = blockIdx.x * (LN_WARPS / G) + warp / G;
  if (row >= rows) return;
  const bf16* xr = x + (long)row * C;
  float f[V][8];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = i * 256 * G + p * 8;
    if (c < C) {
      load8(xr + c, f[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += f[i][e];
        ss += f[i][e] * f[i][e];
      }
    }
  }
  row_sums<G, LN_WARPS>(s, ss, 0);
  const float mu = s / C;
  const float rs = rsqrtf(ss / C - mu * mu + eps);
  if (p == 0) {
    stats[2 * row] = mu;
    stats[2 * row + 1] = rs;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = i * 256 * G + p * 8;
    if (c < C) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        f[i][e] = (f[i][e] - mu) * rs * scale[c + e] + bias[c + e];
      store8(xn + (long)row * C + c, f[i]);
    }
  }
}

// x, dout, dx (rows, C) bf16; d_xn (rows, C) fp32; stats from ln_fwd;
// dscale, dbias (C,) fp32, zeroed by the caller. Each group of G warps
// walks rows_per_block G / 8 rows, a lane holding V = ceil(C / (256 G))
// chunks of 8 channels, and keeps its column sums in registers; the block
// adds them into `red` (2 C fp32 of dynamic shared memory), then into
// dscale and dbias with atomics. Up to V = 4 at G = 1 (C <= 1024) a lane
// also holds gamma and the row (x-hat and the scaled gradient) in
// registers, five V x 8 arrays. Above, that is 320 fp32 a lane at V = 8,
// past the 255 registers: gamma lies in shared memory (C fp32 after `red`,
// 24 KB in all at C = 2048, 48 KB at 4096) and the row is read twice, once
// for the sums (the column sums and the row's two means, which dx needs
// whole) and once for dx, the second read from L1 (a warp's row of x and
// d_xn is 12 KB at C = 2048; a pair's 24 KB at 4096); a lane holds the two
// arrays of column sums.
// ptxas (sm_90a), registers a thread for V = 1 .. 8: ln_fwd_kernel 32, 39,
// 48, 54, 62, 70, 76, 85; ln_bwd_kernel 64, 112, 156, 192, 128, 144, 159,
// 171 (V = 4 at the 54 and 192 of the single C <= 1024 forms it replaced);
// no spills.
template <int V, int G>
__global__ void __launch_bounds__(256)
    ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ stats,
                  const float* __restrict__ scale, const float* __restrict__ d_xn,
                  const bf16* __restrict__ dout, bf16* __restrict__ dx,
                  float* __restrict__ dscale, float* __restrict__ dbias, int rows,
                  int C, int rows_per_block) {
  constexpr bool kHold = V <= 4 && G == 1;  // gamma and the row in registers
  extern __shared__ float red[];  // [2][C] column sums, then gamma (C)
  float* const sg = red + 2 * C;
  const int warp = threadIdx.x >> 5;
  const int p = (warp % G) * 32 + (threadIdx.x & 31);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    red[c] = red[C + c] = 0.f;
    if constexpr (!kHold) sg[c] = scale[c];
  }
  __syncthreads();
  float gs[V][8], gb[V][8], sc[kHold ? V : 1][8];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = i * 256 * G + p * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gs[i][e] = gb[i][e] = 0.f;
      if constexpr (kHold) sc[i][e] = c < C ? scale[c + e] : 0.f;
    }
  }
  // x-hat and d_xn of the 8 channels from c of a row
  auto load_row = [&](int row, int c, float mu, float rs, float* xh,
                      float* d) {
    load8(x + (long)row * C + c, xh);
    const float4* d4 = reinterpret_cast<const float4*>(d_xn + (long)row * C + c);
    const float4 a = d4[0], b = d4[1];
    d[0] = a.x, d[1] = a.y, d[2] = a.z, d[3] = a.w;
    d[4] = b.x, d[5] = b.y, d[6] = b.z, d[7] = b.w;
#pragma unroll
    for (int e = 0; e < 8; ++e) xh[e] = (xh[e] - mu) * rs;
  };
  const int r_end = min(rows, (blockIdx.x + 1) * rows_per_block);
  int parity = 0;
  for (int row = blockIdx.x * rows_per_block + warp / G; row < r_end;
       row += LN_WARPS / G, parity ^= 1) {
    const float mu = stats[2 * row], rs = stats[2 * row + 1];
    float m1 = 0.f, m2 = 0.f;
    if constexpr (kHold) {
      float xh[V][8], dh[V][8];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = i * 256 + p * 8;
        if (c < C) {
          float d[8];
          load_row(row, c, mu, rs, xh[i], d);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
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
      for (int i = 0; i < V; ++i) {
        const int c = i * 256 + p * 8;
        if (c < C) {
          float o[8];
          load8(dout + (long)row * C + c, o);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] += rs * (dh[i][e] - m1 - xh[i][e] * m2);
          store8(dx + (long)row * C + c, o);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = i * 256 * G + p * 8;
        if (c < C) {
          float xh[8], d[8];
          load_row(row, c, mu, rs, xh, d);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            gs[i][e] += d[e] * xh[e];
            gb[i][e] += d[e];
            const float dh = d[e] * sg[c + e];
            m1 += dh;
            m2 += dh * xh[e];
          }
        }
      }
      row_sums<G, LN_WARPS>(m1, m2, parity);
      m1 /= C;
      m2 /= C;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = i * 256 * G + p * 8;
        if (c < C) {
          float xh[8], d[8], o[8];
          load_row(row, c, mu, rs, xh, d);
          load8(dout + (long)row * C + c, o);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] += rs * (d[e] * sg[c + e] - m1 - xh[e] * m2);
          store8(dx + (long)row * C + c, o);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = i * 256 * G + p * 8;
    if (c < C) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        atomicAdd(&red[c + e], gs[i][e]);
        atomicAdd(&red[C + c + e], gb[i][e]);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    atomicAdd(dscale + c, red[c]);
    atomicAdd(dbias + c, red[C + c]);
  }
}

typedef void (*LnFwd)(const bf16*, const float*, const float*, bf16*, float*,
                      int, int, float);
typedef void (*LnBwd)(const bf16*, const float*, const float*, const float*,
                      const bf16*, bf16*, float*, float*, int, int, int);
// one warp a row, V = 1 .. LN_MAXV; then a pair of warps a row, V = 5 ..
// LN_MAXV (C = 2056 .. MAX_C)
constexpr int LN_FORMS = LN_MAXV + 4;
const LnFwd kLnFwd[LN_FORMS] = {
    ln_fwd_kernel<1, 1>, ln_fwd_kernel<2, 1>, ln_fwd_kernel<3, 1>,
    ln_fwd_kernel<4, 1>, ln_fwd_kernel<5, 1>, ln_fwd_kernel<6, 1>,
    ln_fwd_kernel<7, 1>, ln_fwd_kernel<8, 1>, ln_fwd_kernel<5, 2>,
    ln_fwd_kernel<6, 2>, ln_fwd_kernel<7, 2>, ln_fwd_kernel<8, 2>};
const LnBwd kLnBwd[LN_FORMS] = {
    ln_bwd_kernel<1, 1>, ln_bwd_kernel<2, 1>, ln_bwd_kernel<3, 1>,
    ln_bwd_kernel<4, 1>, ln_bwd_kernel<5, 1>, ln_bwd_kernel<6, 1>,
    ln_bwd_kernel<7, 1>, ln_bwd_kernel<8, 1>, ln_bwd_kernel<5, 2>,
    ln_bwd_kernel<6, 2>, ln_bwd_kernel<7, 2>, ln_bwd_kernel<8, 2>};

// The form of width C: its slot in kLnFwd / kLnBwd, its chunks a lane and
// the warps of a row.
int ln_form(int C, int* v, int* warps_a_row) {
  const bool pair = C > LN_MAXV * 256;
  *warps_a_row = pair ? 2 : 1;
  *v = pair ? (C + 511) / 512 : (C + 255) / 256;
  return pair ? LN_MAXV + *v - 5 : *v - 1;
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
// (K, N)), G9_NT (B stored (N, K)) or G9_TN (A stored (K, M)); N and K
// multiples of 8 (g9_shape_ok), a tile overhanging either. TN adds
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
  if (!g9_shape_ok(M, N, K) || form < G9_NN || form > G9_TN ||
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
  const int tiles = (M + G9_BM - 1) / G9_BM * g9_n_tiles(N);
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

// Requires C % 8 == 0, 0 < C <= MAX_C (4096: LN_MAXV chunks of 8 channels
// a lane, one warp a row up to 2048, a pair past it).
extern "C" int tpu1x_ln_fwd(const void* x, const void* scale, const void* bias,
                            void* xn, void* stats, int rows, int C, float eps,
                            void* stream) {
  if (C <= 0 || C % 8 || C > MAX_C) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  int v = 0, G = 1;
  const int form = ln_form(C, &v, &G);
  const int per_block = LN_WARPS / G;
  kLnFwd[form]<<<(rows + per_block - 1) / per_block, 32 * LN_WARPS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<bf16*>(xn),
      static_cast<float*>(stats), rows, C, eps);
  return cudaGetLastError();
}

extern "C" int tpu1x_ln_bwd(const void* x, const void* stats, const void* scale,
                            const void* d_xn, const void* dout, void* dx,
                            void* dscale, void* dbias, int rows, int C,
                            void* stream) {
  if (C <= 0 || C % 8 || C > MAX_C) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  int v = 0, G = 1;
  const int form = ln_form(C, &v, &G);
  const int rows_per_block = 64;
  const int smem = (v <= 4 && G == 1 ? 2 : 3) * C * (int)sizeof(float);
  // past 48 KB of shared memory (C > 4088 with the pair's sums) only with
  // the kernel's limit raised, once a process for each form
  static int limit[LN_FORMS] = {};
  if (smem > limit[form]) {
    TPU1X_TRY(cudaFuncSetAttribute(
        kLnBwd[form], cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    limit[form] = smem;
  }
  kLnBwd[form]<<<(rows + rows_per_block - 1) / rows_per_block, 32 * LN_WARPS,
                 smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(scale), static_cast<const float*>(d_xn),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dx),
      static_cast<float*>(dscale), static_cast<float*>(dbias), rows, C,
      rows_per_block);
  return cudaGetLastError();
}
