// Row LayerNorm (K5), shared by csrc/layer_norm.cu, which binds it as
// `layer_norm`, and csrc/spatial_block.cu, whose pre-LN pass it is: bf16 in
// and out, fp32 statistics with the variance taken as E[x^2] - E[x]^2 (the
// JAX package's formula, not torch's).
//
// Replaces the Pallas kernel tpu1x/ops/layernorm.py:layer_norm (_kernel).
// Bound on the H100: device memory, one read and one write of each row (67
// MB at the prefill's 32768 x 512, 0.020 ms at 3.35 TB/s; 403 MB, 0.120
// ms, at 32768 x 3072); the arithmetic, 7 fp32 operations a value, is a
// tenth of that. Reaching the bytes' rate takes many loads in flight on
// every SM (one row a warp, with registers for C = 2048 whatever C,
// reaches a third of it), so:
// - the kernel is templated on V, the 16-byte chunks of 8 channels a lane
//   holds, ceil(C / 256): at C = 512 a lane holds 2 chunks, and only the
//   last chunk of a row can lie past C and carries a guard;
// - a warp walks rows (row, row + the grid's warps, ...) and issues the next
//   row's loads before it reduces the current one, so two rows a warp are
//   in flight; x is read with the streaming hint (read once);
// - up to V = 4 (C <= 1024) gamma and beta are loaded once a warp as float4
//   and kept in registers; above, they come through L1 with each row, which
//   keeps the registers of V = 8 below spilling;
// - past C = 2048 (LN_MAXV chunks a lane) a row is G = 2 warps', a pair
//   of neighbouring warps walking rows as one warp does, each lane with V =
//   ceil(C / 512) chunks: the registers of the V <= 8 forms up to MAX_C =
//   4096 (V = 12 or 16 in one warp would spill), the row's two sums added
//   through shared memory after a barrier of the pair (`row_sums`);
// - the grid is the blocks the card keeps resident (fewer for few rows);
//   loads and stores are 16 bytes.
// Any row count; C % 8 == 0, C <= MAX_C.
// ptxas (sm_90a): registers a thread for V = 1 .. 8: 46, 76, 106, 128, 80,
// 134, 132, 132 (V = 2, the GENIE widths' C = 512: 76, three blocks of 256
// threads an SM); no spills, no shared memory.

#pragma once

#include "common.cuh"

namespace tpu1x {

constexpr int LN_THREADS = 256;
constexpr int LN_WARPS = LN_THREADS / 32;
constexpr int LN_MAXV = 8;  // chunks of 8 channels a lane: a warp's row
                            // up to C = 2048, a pair's up to MAX_C

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// G warps a row (1, or 2 past LN_MAXV * 256 channels): lane p of a group,
// p = 32 (warp % G) + lane, holds chunk j of channels (32 G j + p) * 8 ..
// + 7; at G = 1 the arithmetic of one warp a row.
template <int V, int G>
__global__ void __launch_bounds__(LN_THREADS)
    layer_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, bf16* __restrict__ y,
                      int rows, int C, float eps) {
  constexpr bool kHold = V <= 4;  // gamma and beta in registers
  constexpr int GROUPS = LN_WARPS / G;  // rows of a block at a time
  const int warp = threadIdx.x >> 5;
  const int p = (warp % G) * 32 + (threadIdx.x & 31);
  const int groups = gridDim.x * GROUPS;
  int row = blockIdx.x * GROUPS + warp / G;
  if (row >= rows) return;  // the whole group leaves together
  // chunk j of a lane: channels (j * 32 G + p) * 8 .. + 7
  auto inside = [&](int j) { return j < V - 1 || (j * 32 * G + p) * 8 < C; };

  float4 gv[kHold ? V : 1][2], bv[kHold ? V : 1][2];
  if constexpr (kHold) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (inside(j)) {
        const int c = (j * 32 * G + p) * 8;
        gv[j][0] = __ldg(reinterpret_cast<const float4*>(g + c));
        gv[j][1] = __ldg(reinterpret_cast<const float4*>(g + c) + 1);
        bv[j][0] = __ldg(reinterpret_cast<const float4*>(b + c));
        bv[j][1] = __ldg(reinterpret_cast<const float4*>(b + c) + 1);
      }
    }
  }

  uint4 cur[V], nxt[V];
  auto load = [&](uint4* dst, int r) {
    const bf16* xr = x + (long)r * C;
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (inside(j))
        dst[j] = __ldcs(
            reinterpret_cast<const uint4*>(xr + (j * 32 * G + p) * 8));
  };
  load(cur, row);
  for (int parity = 0;; parity ^= 1) {
    const int next = row + groups;
    if (next < rows) load(nxt, next);
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (inside(j)) {
        float f[8];
        unpack8(cur[j], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s += f[i];
          ss += f[i] * f[i];
        }
      }
    }
    row_sums<G, LN_WARPS>(s, ss, parity);
    const float mu = s / C;
    const float rs = rsqrtf(ss / C - mu * mu + eps);
    bf16* yr = y + (long)row * C;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (inside(j)) {
        const int c = (j * 32 * G + p) * 8;
        float4 gg[2], bb[2];
        if constexpr (kHold) {
          gg[0] = gv[j][0], gg[1] = gv[j][1], bb[0] = bv[j][0], bb[1] = bv[j][1];
        } else {
          gg[0] = __ldg(reinterpret_cast<const float4*>(g + c));
          gg[1] = __ldg(reinterpret_cast<const float4*>(g + c) + 1);
          bb[0] = __ldg(reinterpret_cast<const float4*>(b + c));
          bb[1] = __ldg(reinterpret_cast<const float4*>(b + c) + 1);
        }
        const float* gf = reinterpret_cast<const float*>(gg);
        const float* bf = reinterpret_cast<const float*>(bb);
        float f[8];
        unpack8(cur[j], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = (f[i] - mu) * rs * gf[i] + bf[i];
        store8(yr + c, f);
      }
    }
    if (next >= rows) break;
    row = next;
#pragma unroll
    for (int j = 0; j < V; ++j) cur[j] = nxt[j];
  }
}

typedef void (*LnKernel)(const bf16*, const float*, const float*, bf16*, int,
                         int, float);
// one warp a row, V = 1 .. LN_MAXV; then a pair of warps a row, V = 5 ..
// LN_MAXV (C = 2056 .. MAX_C)
constexpr int LN_FORMS = LN_MAXV + 4;
static const LnKernel kLnKernels[LN_FORMS] = {
    layer_norm_kernel<1, 1>, layer_norm_kernel<2, 1>, layer_norm_kernel<3, 1>,
    layer_norm_kernel<4, 1>, layer_norm_kernel<5, 1>, layer_norm_kernel<6, 1>,
    layer_norm_kernel<7, 1>, layer_norm_kernel<8, 1>, layer_norm_kernel<5, 2>,
    layer_norm_kernel<6, 2>, layer_norm_kernel<7, 2>, layer_norm_kernel<8, 2>};

// The form of width C: its slot in kLnKernels, and the warps of a row.
static inline int ln_form(int C, int* warps_a_row) {
  const bool pair = C > LN_MAXV * 256;
  *warps_a_row = pair ? 2 : 1;
  return pair ? LN_MAXV + (C + 511) / 512 - 5 : (C + 255) / 256 - 1;
}

// x, y (rows, C) bf16; scale, bias (C,) fp32, all 16-byte aligned. Requires
// C % 8 == 0, C <= MAX_C.
static inline cudaError_t launch_layer_norm(const void* x, const void* scale,
                                     const void* bias, void* y, int rows,
                                     int C, float eps, cudaStream_t stream) {
  if (C <= 0 || C % 8 || C > MAX_C) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  int G = 1;
  const int form = ln_form(C, &G);
  const LnKernel kernel = kLnKernels[form];
  // the resident blocks of the card, found once a process for each form
  static int resident[LN_FORMS] = {};
  if (resident[form] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    TPU1X_TRY(cudaGetDevice(&dev));
    TPU1X_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    TPU1X_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            LN_THREADS, 0));
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[form] = per_sm * sms;
  }
  const int per_block = LN_WARPS / G;
  const int need = (rows + per_block - 1) / per_block;
  kernel<<<need < resident[form] ? need : resident[form], LN_THREADS, 0,
           stream>>>(static_cast<const bf16*>(x),
                     static_cast<const float*>(scale),
                     static_cast<const float*>(bias), static_cast<bf16*>(y),
                     rows, C, eps);
  return cudaGetLastError();
}

// ---- the qk-LayerNorm of the qk_norm models (K1's qk-LN form) ----
//
// The LN over head_dim D of every head row of q and of k, in place in a
// (tokens, 3C) qkv product whose q and k thirds lie side by side: a
// token's first 2C values are 2 C / D rows of D channels, one pair of (D,)
// parameters shared by q, k and every head. The arithmetic of the row
// kernel above (fp32 statistics, E[x^2] - E[x]^2, the result rounded to
// bf16), at row length D: a lane holds one 16-byte chunk of 8 channels,
// D / 8 neighbouring lanes a row, reduced by shuffles among them. Bound:
// device memory, the q and k thirds read and written once (16.8 MB at N =
// 16 frames of 256 tokens, C = 512: 5 us at 3.35 TB/s), whatever D. A warp
// keeps HN_UNROLL chunks a lane in flight, the grid is every resident
// block. D = 32, 64 or 128 (4, 8 or 16 lanes a row); ptxas (sm_90a): 64
// registers at each, no spills. At D = 72 a row is nine chunks, which no
// power of two of lanes holds: a lane holds three (24 channels), a row is
// three neighbouring lanes, a warp ten rows on lanes 0-29 (30 and 31 idle),
// and the three parts are summed by shuffles from named lanes, in the same
// order in each lane of the row (the same bits in all three); two units
// of three chunks a lane in flight.
constexpr int HN_UNROLL = 4;

template <int D>
struct HnShape {
  static constexpr int CH = D == 72 ? 3 : 1;        // 16-byte chunks a lane
  static constexpr int LANES = D / (8 * CH);        // lanes a head row
  static constexpr int USED = 32 / LANES * LANES;   // lanes of a warp with rows
  static constexpr int UNROLL = D == 72 ? 2 : HN_UNROLL;  // units in flight
};

template <int D>
__global__ void __launch_bounds__(LN_THREADS)
    head_norm_kernel(bf16* __restrict__ qkv, const float* __restrict__ g,
                     const float* __restrict__ b, long units, int C,
                     float eps) {
  using Sh = HnShape<D>;
  constexpr int CH = Sh::CH, LANES = Sh::LANES, USED = Sh::USED;
  constexpr int U = Sh::UNROLL, W = 8 * CH;  // channels a unit
  const int lane = threadIdx.x & 31, c8 = (lane % LANES) * W;
  const int per_token = 2 * C / W;  // units of a token's q and k
  float gf[W], bf[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    gf[i] = __ldg(g + c8 + i);
    bf[i] = __ldg(b + c8 + i);
  }
  const long warp = ((long)blockIdx.x * LN_THREADS + threadIdx.x) >> 5;
  const long stride = (long)gridDim.x * (LN_THREADS / 32) * USED * U;
  for (long base = warp * USED * U; base < units; base += stride) {
    uint4 u[U][CH];
    bf16* at[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long i = base + j * USED + lane;
      at[j] = qkv + (i / per_token) * 3 * C + (i % per_token) * W;
#pragma unroll
      for (int c = 0; c < CH; ++c)
        u[j][c] = lane < USED && i < units
                      ? __ldcs(reinterpret_cast<const uint4*>(at[j]) + c)
                      : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      float f[W], s = 0.f, ss = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) unpack8(u[j][c], f + 8 * c);
#pragma unroll
      for (int i = 0; i < W; ++i) {
        s += f[i];
        ss += f[i] * f[i];
      }
      if constexpr (LANES == 3) {
        const int r0 = lane - lane % 3;  // the row's first lane
        s = (__shfl_sync(0xffffffffu, s, r0) +
             __shfl_sync(0xffffffffu, s, r0 + 1)) +
            __shfl_sync(0xffffffffu, s, r0 + 2);
        ss = (__shfl_sync(0xffffffffu, ss, r0) +
              __shfl_sync(0xffffffffu, ss, r0 + 1)) +
             __shfl_sync(0xffffffffu, ss, r0 + 2);
      } else {
#pragma unroll
        for (int x = 1; x < LANES; x <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, x);
          ss += __shfl_xor_sync(0xffffffffu, ss, x);
        }
      }
      const float mu = s / D;
      const float rs = rsqrtf(ss / D - mu * mu + eps);
#pragma unroll
      for (int i = 0; i < W; ++i) f[i] = (f[i] - mu) * rs * gf[i] + bf[i];
      if (lane < USED && base + j * USED + lane < units) {
#pragma unroll
        for (int c = 0; c < CH; ++c) store8(at[j] + 8 * c, f + 8 * c);
      }
    }
  }
}

// qkv (tokens, 3C) bf16: its q and k thirds normalised in place over each
// head row of D channels; scale, bias (D,) fp32. Requires D in {32, 64, 72,
// 128}, C % D == 0 and a 16-byte aligned qkv.
static inline cudaError_t launch_head_norm(void* qkv, const void* scale,
                                           const void* bias, int tokens,
                                           int C, int D, float eps,
                                           cudaStream_t stream) {
  if ((D != 32 && D != 64 && D != 72 && D != 128) || C % D)
    return cudaErrorInvalidValue;
  typedef void (*HnKernel)(bf16*, const float*, const float*, long, int,
                           float);
  const int slot = D == 32 ? 0 : D == 64 ? 1 : D == 72 ? 2 : 3;
  static const HnKernel kernels[4] = {head_norm_kernel<32>,
                                      head_norm_kernel<64>,
                                      head_norm_kernel<72>,
                                      head_norm_kernel<128>};
  static const int used[4] = {HnShape<32>::USED, HnShape<64>::USED,
                              HnShape<72>::USED, HnShape<128>::USED};
  static const int unroll[4] = {HnShape<32>::UNROLL, HnShape<64>::UNROLL,
                                HnShape<72>::UNROLL, HnShape<128>::UNROLL};
  const HnKernel kernel = kernels[slot];
  // a lane's units: 16-byte chunks, or three of them at D = 72
  const long units = (long)tokens * 2 * C / (D == 72 ? 24 : 8);
  if (units == 0) return cudaSuccess;
  // the resident blocks of the card, found once a process for each D
  static int resident[4] = {0, 0, 0, 0};
  int& res = resident[slot];
  if (res == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    TPU1X_TRY(cudaGetDevice(&dev));
    TPU1X_TRY(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    TPU1X_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            LN_THREADS, 0));
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    res = per_sm * sms;
  }
  const long per_block = (long)(LN_THREADS / 32) * used[slot] * unroll[slot];
  const long need = (units + per_block - 1) / per_block;
  kernel<<<need < res ? (int)need : res, LN_THREADS, 0, stream>>>(
      static_cast<bf16*>(qkv), static_cast<const float*>(scale),
      static_cast<const float*>(bias), units, C, eps);
  return cudaGetLastError();
}

}  // namespace tpu1x
