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
// The backward of the attention part (tpu1x_spatial_attention_bwd below)
// serves the spatial train block, which replaces the Pallas kernel
// tpu1x/ops/spatial_train_block.py:_spatial_bwd (_bwd_kernel); its products
// with the weights go through the shared GEMM (csrc/train_block.cu) and are
// sequenced by tpu1x_torch/ops/spatial_train_block.py.

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

// Backward of the attention above for one (frame, head) per block:
// qkv (N, S, 3C), d_o (N, S, C) the gradient of the attention output ->
// dqkv (N, S, 3C) and o (N, S, C), the attention output recomputed for
// dWproj. grid (H, N), 256 threads, dynamic shared memory SBB_SMEM.
//
// The head's q, k, v and d_o (4 x 256 x 32 bf16) sit in shared memory. The
// S x S probabilities are recomputed and never leave registers, in two
// phases that need no transpose of p or ds:
//   A  each warp owns 2 x 16 query rows: logits and softmax as the forward,
//      o = p v, delta = sum_d d_o o (= sum_k p dp), then per 16 keys
//      dp = d_o v^T, ds = p (dp - delta) scale, dq += ds k; it leaves each
//      row's max, 1 / sum and delta in shared memory;
//   B  each warp owns 2 x 16 key rows and recomputes the transposed tiles
//      p^T = exp(k q^T scale - max) / sum and ds^T from those statistics,
//      for dv += p^T d_o and dk += ds^T q.
// p and ds are rounded to bf16 before their products, as in the reference.
// Bound: tensor-core operations (8 products of 2 S S D FLOP per head).
constexpr int SBB_THREADS = 256;
constexpr int SBB_TILE = SB_S * SB_LD;  // elements of one padded operand
constexpr int SBB_SMEM = 4 * SBB_TILE * 2 + 3 * SB_S * 4;

__global__ void __launch_bounds__(SBB_THREADS)
    spatial_attention_bwd_kernel(const bf16* __restrict__ qkv,
                                 const bf16* __restrict__ d_o,
                                 bf16* __restrict__ dqkv, bf16* __restrict__ o_out,
                                 int C, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + SBB_TILE;
  bf16* Vs = Ks + SBB_TILE;
  bf16* Gs = Vs + SBB_TILE;  // d_o
  float* m_s = reinterpret_cast<float*>(Gs + SBB_TILE);
  float* il_s = m_s + SB_S;
  float* dl_s = il_s + SB_S;
  const int h = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long ld = 3L * C;
  const bf16* base = qkv + (long)n * SB_S * ld + h * SB_D;
  const bf16* gbase = d_o + (long)n * SB_S * C + h * SB_D;
  bf16* dbase = dqkv + (long)n * SB_S * ld + h * SB_D;

  for (int c = tid; c < SB_S * 4; c += SBB_THREADS) {
    const int r = c >> 2, d = (c & 3) * 8;
    cp_async16(&Qs[r * SB_LD + d], base + r * ld + d, true);
    cp_async16(&Ks[r * SB_LD + d], base + r * ld + C + d, true);
    cp_async16(&Vs[r * SB_LD + d], base + r * ld + 2 * C + d, true);
    cp_async16(&Gs[r * SB_LD + d], gbase + (long)r * C + d, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- phase A: query rows ----
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = warp * 32 + mt * 16;
    uint32_t qa[2][4], ga[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      ldmatrix_x4(qa[kk], &Qs[(r0 + (lane & 15)) * SB_LD + kk * 16 + (lane >> 4) * 8]);
      ldmatrix_x4(ga[kk], &Gs[(r0 + (lane & 15)) * SB_LD + kk * 16 + (lane >> 4) * 8]);
    }
    float sc[SB_S / 8][4];
#pragma unroll
    for (int j = 0; j < SB_S / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      uint32_t kb[4];
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
#pragma unroll
    for (int j = 0; j < SB_S / 8; ++j) {
      sc[j][0] *= i0;
      sc[j][1] *= i0;
      sc[j][2] *= i1;
      sc[j][3] *= i1;
    }

    float o[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < SB_S / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &Vs[(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      SB_LD + nb * 16 + (lane >> 4) * 8]);
        mma_bf16(o[nb * 2], pa, &vb[0]);
        mma_bf16(o[nb * 2 + 1], pa, &vb[2]);
      }
    }
    float d0 = 0.f, d1 = 0.f;
    bf16* orow = o_out + ((long)n * SB_S + r0 + g) * C + h * SB_D + t4 * 2;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float2 g0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          &Gs[(r0 + g) * SB_LD + nt * 8 + t4 * 2]));
      const float2 g1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          &Gs[(r0 + g + 8) * SB_LD + nt * 8 + t4 * 2]));
      d0 += g0.x * o[nt][0] + g0.y * o[nt][1];
      d1 += g1.x * o[nt][2] + g1.y * o[nt][3];
      *reinterpret_cast<uint32_t*>(orow + nt * 8) = pack_bf16(o[nt][0], o[nt][1]);
      *reinterpret_cast<uint32_t*>(orow + 8L * C + nt * 8) =
          pack_bf16(o[nt][2], o[nt][3]);
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
    if (t4 == 0) {
      m_s[r0 + g] = m0;
      il_s[r0 + g] = i0;
      dl_s[r0 + g] = d0;
      m_s[r0 + g + 8] = m1;
      il_s[r0 + g + 8] = i1;
      dl_s[r0 + g + 8] = d1;
    }

    float dq[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < SB_S / 16; ++kc) {
      float dp[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        dp[hf][0] = dp[hf][1] = dp[hf][2] = dp[hf][3] = 0.f;
        uint32_t vb[4];
        ldmatrix_x4(vb, &Vs[((2 * kc + hf) * 8 + (lane & 7)) * SB_LD + (lane >> 3) * 8]);
        mma_bf16(dp[hf], ga[0], &vb[0]);
        mma_bf16(dp[hf], ga[1], &vb[2]);
        dp[hf][0] = sc[2 * kc + hf][0] * (dp[hf][0] - d0) * scale;
        dp[hf][1] = sc[2 * kc + hf][1] * (dp[hf][1] - d0) * scale;
        dp[hf][2] = sc[2 * kc + hf][2] * (dp[hf][2] - d1) * scale;
        dp[hf][3] = sc[2 * kc + hf][3] * (dp[hf][3] - d1) * scale;
      }
      uint32_t da[4];
      da[0] = pack_bf16(dp[0][0], dp[0][1]);
      da[1] = pack_bf16(dp[0][2], dp[0][3]);
      da[2] = pack_bf16(dp[1][0], dp[1][1]);
      da[3] = pack_bf16(dp[1][2], dp[1][3]);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, &Ks[(kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      SB_LD + nb * 16 + (lane >> 4) * 8]);
        mma_bf16(dq[nb * 2], da, &kb[0]);
        mma_bf16(dq[nb * 2 + 1], da, &kb[2]);
      }
    }
    bf16* qrow = dbase + (long)(r0 + g) * ld + t4 * 2;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      *reinterpret_cast<uint32_t*>(qrow + nt * 8) = pack_bf16(dq[nt][0], dq[nt][1]);
      *reinterpret_cast<uint32_t*>(qrow + 8 * ld + nt * 8) =
          pack_bf16(dq[nt][2], dq[nt][3]);
    }
  }
  __syncthreads();

  // ---- phase B: key rows ----
  for (int mt = 0; mt < 2; ++mt) {
    const int k0 = warp * 32 + mt * 16;
    uint32_t ka[2][4], va[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      ldmatrix_x4(ka[kk], &Ks[(k0 + (lane & 15)) * SB_LD + kk * 16 + (lane >> 4) * 8]);
      ldmatrix_x4(va[kk], &Vs[(k0 + (lane & 15)) * SB_LD + kk * 16 + (lane >> 4) * 8]);
    }
    float dk[4][4], dv[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      dk[nt][0] = dk[nt][1] = dk[nt][2] = dk[nt][3] = 0.f;
      dv[nt][0] = dv[nt][1] = dv[nt][2] = dv[nt][3] = 0.f;
    }
#pragma unroll 4
    for (int qc = 0; qc < SB_S / 16; ++qc) {
      float pt[2][4], dt[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 2 * qc + hf;
        uint32_t qb[4], gb[4];
        ldmatrix_x4(qb, &Qs[(j * 8 + (lane & 7)) * SB_LD + (lane >> 3) * 8]);
        ldmatrix_x4(gb, &Gs[(j * 8 + (lane & 7)) * SB_LD + (lane >> 3) * 8]);
        pt[hf][0] = pt[hf][1] = pt[hf][2] = pt[hf][3] = 0.f;
        dt[hf][0] = dt[hf][1] = dt[hf][2] = dt[hf][3] = 0.f;
        mma_bf16(pt[hf], ka[0], &qb[0]);
        mma_bf16(pt[hf], ka[1], &qb[2]);
        mma_bf16(dt[hf], va[0], &gb[0]);
        mma_bf16(dt[hf], va[1], &gb[2]);
        const int c0 = j * 8 + t4 * 2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + (e & 1);
          const float p = __expf(pt[hf][e] * scale - m_s[c]) * il_s[c];
          pt[hf][e] = p;
          dt[hf][e] = p * (dt[hf][e] - dl_s[c]) * scale;
        }
      }
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(pt[0][0], pt[0][1]);
      pa[1] = pack_bf16(pt[0][2], pt[0][3]);
      pa[2] = pack_bf16(pt[1][0], pt[1][1]);
      pa[3] = pack_bf16(pt[1][2], pt[1][3]);
      da[0] = pack_bf16(dt[0][0], dt[0][1]);
      da[1] = pack_bf16(dt[0][2], dt[0][3]);
      da[2] = pack_bf16(dt[1][0], dt[1][1]);
      da[3] = pack_bf16(dt[1][2], dt[1][3]);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int off = (qc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SB_LD +
                        nb * 16 + (lane >> 4) * 8;
        uint32_t gb[4], qb[4];
        ldmatrix_x4_trans(gb, &Gs[off]);
        ldmatrix_x4_trans(qb, &Qs[off]);
        mma_bf16(dv[nb * 2], pa, &gb[0]);
        mma_bf16(dv[nb * 2 + 1], pa, &gb[2]);
        mma_bf16(dk[nb * 2], da, &qb[0]);
        mma_bf16(dk[nb * 2 + 1], da, &qb[2]);
      }
    }
    bf16* krow = dbase + (long)(k0 + g) * ld + C + t4 * 2;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      *reinterpret_cast<uint32_t*>(krow + nt * 8) = pack_bf16(dk[nt][0], dk[nt][1]);
      *reinterpret_cast<uint32_t*>(krow + 8 * ld + nt * 8) =
          pack_bf16(dk[nt][2], dk[nt][3]);
      *reinterpret_cast<uint32_t*>(krow + C + nt * 8) = pack_bf16(dv[nt][0], dv[nt][1]);
      *reinterpret_cast<uint32_t*>(krow + C + 8 * ld + nt * 8) =
          pack_bf16(dv[nt][2], dv[nt][3]);
    }
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
// above (and of the temporal+MLP block's four), all bf16 and contiguous:
// rounded, + bias (N,) if not null, rounded, GELU (act ACT_GELU_TANH or
// ACT_GELU_ERF; ACT_NONE: none), rounded, + resid (M, N) if not null,
// rounded.
extern "C" int tpu1x_gemm_sm90(const void* A, const void* B, void* C,
                               const void* bias, const void* resid, int M,
                               int N, int K, int act, void* stream) {
  return launch_gemm90(A, B, C, bias, resid, M, N, K,
                       static_cast<cudaStream_t>(stream), act);
}

// qkv, dqkv (N, S, 3C); d_o, o (N, S, C), all bf16. Requires S == 256 and
// C == 32 * H.
extern "C" int tpu1x_spatial_attention_bwd(const void* qkv, const void* d_o,
                                           void* dqkv, void* o, int N, int S,
                                           int C, int H, float scale,
                                           void* stream) {
  if (S != SB_S || C != H * SB_D) return cudaErrorInvalidValue;
  TPU1X_TRY(cudaFuncSetAttribute(spatial_attention_bwd_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SBB_SMEM));
  spatial_attention_bwd_kernel<<<dim3(H, N), SBB_THREADS, SBB_SMEM,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(d_o),
      static_cast<bf16*>(dqkv), static_cast<bf16*>(o), C, scale);
  return cudaGetLastError();
}
