// Multi-head attention softmax(q k^T scale [causal]) v over the N tokens of
// each (row, head), forward and backward, on q, k, v shaped (R, N, H, 32)
// and read in place through their strides.
//
// Replaces the Pallas kernels tpu1x/ops/pallas_attention.py: _flash_mha_bhnd
// (_attn_kernel) and _flash_mha_bwd_bhnd (_attn_bwd_kernel). The TPU wrapper
// transposes to (B, H, N, D) because Mosaic wants the head axis leading; here
// the kernels take the (rows, N, H, D) tensors as they lie, each with its own
// row and token strides, so that the v third of a (rows, N, 3, H, D) qkv
// product and the freshly normalised q and k feed them without a copy.
//
// Forward: one block per (row, head, 64-query tile), the design of the
// spatial block's attention (csrc/spatial_block.cu): the keys and values
// that the tile can see sit in shared memory, each warp's 16 x N logits
// stay in registers, the softmax is fp32, the probabilities are rounded to
// bf16 and go from the logit registers straight into the PV product. Under
// the causal mask a tile reads and multiplies only the keys up to its last
// query.
//
// Backward: one block per (row, head) with q, k, v and d_o (4 x 256 x 32
// bf16) in shared memory, the two-phase design of the spatial train block's
// attention backward: phase A walks query rows (softmax, o, delta = sum d_o
// o, dq), phase B walks key rows and recomputes p^T and ds^T from the row
// statistics that phase A left in shared memory (dk, dv), so that ds is
// never transposed and nothing N x N reaches device memory. q k^T is exact
// (bf16 operands, fp32 accumulation); p and ds are rounded to bf16 for
// their products, where the TPU kernel keeps all of the backward in fp32.
//
// Bound on the H100: by the roofline, device memory (at N = 256 the forward
// moves 4 and the backward 7 tensors of R N H D bf16 values, which takes
// longer than the 4 and 10 N N D FLOP per head and row at the tensor cores'
// peak); in these first versions the time goes to the mma.sync products,
// the backward's recomputation (16 N N D FLOP) and the softmax arithmetic.
// N <= 256, N % 64 == 0, head_dim 32.

#include "common.cuh"

using namespace tpu1x;

namespace {

constexpr int FA_N = 256;   // most keys of a head held in shared memory
constexpr int FA_D = 32;    // head_dim
constexpr int FA_QT = 64;   // queries per forward block: 4 warps x 16 rows
constexpr int FA_LD = FA_D + 8;

struct FlashArgs {
  // element (r, n, h, d) of q at r * rs[0] + n * ts[0] + h * 32 + d; index 1
  // is k, 2 is v, 3 is d_o (backward only)
  const bf16* in[4];
  long rs[4], ts[4];
  // outputs, contiguous (R, N, H, 32): the forward's o; the backward's dq,
  // dk, dv
  bf16* out[3];
  int N, H;
  float scale;
};

__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long ts,
                                          int rows, int tid, int threads) {
  for (int c = tid; c < rows * 4; c += threads) {
    const int r = c >> 2, d = (c & 3) * 8;
    cp_async16(&dst[r * FA_LD + d], src + r * ts + d, true);
  }
}

// grid (N / 64, H, R), 128 threads.
template <bool CAUSAL>
__global__ void __launch_bounds__(128) flash_fwd_kernel(FlashArgs a) {
  __shared__ __align__(16) bf16 Ks[FA_N * FA_LD];
  __shared__ __align__(16) bf16 Vs[FA_N * FA_LD];
  __shared__ __align__(16) bf16 Qs[FA_QT * FA_LD];
  const int r = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FA_QT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // the keys this tile can see: a multiple of 64, so whole mma tiles
  const int kend = CAUSAL ? min(a.N, q0 + FA_QT) : a.N;
  const float scale = a.scale;

  load_tile(Ks, a.in[1] + r * a.rs[1] + h * FA_D, a.ts[1], kend, tid, 128);
  load_tile(Vs, a.in[2] + r * a.rs[2] + h * FA_D, a.ts[2], kend, tid, 128);
  load_tile(Qs, a.in[0] + r * a.rs[0] + q0 * a.ts[0] + h * FA_D, a.ts[0], FA_QT,
            tid, 128);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    ldmatrix_x4(qa[kk], &Qs[(warp * 16 + (lane & 15)) * FA_LD + kk * 16 +
                            (lane >> 4) * 8]);

  // logits of rows g and g + 8 of this warp's 16 queries against 8 keys
  // per tile: sc[j] = {(g, 8j + 2t), (g, 8j + 2t + 1), (g + 8, ...), ...}
  const int row0 = q0 + warp * 16 + g;
  float sc[FA_N / 8][4];
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < FA_N / 8; ++j) {
    if (j * 8 < kend) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      uint32_t kb[4];  // keys 8j..8j+7, d 0-7 | 8-15 | 16-23 | 24-31
      ldmatrix_x4(kb, &Ks[(j * 8 + (lane & 7)) * FA_LD + (lane >> 3) * 8]);
      mma_bf16(sc[j], qa[0], &kb[0]);
      mma_bf16(sc[j], qa[1], &kb[2]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] *= scale;
        if (CAUSAL && j * 8 + t4 * 2 + (e & 1) > row0 + (e >> 1) * 8)
          sc[j][e] = -INFINITY;
      }
      m0 = fmaxf(m0, fmaxf(sc[j][0], sc[j][1]));
      m1 = fmaxf(m1, fmaxf(sc[j][2], sc[j][3]));
    }
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < FA_N / 8; ++j) {
    if (j * 8 < kend) {
      sc[j][0] = __expf(sc[j][0] - m0);
      sc[j][1] = __expf(sc[j][1] - m0);
      sc[j][2] = __expf(sc[j][2] - m1);
      sc[j][3] = __expf(sc[j][3] - m1);
      s0 += sc[j][0] + sc[j][1];
      s1 += sc[j][2] + sc[j][3];
    }
  }
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
  const float i0 = 1.f / s0, i1 = 1.f / s1;

  // out (16 x 32) = P (16 x kend, bf16) @ V (kend x 32); the accumulator
  // layout of two key tiles is the A-operand layout of one k16 step
  float o[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < FA_N / 16; ++kk) {
    if (kk * 16 < kend) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0] * i0, sc[2 * kk][1] * i0);
      pa[1] = pack_bf16(sc[2 * kk][2] * i1, sc[2 * kk][3] * i1);
      pa[2] = pack_bf16(sc[2 * kk + 1][0] * i0, sc[2 * kk + 1][1] * i0);
      pa[3] = pack_bf16(sc[2 * kk + 1][2] * i1, sc[2 * kk + 1][3] * i1);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &Vs[(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      FA_LD + nb * 16 + (lane >> 4) * 8]);
        mma_bf16(o[nb * 2], pa, &vb[0]);
        mma_bf16(o[nb * 2 + 1], pa, &vb[2]);
      }
    }
  }

  const long ots = (long)a.H * FA_D;
  bf16* orow = a.out[0] + ((long)r * a.N + row0) * ots + h * FA_D + t4 * 2;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    *reinterpret_cast<uint32_t*>(orow + nt * 8) = pack_bf16(o[nt][0], o[nt][1]);
    *reinterpret_cast<uint32_t*>(orow + 8 * ots + nt * 8) =
        pack_bf16(o[nt][2], o[nt][3]);
  }
}

constexpr int FAB_THREADS = 256;
constexpr int FAB_TILE = FA_N * FA_LD;  // elements of one padded operand
constexpr int FAB_SMEM = 4 * FAB_TILE * 2 + 3 * FA_N * 4;

// grid (H, R), 256 threads, dynamic shared memory FAB_SMEM. Each warp owns
// two tiles of 16 query rows in phase A and of 16 key rows in phase B, tile
// w and tile 15 - w, so that under the causal mask, where a tile's work
// grows (phase A) or shrinks (phase B) with its index, the warps finish
// together. Tiles at or beyond N are skipped, and so are, under the mask,
// the key tiles after a query tile and the query tiles before a key tile.
template <bool CAUSAL>
__global__ void __launch_bounds__(FAB_THREADS) flash_bwd_kernel(FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + FAB_TILE;
  bf16* Vs = Ks + FAB_TILE;
  bf16* Gs = Vs + FAB_TILE;  // d_o
  float* m_s = reinterpret_cast<float*>(Gs + FAB_TILE);
  float* il_s = m_s + FA_N;
  float* dl_s = il_s + FA_N;
  const int h = blockIdx.x, r = blockIdx.y, N = a.N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale = a.scale;
  const long ots = (long)a.H * FA_D;
  const long obase = (long)r * N * ots + h * FA_D;

  load_tile(Qs, a.in[0] + r * a.rs[0] + h * FA_D, a.ts[0], N, tid, FAB_THREADS);
  load_tile(Ks, a.in[1] + r * a.rs[1] + h * FA_D, a.ts[1], N, tid, FAB_THREADS);
  load_tile(Vs, a.in[2] + r * a.rs[2] + h * FA_D, a.ts[2], N, tid, FAB_THREADS);
  load_tile(Gs, a.in[3] + r * a.rs[3] + h * FA_D, a.ts[3], N, tid, FAB_THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- phase A: query rows ----
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = (mt == 0 ? warp : 15 - warp) * 16;
    if (r0 >= N) continue;
    const int kend = CAUSAL ? r0 + 16 : N;  // keys these 16 rows can see
    uint32_t qa[2][4], ga[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      ldmatrix_x4(qa[kk], &Qs[(r0 + (lane & 15)) * FA_LD + kk * 16 + (lane >> 4) * 8]);
      ldmatrix_x4(ga[kk], &Gs[(r0 + (lane & 15)) * FA_LD + kk * 16 + (lane >> 4) * 8]);
    }
    float sc[FA_N / 8][4];
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < FA_N / 8; ++j) {
      if (j * 8 < kend) {
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
        uint32_t kb[4];
        ldmatrix_x4(kb, &Ks[(j * 8 + (lane & 7)) * FA_LD + (lane >> 3) * 8]);
        mma_bf16(sc[j], qa[0], &kb[0]);
        mma_bf16(sc[j], qa[1], &kb[2]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] *= scale;
          if (CAUSAL && j * 8 + t4 * 2 + (e & 1) > r0 + g + (e >> 1) * 8)
            sc[j][e] = -INFINITY;
        }
        m0 = fmaxf(m0, fmaxf(sc[j][0], sc[j][1]));
        m1 = fmaxf(m1, fmaxf(sc[j][2], sc[j][3]));
      }
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < FA_N / 8; ++j) {
      if (j * 8 < kend) {
        sc[j][0] = __expf(sc[j][0] - m0);
        sc[j][1] = __expf(sc[j][1] - m0);
        sc[j][2] = __expf(sc[j][2] - m1);
        sc[j][3] = __expf(sc[j][3] - m1);
        s0 += sc[j][0] + sc[j][1];
        s1 += sc[j][2] + sc[j][3];
      }
    }
    s0 = quad_sum(s0);
    s1 = quad_sum(s1);
    const float i0 = 1.f / s0, i1 = 1.f / s1;
#pragma unroll
    for (int j = 0; j < FA_N / 8; ++j) {
      if (j * 8 < kend) {
        sc[j][0] *= i0;
        sc[j][1] *= i0;
        sc[j][2] *= i1;
        sc[j][3] *= i1;
      }
    }

    float o[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < FA_N / 16; ++kk) {
      if (kk * 16 < kend) {
        uint32_t pa[4];
        pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, &Vs[(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                        FA_LD + nb * 16 + (lane >> 4) * 8]);
          mma_bf16(o[nb * 2], pa, &vb[0]);
          mma_bf16(o[nb * 2 + 1], pa, &vb[2]);
        }
      }
    }
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float2 g0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          &Gs[(r0 + g) * FA_LD + nt * 8 + t4 * 2]));
      const float2 g1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          &Gs[(r0 + g + 8) * FA_LD + nt * 8 + t4 * 2]));
      d0 += g0.x * o[nt][0] + g0.y * o[nt][1];
      d1 += g1.x * o[nt][2] + g1.y * o[nt][3];
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
    for (int kc = 0; kc < FA_N / 16; ++kc) {
      if (kc * 16 < kend) {
        float dp[2][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          dp[hf][0] = dp[hf][1] = dp[hf][2] = dp[hf][3] = 0.f;
          uint32_t vb[4];
          ldmatrix_x4(vb, &Vs[((2 * kc + hf) * 8 + (lane & 7)) * FA_LD + (lane >> 3) * 8]);
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
                                        FA_LD + nb * 16 + (lane >> 4) * 8]);
          mma_bf16(dq[nb * 2], da, &kb[0]);
          mma_bf16(dq[nb * 2 + 1], da, &kb[2]);
        }
      }
    }
    bf16* qrow = a.out[0] + obase + (long)(r0 + g) * ots + t4 * 2;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      *reinterpret_cast<uint32_t*>(qrow + nt * 8) = pack_bf16(dq[nt][0], dq[nt][1]);
      *reinterpret_cast<uint32_t*>(qrow + 8 * ots + nt * 8) =
          pack_bf16(dq[nt][2], dq[nt][3]);
    }
  }
  __syncthreads();

  // ---- phase B: key rows ----
  for (int mt = 0; mt < 2; ++mt) {
    const int k0 = (mt == 0 ? warp : 15 - warp) * 16;
    if (k0 >= N) continue;
    uint32_t ka[2][4], va[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      ldmatrix_x4(ka[kk], &Ks[(k0 + (lane & 15)) * FA_LD + kk * 16 + (lane >> 4) * 8]);
      ldmatrix_x4(va[kk], &Vs[(k0 + (lane & 15)) * FA_LD + kk * 16 + (lane >> 4) * 8]);
    }
    float dk[4][4], dv[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      dk[nt][0] = dk[nt][1] = dk[nt][2] = dk[nt][3] = 0.f;
      dv[nt][0] = dv[nt][1] = dv[nt][2] = dv[nt][3] = 0.f;
    }
    // under the causal mask only the queries from k0 on see these keys
    for (int qc = CAUSAL ? k0 / 16 : 0; qc < N / 16; ++qc) {
      float pt[2][4], dt[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 2 * qc + hf;
        uint32_t qb[4], gb[4];
        ldmatrix_x4(qb, &Qs[(j * 8 + (lane & 7)) * FA_LD + (lane >> 3) * 8]);
        ldmatrix_x4(gb, &Gs[(j * 8 + (lane & 7)) * FA_LD + (lane >> 3) * 8]);
        pt[hf][0] = pt[hf][1] = pt[hf][2] = pt[hf][3] = 0.f;
        dt[hf][0] = dt[hf][1] = dt[hf][2] = dt[hf][3] = 0.f;
        mma_bf16(pt[hf], ka[0], &qb[0]);
        mma_bf16(pt[hf], ka[1], &qb[2]);
        mma_bf16(dt[hf], va[0], &gb[0]);
        mma_bf16(dt[hf], va[1], &gb[2]);
        const int c0 = j * 8 + t4 * 2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + (e & 1);  // the query; the key is the row
          const bool masked = CAUSAL && c < k0 + g + (e >> 1) * 8;
          const float p =
              masked ? 0.f : __expf(pt[hf][e] * scale - m_s[c]) * il_s[c];
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
        const int off = (qc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * FA_LD +
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
    const long o = obase + (long)(k0 + g) * ots + t4 * 2;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      *reinterpret_cast<uint32_t*>(a.out[1] + o + nt * 8) =
          pack_bf16(dk[nt][0], dk[nt][1]);
      *reinterpret_cast<uint32_t*>(a.out[1] + o + 8 * ots + nt * 8) =
          pack_bf16(dk[nt][2], dk[nt][3]);
      *reinterpret_cast<uint32_t*>(a.out[2] + o + nt * 8) =
          pack_bf16(dv[nt][0], dv[nt][1]);
      *reinterpret_cast<uint32_t*>(a.out[2] + o + 8 * ots + nt * 8) =
          pack_bf16(dv[nt][2], dv[nt][3]);
    }
  }
}

// What both entry points require of the shapes and strides.
bool flash_ok(int N, int D, const long* strides, int count) {
  if (N < 64 || N > FA_N || N % 64 || D != FA_D) return false;
  for (int i = 0; i < count; ++i)
    if (strides[i] % 8) return false;
  return true;
}

}  // namespace

// q, k, v: bf16 (R, N, H, 32) views, element (r, n, h, d) at
// r * rs + n * ts + h * 32 + d with each tensor's own rs and ts (multiples
// of 8, 16-byte aligned base); out bf16 (R, N, H, 32) contiguous.
extern "C" int tpu1x_flash_mha(const void* q, const void* k, const void* v,
                               void* out, long rsq, long tsq, long rsk,
                               long tsk, long rsv, long tsv, int R, int N,
                               int H, int D, float scale, int causal,
                               void* stream) {
  const long strides[6] = {rsq, tsq, rsk, tsk, rsv, tsv};
  if (!flash_ok(N, D, strides, 6)) return cudaErrorInvalidValue;
  FlashArgs a{};
  a.in[0] = static_cast<const bf16*>(q);
  a.in[1] = static_cast<const bf16*>(k);
  a.in[2] = static_cast<const bf16*>(v);
  a.rs[0] = rsq, a.ts[0] = tsq;
  a.rs[1] = rsk, a.ts[1] = tsk;
  a.rs[2] = rsv, a.ts[2] = tsv;
  a.out[0] = static_cast<bf16*>(out);
  a.N = N, a.H = H, a.scale = scale;
  const dim3 grid(N / FA_QT, H, R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (causal)
    flash_fwd_kernel<true><<<grid, 128, 0, s>>>(a);
  else
    flash_fwd_kernel<false><<<grid, 128, 0, s>>>(a);
  return cudaGetLastError();
}

// q, k, v, d_o as above, d_o with strides (rsg, tsg); dq, dk, dv bf16
// (R, N, H, 32) contiguous.
extern "C" int tpu1x_flash_mha_bwd(const void* q, const void* k, const void* v,
                                   const void* d_o, void* dq, void* dk,
                                   void* dv, long rsq, long tsq, long rsk,
                                   long tsk, long rsv, long tsv, long rsg,
                                   long tsg, int R, int N, int H, int D,
                                   float scale, int causal, void* stream) {
  const long strides[8] = {rsq, tsq, rsk, tsk, rsv, tsv, rsg, tsg};
  if (!flash_ok(N, D, strides, 8)) return cudaErrorInvalidValue;
  FlashArgs a{};
  a.in[0] = static_cast<const bf16*>(q);
  a.in[1] = static_cast<const bf16*>(k);
  a.in[2] = static_cast<const bf16*>(v);
  a.in[3] = static_cast<const bf16*>(d_o);
  a.rs[0] = rsq, a.ts[0] = tsq;
  a.rs[1] = rsk, a.ts[1] = tsk;
  a.rs[2] = rsv, a.ts[2] = tsv;
  a.rs[3] = rsg, a.ts[3] = tsg;
  a.out[0] = static_cast<bf16*>(dq);
  a.out[1] = static_cast<bf16*>(dk);
  a.out[2] = static_cast<bf16*>(dv);
  a.N = N, a.H = H, a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (causal) {
    TPU1X_TRY(cudaFuncSetAttribute(flash_bwd_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   FAB_SMEM));
    flash_bwd_kernel<true><<<dim3(H, R), FAB_THREADS, FAB_SMEM, s>>>(a);
  } else {
    TPU1X_TRY(cudaFuncSetAttribute(flash_bwd_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   FAB_SMEM));
    flash_bwd_kernel<false><<<dim3(H, R), FAB_THREADS, FAB_SMEM, s>>>(a);
  }
  return cudaGetLastError();
}
