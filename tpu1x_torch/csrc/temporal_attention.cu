// Attention over the frame axis of q, k, v shaped (B, T, S, C), causal or
// not, heads flat in C (head_dim D = 32, 64 or 128, a template parameter),
// computed in that layout with no
// transpose: the forward (K4), and the backward (K6), which writes dq, dk,
// dv and, where asked, the forward's output o beside them.
//
// Replaces the Pallas kernels of tpu1x/ops/temporal_attention.py: the
// forward (_temporal_fwd -> _fwd_kernel) and the backward (_temporal_bwd ->
// _bwd_kernel). The TPU kernels keep a (T, tile of S, C) block of q, k, v
// (and dout) in VMEM and reduce each head's dot products through a 0/1
// head matrix on the MXU, a lane trick that is not carried over.
//
// Bound on the H100: device memory. At the pre-LN train step's (B, T, S, C)
// = (8, 16, 256, 512) the forward moves q, k, v and o once (134.2 MB,
// 0.040 ms at 3.35 TB/s) for 0.57 GFLOP of bf16 products (about 4 FLOP a
// byte, against the card's 295); the backward moves q, k, v, dout, dq, dk,
// dv (234.9 MB, 0.070 ms), and 268.4 MB (0.080 ms) with o.
//
// Design. Every (b, s, head) is its own attention of T <= 32 frames by D
// channels, so a warp takes one problem of 16 rows at a time: one
// position's 16 frames, or two positions' 8 frames where T <= 8 (keys of
// the other position masked), with mma.sync m16n8k16: S = Q K^T is D / 8
// products, P V D / 8, and the backward's dP = dO V^T, dQ = dS K, dK =
// dS^T Q, dV = P^T dO D / 8 each. Where 16 < T <= 32 a problem is one
// position's 32 frames, two 16-row blocks of queries and of keys, and two
// warps share it (the wide form, W below): in the forward each takes one
// query block over both key blocks and writes its output over its own
// queries, which no other warp reads; in the backward both compute the
// whole 32 x 32 P and dS (the logits and dP twice, the four products once)
// and, after a barrier of the pair, each its half of the columns of o, dq,
// dk and dv, 16 columns at a time over its own columns of the operands, so
// no sum crosses warps and dq, dk, dv never live whole in registers (at D
// = 64 each would be 64 fp32 a lane beside P and dS). Under `causal` the
// first query block's second key block is skipped. wgmma does not fit: its
// smallest product is a 64-row tile, and these are many independent 16 x 16
// problems, block-diagonal rather than one product with 64 rows. What
// limits the kernels is bytes in flight, so:
//   - persistent blocks, one an SM (the ring fills most of shared memory),
//     each walking tiles of TA_POSITIONS positions (twice that where T <=
//     8, half where T > 16) x TA_HEADS heads of one b, or, where the heads
//     are not a multiple of TA_HEADS (C % 256 != 0: a rank's share of the
//     heads under tensor
//     parallelism), twice the positions x half the heads, and where they
//     are not a multiple of 4 either (C % 128 != 0: GENIE_35M's 2 heads a
//     rank at tp = 4), four times the positions x a quarter of the heads,
//     and where the heads are odd (one head a rank: GENIE_35M at tp = 8,
//     GENIE_138M-h128 at tp = 4; or 3, 5, ...), TA_HEADS times the
//     positions x one head: the same bytes and problems a tile (the head
//     group HG is a template parameter, 8, 4, 2 or 1; with HG = 1 a box
//     spans at most 32 positions, within TMA's 256 a dimension);
//   - head_dim 64 keeps a stage at TA_BOX bytes a tensor: a (position,
//     head) is twice the bytes, so a tile holds half the heads (groups of
//     4, or 2 where the heads are not a multiple of 4) and half the
//     problems, each twice the work, and a block runs half the consumer
//     warps (TaShape<D>::WARPS, 8), so the ring keeps its stages (4
//     forward, 3 backward) and the bytes in flight, which are what the
//     kernels wait for; a warp's products and registers double instead;
//   - a producer warp loads a tile's q, k, v (and dout) for all frames with
//     one TMA box a tensor into a ring of up to TA_MAX_STAGES tiles, as many
//     as fit in shared memory (4 forward, 3 backward), completing on the
//     stage's "full" mbarrier, so the next tiles' loads are in flight while
//     one computes, and every input byte is read from device memory once;
//   - the box is the (d, t, h, s, b) view of the (B, T, S, C) tensor (the
//     frame axis before the head axis, whatever their strides), so one
//     (position, head) is tp consecutive rows of 2 D bytes in shared
//     memory, in the swizzle of that width (64 or 128 bytes), and ldmatrix
//     reads them without bank conflicts;
//     a box reaches past T when T < tp, and TMA fills those frames with
//     zeros (and still counts their bytes);
//   - the softmax runs in fp32 in the accumulators' layout, reduced across
//     the four lanes of a row; the accumulators of P and dS are the A
//     fragments of the next products, and their transposes (P^T, dS^T)
//     come from movmatrix;
//   - each result is written in bf16 over an operand that is no longer
//     needed (o over v, dq over k, dk over q, dv over dout), in the same
//     layout, and a storer warp stores the tile's results with one TMA
//     store a tensor (frames >= T and positions >= S are not written) once
//     every consumer warp has arrived on the stage's "done" mbarrier; it
//     frees the stage ("empty") when TMA has read it. The consumer warps
//     issue no global loads or stores at all.
// Numbers: logits and dp are exact products summed in fp32; p is the fp32
// softmax of the scaled logits (each row's exponentials times the
// reciprocal of their sum, cheaper than eight IEEE divisions); delta =
// sum p dp in fp32 from fp32 p; p and ds are rounded to bf16 before P V,
// dV, dQ and dK; dq and dk are scaled after their sums, as the TPU kernel
// does. The backward's o comes from the same device functions
// as the forward's, so it equals K4's output bit for bit. Masked logits:
// keys after the query (causal), or keys t >= T (not causal: zero-filled
// keys would otherwise take weight). Padded query rows t >= T have zero q
// and dout, so they add nothing to dk and dv.
//
//   - head_dim 128 keeps the stage's bytes again: a tile holds 2 heads and
//     4 consumer warps. A 256-byte head row is wider than a swizzled TMA
//     box may be (128 bytes), so each tensor comes as two boxes, its 64
//     channels of each head and the next 64, through two tensor maps (the
//     second's base 64 channels on), into the two halves of the tensor's
//     stage (TA_BOX / 2 apart), each rows of 128 bytes in the 128-byte
//     swizzle; a row's chunks 8-15 lie in the second half (chunk_at), so the
//     problems' code is head_dim 64's with twice the k16 steps and output
//     columns. A warp's accumulator of a 16 x 128 result is 64 fp32 a
//     lane, one at a time (o, dq, dk, dv each leave before the next is
//     summed), and the 32-frame form splits the columns as before. Bound at
//     GENIE_138M-h128's shapes: head_dim 32's bytes, the products the same.
//     ptxas (sm_90a), head_dim 128: the forward 124 registers (116 causal),
//     157 in the 32-frame form (144 causal); the backward 139 (139), 179
//     (158); no spills (192 threads a block: a 255-register cap).
//
// The tile is fixed. Measured with `chip_variants.py ta` on an H100 at
// the train step's shape (PERF.md section 6), tiles of 1 x 8, 1 x 16 and
// 2 x 8 (positions x heads) with 8 to 16 consumer warps are within 3% of
// each other, 4 warps 2-4% slower; 4 x 8 and 2 x 16 leave the backward
// one stage (the static_assert below).
//
// Requires T <= 32, head_dim 32, 64 or 128, C a multiple of it (any
// number of heads), strides that are multiples of 8 and 16-byte aligned
// bases.

#include "sm90.cuh"

using namespace tpu1x;

namespace {

// The tile at head_dim 32: positions at 16 frames, heads, consumer warps
// (a producer and a storer warp beside them); the most stages of the ring.
constexpr int TA_POSITIONS = 2;
constexpr int TA_HEADS = 8;
constexpr int TA_WARPS = 16;
constexpr int TA_MAX_STAGES = 4;
constexpr int TA_SMEM_MAX = 232448;  // shared memory a block may use
// A stage holds one box a tensor: 32 channels, 16 frames (or 8 and twice
// the positions, or 32 and half), TA_HEADS heads, TA_POSITIONS positions
// (or HG heads and TA_HEADS / HG times the positions: the same bytes); at
// head_dim 64 half the heads of twice the bytes.
constexpr int TA_BOX = TA_POSITIONS * 16 * TA_HEADS * 64;

// What head_dim D changes: one frame of one head in shared memory (ROW
// bytes a row, the swizzle's width; at 128 two such rows, one a half of
// the stage), the tensor maps a tensor (HALVES), the heads of a full tile
// (HEADS) and its consumer warps (WARPS): the problems of a tile halve
// with each doubling of D (twice the bytes each), and so do the warps.
template <int D>
struct TaShape {
  static_assert(D == 32 || D == 64 || D == 128, "head_dim 32, 64 or 128");
  static constexpr int ROW = D == 32 ? 64 : 128;
  static constexpr int HALVES = D == 128 ? 2 : 1;
  static constexpr int HEADS = TA_HEADS * 32 / D;
  static constexpr int WARPS = TA_WARPS * 32 / D;
  static constexpr int THREADS = (WARPS + 2) * 32;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
};
// 1024 bytes of alignment, and three mbarriers a stage.
__host__ __device__ constexpr int ta_stages(int tensors) {
  return (TA_SMEM_MAX - 1024) / (tensors * TA_BOX + 24) < TA_MAX_STAGES
             ? (TA_SMEM_MAX - 1024) / (tensors * TA_BOX + 24)
             : TA_MAX_STAGES;
}
__host__ __device__ constexpr int ta_smem(int tensors) {
  return 1024 + ta_stages(tensors) * (tensors * TA_BOX + 24);
}
static_assert(ta_stages(4) >= 2, "the backward's ring needs two stages");

// HALVES maps a tensor, tensor i's half j at i HALVES + j.
template <int D>
struct TaMaps {
  CUtensorMap in[4 * TaShape<D>::HALVES];   // q, k, v, dout (the backward's)
  CUtensorMap out[4 * TaShape<D>::HALVES];  // o, dq, dk, dv (the backward's)
};

struct TaArgs {
  int T, S, C;
  int tp;  // frames a box holds, 8, 16 or 32; a problem is max(1, 16 / tp)
           // positions
  int sg;  // positions a tile: TA_POSITIONS (TA_HEADS / HG) 16 / tp
  int s_tiles, h_groups, tiles;
  int with_o;  // the backward writes o
  float scale;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The transpose of the 8 x 8 bf16 matrix whose fragment each lane holds.
__device__ __forceinline__ uint32_t movt(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

// Byte offset of 16-byte chunk c of row r (0-7) of rows of 2 D bytes in
// the swizzle of that width, from a 512- or 1024-byte boundary; at head_dim
// 128 chunks 8-15 in the second half of the stage's box.
template <int D>
__device__ __forceinline__ uint32_t chunk_at(int r, int c) {
  if constexpr (D == 32) return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
  if constexpr (D == 64) return r * 128 + ((c ^ r) << 4);
  return (c >> 3) * (TA_BOX / 2) + r * 128 + (((c & 7) ^ r) << 4);
}

// One problem's 16 x D operand of one tensor in a stage: rows 0-7 from
// `lo`, rows 8-15 from `hi` (tp = 16: the next 8 frames of the same
// position; tp = 8: the 8 frames of the next position).
template <int D>
struct Rows {
  uint32_t lo, hi;
  __device__ __forceinline__ uint32_t at(int r, int c) const {
    return (r & 8 ? hi : lo) + chunk_at<D>(r & 7, c);
  }
};

// ldmatrix addresses of a lane for k-step (or column pair) j. Row-major A
// fragments, and B fragments of the transposed load (rows: the reduction
// axis): matrices (rows 0-7, chunk 2j), (8-15, 2j), (0-7, 2j + 1), (8-15,
// 2j + 1).
template <int D>
__device__ __forceinline__ uint32_t a_lane(const Rows<D>& x, int lane, int j) {
  return x.at((lane & 7) + (lane & 8), 2 * j + (lane >> 4));
}
// B fragments of the plain load (rows: the product's N axis): matrices
// (rows 0-7, chunk 2j), (0-7, 2j + 1), (8-15, 2j), (8-15, 2j + 1).
template <int D>
__device__ __forceinline__ uint32_t b_lane(const Rows<D>& x, int lane, int j) {
  return x.at((lane & 7) + ((lane >> 4) << 3), 2 * j + ((lane >> 3) & 1));
}

// x[n][e]: row g + 8 (e >> 1), column 8 n + 2 q4 + (e & 1) of a 16 x 16
// accumulator (g = lane / 4, q4 = lane % 4) -> the A fragment of a product
// with it, rounded to bf16.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// The A fragment of the transpose of the matrix whose A fragment is a.
__device__ __forceinline__ void transpose_a(uint32_t (&t)[4],
                                            const uint32_t (&a)[4]) {
  t[0] = movt(a[0]);
  t[1] = movt(a[2]);
  t[2] = movt(a[1]);
  t[3] = movt(a[3]);
}

// s = X Y^T of two 16 x D operands (X's rows by Y's rows), fp32.
template <int D>
__device__ __forceinline__ void rows_by_rows(float (&s)[2][4],
                                             const Rows<D>& x,
                                             const Rows<D>& y, int lane) {
  uint32_t xa[D / 16][4], yb[D / 16][4];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    ldsm_x4(xa[j], a_lane(x, lane, j));
    ldsm_x4(yb[j], b_lane(y, lane, j));
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    mma_bf16(s[0], xa[j], &yb[j][0]);
    mma_bf16(s[1], xa[j], &yb[j][2]);
  }
}

// acc = A Y, A a 16 x 16 fragment (by rows of Y), Y a 16 x D operand.
template <int D>
__device__ __forceinline__ void a_by_rows(float (&acc)[D / 8][4],
                                          const uint32_t (&a)[4],
                                          const Rows<D>& y, int lane) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    uint32_t yb[4];
    ldsm_x4_t(yb, a_lane(y, lane, j));
    mma_bf16(acc[2 * j], a, &yb[0]);
    mma_bf16(acc[2 * j + 1], a, &yb[2]);
  }
}

// A 16 x D fp32 accumulator (acc[n][e]: row g + 8 (e >> 1), column 8 n +
// 2 q4 + (e & 1)), times mul where SCALED, in bf16 over the operand `dst`
// (whose reads by this warp are done).
template <bool SCALED, int D>
__device__ __forceinline__ void put_rows(const float (&acc)[D / 8][4],
                                         float mul, const Rows<D>& dst,
                                         int lane) {
  const int g = lane >> 2, q4 = lane & 3;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x0 = acc[n][2 * h], x1 = acc[n][2 * h + 1];
      if (SCALED) {
        x0 *= mul;
        x1 *= mul;
      }
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       dst.at(g + 8 * h, n) + 4 * q4),
                   "r"(pack_bf16(x0, x1))
                   : "memory");
    }
}

// The probabilities of one problem: the logits q k^T times scale, masked,
// and the fp32 softmax over the keys of each row, in the accumulators'
// layout. Row t and key j are frames t % tp and j % tp of positions t / tp
// and j / tp; a key is masked where its position is another (tp = 8), where
// it follows the query (causal), or where its frame is >= T (not causal:
// zero-filled keys would otherwise take weight).
template <bool CAUSAL, int D>
__device__ __forceinline__ void probabilities(float (&p)[2][4],
                                              const Rows<D>& q,
                                              const Rows<D>& k, int lane,
                                              int T, int tp, float scale) {
  const int g = lane >> 2, q4 = lane & 3;
  rows_by_rows(p, q, k, lane);
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * n + 2 * q4 + (e & 1), t = g + 8 * (e >> 1);
      const int jf = j & (tp - 1), tf = t & (tp - 1);
      float x = __fmul_rn(p[n][e], scale);
      if ((tp == 8 && n != (e >> 1)) || (CAUSAL ? jf > tf : jf >= T))
        x = -INFINITY;
      p[n][e] = x;
      m[e >> 1] = fmaxf(m[e >> 1], x);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[n][e] = __expf(__fsub_rn(p[n][e], m[e >> 1]));
      sum[e >> 1] = __fadd_rn(sum[e >> 1], p[n][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) sum[r] = __frcp_rn(quad_sum(sum[r]));
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[n][e] = __fmul_rn(p[n][e], sum[e >> 1]);
}

// ---- The wide form (16 < T <= 32): a problem is one position's 32 frames
// of one head, rows 0-15 block 0 and rows 16-31 block 1 of each operand.

// Block j of a 32-row operand whose first row is at `base`.
template <int D>
__device__ __forceinline__ Rows<D> block_rows(uint32_t base, int j) {
  const uint32_t lo = base + 16 * j * TaShape<D>::ROW;
  return Rows<D>{lo, lo + 8 * TaShape<D>::ROW};
}

// Whether (query block qb, key block jb) is masked whole: under `causal`
// the first query block's second key block.
template <bool CAUSAL>
__device__ __forceinline__ bool skipped(int qb, int jb) {
  return CAUSAL && qb == 0 && jb == 1;
}

// `probabilities` for query block qb of a 32-frame problem against both key
// blocks (p[jb]: its 16 x 16 block with keys jb): query frame t = 16 qb +
// row, key frame j = 16 jb + column; a key is masked where it follows the
// query (causal) or where its frame is >= T (not causal: TMA's zero-filled
// frames would otherwise take weight). A skipped block is not multiplied;
// its logits are masked like the rest.
template <bool CAUSAL, int D>
__device__ __forceinline__ void probabilities_w(float (&p)[2][2][4],
                                                const Rows<D>& q,
                                                const Rows<D> (&k)[2],
                                                int lane, int qb, int T,
                                                float scale) {
  const int g = lane >> 2, q4 = lane & 3;
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    if (skipped<CAUSAL>(qb, jb)) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[jb][n][e] = 0.f;
    } else {
      rows_by_rows(p[jb], q, k[jb], lane);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * jb + 8 * n + 2 * q4 + (e & 1);
        const int t = 16 * qb + g + 8 * (e >> 1);
        float x = __fmul_rn(p[jb][n][e], scale);
        if (CAUSAL ? j > t : j >= T) x = -INFINITY;
        p[jb][n][e] = x;
        m[e >> 1] = fmaxf(m[e >> 1], x);
      }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
#pragma unroll
  for (int jb = 0; jb < 2; ++jb)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[jb][n][e] = __expf(__fsub_rn(p[jb][n][e], m[e >> 1]));
        sum[e >> 1] = __fadd_rn(sum[e >> 1], p[jb][n][e]);
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) sum[r] = __frcp_rn(quad_sum(sum[r]));
#pragma unroll
  for (int jb = 0; jb < 2; ++jb)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[jb][n][e] = __fmul_rn(p[jb][n][e], sum[e >> 1]);
}

// The 16 columns of chunk c (n-tiles 2c, 2c + 1) of a 16 x D result, times
// mul where SCALED, in bf16 over the same columns of `dst`.
template <bool SCALED, int D>
__device__ __forceinline__ void put_cols(const float (&acc)[2][4], float mul,
                                         const Rows<D>& dst, int lane,
                                         int c) {
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x0 = acc[n][2 * h], x1 = acc[n][2 * h + 1];
      if (SCALED) {
        x0 *= mul;
        x1 *= mul;
      }
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       dst.at(g + 8 * h, 2 * c + n) + 4 * q4),
                   "r"(pack_bf16(x0, x1))
                   : "memory");
    }
}

// The two warps of a pair (named barrier `id`, 64 threads).
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// Forward of query block qb of a 32-frame problem: o = P V over both key
// blocks, written over the block's own queries (read by no other warp).
template <bool CAUSAL, int D>
__device__ __forceinline__ void forward_w(const Rows<D>& q,
                                          const Rows<D> (&k)[2],
                                          const Rows<D> (&v)[2], int lane,
                                          int qb, int T, float scale) {
  float p[2][2][4], acc[D / 8][4];
  uint32_t pa[2][4];
  probabilities_w<CAUSAL>(p, q, k, lane, qb, T, scale);
  to_a(pa[0], p[0]);
  to_a(pa[1], p[1]);
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    if (skipped<CAUSAL>(qb, jb)) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t yb[4];
      ldsm_x4_t(yb, a_lane(v[jb], lane, j));
      mma_bf16(acc[2 * j], pa[jb], &yb[0]);
      mma_bf16(acc[2 * j + 1], pa[jb], &yb[2]);
    }
  }
  put_rows<false, D>(acc, 1.f, q, lane);
}

// acc[r] = sum over s of A(r, s) Y_s[:, chunk c], r and s the two blocks,
// where A(r, s) is a[r][s] (TRANS false: a sum over key blocks s, as P V and
// dS K) or the transpose of a[s][r] (TRANS true: over query blocks, as
// P^T dO and dS^T Q); a skipped (query, key) block adds nothing.
template <bool CAUSAL, bool TRANS, int D>
__device__ __forceinline__ void chunk_product(float (&acc)[2][2][4],
                                              const uint32_t (&a)[2][2][4],
                                              const Rows<D> (&y)[2],
                                              int lane, int c) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.f;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    uint32_t yb[4];
    ldsm_x4_t(yb, a_lane(y[s], lane, c));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (skipped<CAUSAL>(TRANS ? s : r, TRANS ? r : s)) continue;
      uint32_t t[4];
      if constexpr (TRANS) {
        transpose_a(t, a[s][r]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) t[i] = a[r][s][i];
      }
      mma_bf16(acc[r][0], t, &yb[0]);
      mma_bf16(acc[r][1], t, &yb[2]);
    }
  }
}

// Backward of a 32-frame problem by one warp of the pair that shares it:
// the whole P and dS (both warps), then this warp's half of the columns of
// o (where asked), dq, dk and dv, one 16-column chunk at a time, each over
// the same columns of v, k, q and dout.
template <bool CAUSAL, int D>
__device__ __forceinline__ void backward_w(
    const Rows<D> (&q)[2], const Rows<D> (&k)[2], const Rows<D> (&v)[2],
    const Rows<D> (&dout)[2], int lane, int half, int pair, bool with_o,
    int T, float scale) {
  uint32_t pa[2][2][4], dsa[2][2][4];
#pragma unroll
  for (int qb = 0; qb < 2; ++qb) {
    float p[2][2][4], dp[2][2][4];
    probabilities_w<CAUSAL>(p, q[qb], k, lane, qb, T, scale);
#pragma unroll
    for (int jb = 0; jb < 2; ++jb) {
      if (skipped<CAUSAL>(qb, jb)) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[jb][n][e] = 0.f;
      } else {
        rows_by_rows(dp[jb], dout[qb], v[jb], lane);  // dP = dO V^T
      }
    }
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int jb = 0; jb < 2; ++jb)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          delta[e >> 1] = fmaf(p[jb][n][e], dp[jb][n][e], delta[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) delta[r] = quad_sum(delta[r]);
#pragma unroll
    for (int jb = 0; jb < 2; ++jb) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[jb][n][e] = p[jb][n][e] * (dp[jb][n][e] - delta[e >> 1]);
      to_a(pa[qb][jb], p[jb]);
      to_a(dsa[qb][jb], dp[jb]);
    }
  }
  // both warps have read every column of q, k, v and dout
  pair_sync(1 + pair);
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const int c = half * (D / 32) + i;
    float acc[2][2][4];
    if (with_o) {  // o = P V, over v
      chunk_product<CAUSAL, false>(acc, pa, v, lane, c);
      __syncwarp();
      put_cols<false, D>(acc[0], 1.f, v[0], lane, c);
      put_cols<false, D>(acc[1], 1.f, v[1], lane, c);
    }
    chunk_product<CAUSAL, false>(acc, dsa, k, lane, c);  // dQ = dS K
    __syncwarp();
    put_cols<true, D>(acc[0], scale, k[0], lane, c);
    put_cols<true, D>(acc[1], scale, k[1], lane, c);
    chunk_product<CAUSAL, true>(acc, dsa, q, lane, c);  // dK = dS^T Q
    __syncwarp();
    put_cols<true, D>(acc[0], scale, q[0], lane, c);
    put_cols<true, D>(acc[1], scale, q[1], lane, c);
    chunk_product<CAUSAL, true>(acc, pa, dout, lane, c);  // dV = P^T dO
    __syncwarp();
    put_cols<false, D>(acc[0], 1.f, dout[0], lane, c);
    put_cols<false, D>(acc[1], 1.f, dout[1], lane, c);
  }
}

// The body of both kernels. grid: the tiles, or the blocks the card keeps
// resident, whichever is fewer; TaShape<D>::THREADS threads: the consumer
// warps, the producer, the storer; dynamic shared memory ta_smem(NT). Tile
// i is (b, positions sg (i / h_groups % s_tiles) .., heads HG (i %
// h_groups) ..); its problems are (16 / tp positions, one head), one a warp
// at a time, or with W (tp = 32) (one position, one head), a pair of warps
// each.
template <int D, bool BWD, bool CAUSAL, int HG, bool W>
__device__ __forceinline__ void temporal_body(const TaMaps<D>& maps,
                                              const TaArgs& a) {
  using Sh = TaShape<D>;
  constexpr int WARPS = Sh::WARPS, NH = Sh::HALVES;
  static_assert(Sh::HEADS % HG == 0, "a head group divides a tile's heads");
  constexpr int NT = BWD ? 4 : 3;  // operands a tile
  constexpr int STAGES = ta_stages(NT);
  constexpr uint32_t box = TA_BOX, stage_bytes = NT * box;
  extern __shared__ unsigned char ta_raw[];
  const uint32_t ring = (smem_u32(ta_raw) + 1023) & ~1023u;
  const int span = W ? 1 : 16 / a.tp;  // positions a problem
  const int per = a.sg / span * HG;    // problems a tile
  const uint32_t slot = a.tp * Sh::ROW;  // one (position, head)
  // three mbarriers a stage: the loads landed, the consumers are done, the
  // stores have read the stage
  const uint32_t full = ring + STAGES * stage_bytes;
  const uint32_t done = full + 8 * STAGES, empty = done + 8 * STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(done + 8 * st, WARPS);
      mbar_init(empty + 8 * st, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= WARPS) {  // the producer, then the storer
    if (lane != 0) return;
    const bool producer = warp == WARPS;
    int it = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++it) {
      const int st = it % STAGES, use = it / STAGES;
      const int hgi = tile % a.h_groups, rest = tile / a.h_groups;
      const int s0 = (rest % a.s_tiles) * a.sg, b = rest / a.s_tiles;
      const uint32_t base = ring + st * stage_bytes;
      if (producer) {
        if (use > 0) mbar_wait(empty + 8 * st, (use - 1) & 1);
        mbar_expect_tx(full + 8 * st, stage_bytes);
        // tensor i's box (NH boxes of its halves) at base + i box
#pragma unroll
        for (int i = 0; i < NT * NH; ++i)
          tma_load_5d(base + i / NH * box + i % NH * (box / NH), &maps.in[i],
                      0, 0, hgi * HG, s0, b, full + 8 * st);
      } else {
        mbar_wait(done + 8 * st, use & 1);
        // o over v (the wide forward's over q), dq over k, dk over q, dv
        // over dout
        auto put = [&](int i, uint32_t src) {
#pragma unroll
          for (int j = 0; j < NH; ++j)
            tma_store_5d(&maps.out[i * NH + j], src + j * (box / NH), 0, 0,
                         hgi * HG, s0, b);
        };
        if (!BWD || a.with_o) put(0, base + (W && !BWD ? 0 : 2 * box));
        if (BWD) {
          put(1, base + box);
          put(2, base);
          put(3, base + 3 * box);
        }
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(empty + 8 * st);
      }
    }
    if (!producer) bulk_wait();  // the last stores have landed
    return;
  }

  int it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++it) {
    const int st = it % STAGES, use = it / STAGES;
    mbar_wait(full + 8 * st, use & 1);
    if constexpr (W) {
      // unit u: problem u / 2, the query block (forward) or the half of
      // the columns (backward) u % 2; the pair of warps u, u ^ 1 shares
      // a problem, and both are in the same pass of this loop
      for (int u = warp; u < 2 * per; u += WARPS) {
        const int pi = u >> 1, sl = pi / HG, hl = pi % HG;
        const uint32_t lo = ring + st * stage_bytes + (sl * HG + hl) * slot;
        const Rows<D> k[2] = {block_rows<D>(lo + box, 0),
                              block_rows<D>(lo + box, 1)};
        const Rows<D> v[2] = {block_rows<D>(lo + 2 * box, 0),
                              block_rows<D>(lo + 2 * box, 1)};
        if constexpr (!BWD) {
          forward_w<CAUSAL, D>(block_rows<D>(lo, u & 1), k, v, lane, u & 1,
                               a.T, a.scale);
        } else {
          const Rows<D> q[2] = {block_rows<D>(lo, 0), block_rows<D>(lo, 1)};
          const Rows<D> dout[2] = {block_rows<D>(lo + 3 * box, 0),
                                   block_rows<D>(lo + 3 * box, 1)};
          backward_w<CAUSAL, D>(q, k, v, dout, lane, u & 1, warp >> 1,
                                a.with_o, a.T, a.scale);
        }
      }
    }
    for (int pi = warp; !W && pi < per; pi += WARPS) {
      const int sl = pi / HG * span, hl = pi % HG;
      // operand i: its box in stage st, the slot of (sl, hl), and rows 8-15
      // 8 frames on (tp = 16) or one position on (tp = 8); a slot past S
      // holds zeros, which TMA does not store
      const uint32_t lo = ring + st * stage_bytes + (sl * HG + hl) * slot;
      const uint32_t hi = lo + (a.tp == 16 ? 8 * Sh::ROW : HG * slot);
      const Rows<D> q{lo, hi}, k{lo + box, hi + box},
          v{lo + 2 * box, hi + 2 * box};
      float p[2][4], acc[D / 8][4];
      uint32_t pa[4];
      probabilities<CAUSAL>(p, q, k, lane, a.T, a.tp, a.scale);
      to_a(pa, p);
      if (!BWD) {
        a_by_rows(acc, pa, v, lane);  // o = P V, over v
        put_rows<false, D>(acc, 1.f, v, lane);
        continue;
      }
      const Rows<D> dout{lo + 3 * box, hi + 3 * box};
      float dp[2][4];
      rows_by_rows(dp, dout, v, lane);  // dP = dO V^T
      float delta[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          delta[e >> 1] = fmaf(p[n][e], dp[n][e], delta[e >> 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) delta[r] = quad_sum(delta[r]);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] = p[n][e] * (dp[n][e] - delta[e >> 1]);  // ds
      uint32_t dsa[4], t[4];
      to_a(dsa, dp);
      if (a.with_o) {
        a_by_rows(acc, pa, v, lane);  // o = P V, over v
        put_rows<false, D>(acc, 1.f, v, lane);
      }
      a_by_rows(acc, dsa, k, lane);  // dQ = dS K, over k
      put_rows<true, D>(acc, a.scale, k, lane);
      transpose_a(t, dsa);
      a_by_rows(acc, t, q, lane);  // dK = dS^T Q, over q
      put_rows<true, D>(acc, a.scale, q, lane);
      transpose_a(t, pa);
      a_by_rows(acc, t, dout, lane);  // dV = P^T dO, over dout
      put_rows<false, D>(acc, 1.f, dout, lane);
    }
    // this warp's results, written through the generic proxy, are read by
    // the storer's TMA
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(done + 8 * st);
  }
}

template <int D, bool CAUSAL, int HG, bool W>
__global__ void __launch_bounds__(TaShape<D>::THREADS, 1)
    temporal_fwd_kernel(const __grid_constant__ TaMaps<D> maps,
                        const TaArgs a) {
  temporal_body<D, false, CAUSAL, HG, W>(maps, a);
}

template <int D, bool CAUSAL, int HG, bool W>
__global__ void __launch_bounds__(TaShape<D>::THREADS, 1)
    temporal_bwd_kernel(const __grid_constant__ TaMaps<D> maps,
                        const TaArgs a) {
  temporal_body<D, true, CAUSAL, HG, W>(maps, a);
}

// The head group of a tile: the largest of a full tile's heads (8 at
// head_dim 32, 4 at 64, 2 at 128), 4, 2 and 1 that divides the heads.
int head_group(int C, int D) {
  const int heads = C / D, full = TA_HEADS * 32 / D;
  return heads % full == 0 ? full
         : heads % 4 == 0  ? 4
         : heads % 2 == 0  ? 2
                           : 1;
}

// The (d, t, h, s, b) view of a (B, T, S, C) bf16 tensor with row stride
// ld (elements) in the swizzle of its 2 D-byte rows; a box is tp frames of
// hg heads of sg positions of one b. At head_dim 128 HALVES maps, map j
// the 64 channels of each head from channel 64 j.
template <int D>
cudaError_t frame_maps(CUtensorMap* maps, const void* base, int B, int T,
                       int S, int C, int ld, int tp, int sg) {
  constexpr int DH = D / TaShape<D>::HALVES;  // channels a box row
  const cuuint64_t dims[5] = {DH, (cuuint64_t)T, (cuuint64_t)(C / D),
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)ld * 2;
  const cuuint64_t strides[4] = {row * S, 2 * D, row, row * S * T};
  const cuuint32_t box[5] = {DH, (cuuint32_t)tp,
                             (cuuint32_t)head_group(C, D), (cuuint32_t)sg, 1};
  for (int j = 0; j < TaShape<D>::HALVES; ++j)
    TPU1X_TRY(encode_map(&maps[j], static_cast<const bf16*>(base) + j * DH,
                         5, dims, strides, box, TaShape<D>::SWIZZLE));
  return cudaSuccess;
}

// The shapes the kernels take (the wrapper's `_check_qkv` raises first).
bool ta_ok(int T, int C, int D, int ld) {
  return T >= 1 && T <= 32 && (D == 32 || D == 64 || D == 128) && C >= D &&
         C % D == 0 && ld % 8 == 0;
}

// The tile at T frames: a box spans 16 frames, or 8 and twice the
// positions where T <= 8, or 32 and half the positions where T > 16, and a
// head group of HG takes TA_HEADS / HG times the positions of one of
// TA_HEADS (HG = 2: 8 positions at 16 frames, 16 at 8, 4 at 32; HG = 1 at
// head_dim 32: 16, 32 and 8), so that a
// stage holds TA_BOX bytes a tensor and a tile TA_WARPS 16-row problems, or
// TA_WARPS / 2 of 32 rows, either way (frames t >= T come back from TMA as
// zeros and still count). Every (D, HG) pair gives whole positions.
TaArgs args_of(int B, int T, int S, int C, int D, float scale) {
  TaArgs a = {};
  const int hg = head_group(C, D);
  a.T = T, a.S = S, a.C = C, a.scale = scale;
  a.tp = T <= 8 ? 8 : T <= 16 ? 16 : 32;
  a.sg = TA_POSITIONS * (TA_HEADS * 32 / D / hg) * 16 / a.tp;
  a.s_tiles = (S + a.sg - 1) / a.sg;
  a.h_groups = C / D / hg;
  a.tiles = B * a.s_tiles * a.h_groups;
  return a;
}

template <int D, bool BWD, bool CAUSAL, int HG, bool W>
cudaError_t launch_form(const TaMaps<D>& maps, const TaArgs& a,
                        cudaStream_t stream) {
  if (a.tiles == 0) return cudaSuccess;
  constexpr int smem = ta_smem(BWD ? 4 : 3), threads = TaShape<D>::THREADS;
  auto kernel = BWD ? temporal_bwd_kernel<D, CAUSAL, HG, W>
                    : temporal_fwd_kernel<D, CAUSAL, HG, W>;
  // the shared-memory limit and the resident blocks, set at the first call
  static int resident = 0;
  if (resident == 0)
    TPU1X_TRY(resident_blocks(kernel, threads, smem, &resident));
  const int grid = a.tiles < resident ? a.tiles : resident;
  kernel<<<grid, threads, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

// The form of 8 or 16 frames a box, or with tp = 32 the wide one.
template <int D, bool BWD, bool CAUSAL, int HG>
cudaError_t launch_hg(const TaMaps<D>& maps, const TaArgs& a,
                      cudaStream_t stream) {
  return a.tp == 32 ? launch_form<D, BWD, CAUSAL, HG, true>(maps, a, stream)
                    : launch_form<D, BWD, CAUSAL, HG, false>(maps, a, stream);
}

template <int D, bool BWD, bool CAUSAL>
cudaError_t launch(const TaMaps<D>& maps, const TaArgs& a,
                   cudaStream_t stream) {
  const int hg = head_group(a.C, D);
  if constexpr (D == 128) {
    return hg == 2 ? launch_hg<128, BWD, CAUSAL, 2>(maps, a, stream)
                   : launch_hg<128, BWD, CAUSAL, 1>(maps, a, stream);
  } else if constexpr (D == 64) {
    return hg == 4   ? launch_hg<64, BWD, CAUSAL, 4>(maps, a, stream)
           : hg == 2 ? launch_hg<64, BWD, CAUSAL, 2>(maps, a, stream)
                     : launch_hg<64, BWD, CAUSAL, 1>(maps, a, stream);
  } else {
    switch (hg) {
      case TA_HEADS:
        return launch_hg<32, BWD, CAUSAL, TA_HEADS>(maps, a, stream);
      case 4:
        return launch_hg<32, BWD, CAUSAL, 4>(maps, a, stream);
      case 2:
        return launch_hg<32, BWD, CAUSAL, 2>(maps, a, stream);
      default:
        return launch_hg<32, BWD, CAUSAL, 1>(maps, a, stream);
    }
  }
}

template <int D>
cudaError_t forward_d(const void* q, const void* k, const void* v, void* out,
                      int B, int T, int S, int C, int ld, float scale,
                      bool causal, cudaStream_t st) {
  constexpr int NH = TaShape<D>::HALVES;
  const TaArgs a = args_of(B, T, S, C, D, scale);
  TaMaps<D> maps = {};
  const void* in[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    TPU1X_TRY(frame_maps<D>(&maps.in[i * NH], in[i], B, T, S, C, ld, a.tp,
                            a.sg));
  TPU1X_TRY(frame_maps<D>(&maps.out[0], out, B, T, S, C, C, a.tp, a.sg));
  return causal ? launch<D, false, true>(maps, a, st)
                : launch<D, false, false>(maps, a, st);
}

template <int D>
cudaError_t backward_d(const void* const* in, void* const* out, int B, int T,
                       int S, int C, int ld, int ld_do, int ld_out,
                       float scale, bool causal, cudaStream_t st) {
  constexpr int NH = TaShape<D>::HALVES;
  TaArgs a = args_of(B, T, S, C, D, scale);
  a.with_o = out[0] != nullptr;
  TaMaps<D> maps = {};
  for (int i = 0; i < 4; ++i)
    TPU1X_TRY(frame_maps<D>(&maps.in[i * NH], in[i], B, T, S, C,
                            i == 3 ? ld_do : ld, a.tp, a.sg));
  for (int i = 0; i < 4; ++i)
    if (out[i] != nullptr)
      TPU1X_TRY(frame_maps<D>(&maps.out[i * NH], out[i], B, T, S, C,
                              i == 0 ? C : ld_out, a.tp, a.sg));
  return causal ? launch<D, true, true>(maps, a, st)
                : launch<D, true, false>(maps, a, st);
}

}  // namespace

// q, k, v: element (b, t, s, c) at ((b T + t) S + s) ld + c; out contiguous;
// heads of D = 32, 64 or 128 channels.
extern "C" int tpu1x_temporal_attention(const void* q, const void* k,
                                        const void* v, void* out, int B, int T,
                                        int S, int C, int D, int ld,
                                        float scale, int causal,
                                        void* stream) {
  if (!ta_ok(T, C, D, ld)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (D == 32   ? forward_d<32>
          : D == 64 ? forward_d<64>
                    : forward_d<128>)(q, k, v, out, B, T, S, C, ld, scale,
                                      causal != 0, st);
}

// q, k, v at row stride ld, dout at ld_do, dq / dk / dv at ld_out (so that
// the three can be column slices of one (B, T, S, 3C) tensor); o, where not
// null, contiguous: the forward's output, as tpu1x_temporal_attention
// writes it.
extern "C" int tpu1x_temporal_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* o,
    void* dq, void* dk, void* dv, int B, int T, int S, int C, int D, int ld,
    int ld_do, int ld_out, float scale, int causal, void* stream) {
  if (!ta_ok(T, C, D, ld) || ld_do % 8 || ld_out % 8)
    return cudaErrorInvalidValue;
  const void* in[4] = {q, k, v, dout};
  void* out[4] = {o, dq, dk, dv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (D == 32   ? backward_d<32>
          : D == 64 ? backward_d<64>
                    : backward_d<128>)(in, out, B, T, S, C, ld, ld_do, ld_out,
                                       scale, causal != 0, st);
}
