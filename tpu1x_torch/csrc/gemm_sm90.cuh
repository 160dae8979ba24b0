// C = epilogue(A B) on the tensor cores of Hopper: bf16 operands, fp32
// accumulators. Two families of instantiations share the kernel:
// - the serving chain, row-major A (M, K), B (K, N) and C (M, N), the
//   epilogue of the JAX serving path: round to bf16, + bias (rounded),
//   GELU (rounded), + residual (rounded). It carries the weight products of
//   the spatial block (K1: qkv, proj) and of the temporal+MLP block (K2 and
//   K3: qkv, proj, fc1 with the GELU, fc2);
// - the training forms of the MLP train block (K13), each operand stored
//   row-major as the caller has it: NN, A (M, K) B (K, N); NT, B stored
//   (N, K) (d_g = dout Wfc2^T, d_xn = d_h Wfc1^T); TN, A stored (K, M)
//   (dWfc2 = g^T dout, dWfc1 = xn^T d_h over all rows). Their epilogues are
//   the training chain: fp32 accumulator + bias, GELU (or times GELU'(aux),
//   aux the bf16 pre-activation), rounded once, then + residual (rounded),
//   optionally also storing the rounded pre-activation (`pre`, for the
//   backward's recompute); or the fp32 accumulators stored (NT, the d_xn
//   that goes to the LN backward); or, for TN, added with fp32 atomics into
//   a zeroed buffer, the reduction over K split in chunks (the launcher
//   picks how many) so that the few output tiles of a weight gradient fill
//   the card. The same forms carry every product of the spatial and
//   temporal train blocks (K11, K12) but K11's qkv recompute, which is the
//   serving chain's (the forward's rounding).
// The GELU, the operand layouts and the epilogue are template parameters,
// so the serving instantiations compile to the code they had before the
// training forms existed (one epilogue for every use once cost the rollout
// 5%).
//
// Bound on the H100: tensor-core operations for K1's products (2 M K N
// FLOP against (M K + K N + 2 M N) bf16 values: at M = 4096, K = 512,
// N = 1536, 6.4 GFLOP, 0.0065 ms at 989 TFLOP/s, against 18.4 MB, 0.0055 ms
// at 3.35 TB/s) and for K13's (68.7 GFLOP each at 32768 rows, C = 512, F4 =
// 2048, 0.069 ms); the products must reach the card's rate, which only
// wgmma fed by TMA does. The design:
// - persistent blocks walk work units, tile blockIdx.x, + gridDim.x, ...,
//   output tiles of 128 x 64, n fastest, so that the blocks that run
//   together share A's rows and B stays in L2 (TN: unit = split x tiles +
//   tile, each split a contiguous chunk of K);
// - one thread of a producer warp loads, per 64-deep step of K, the A tile
//   (128 x 64) and the B tile (64 x 64) by TMA in the 128-byte swizzle into
//   a ring of stages (G9_STAGES; three for the staged epilogue below), each
//   with a full and an empty mbarrier; it
//   runs ahead of the consumers across tiles, so the next tile's loads
//   overlap this tile's epilogue;
// - two consumer warpgroups each own 64 rows of the tile and issue wgmma
//   m64n64k16, four k16 steps a stage, keeping one stage's group in flight
//   and releasing the stage before it. Operand layouts in shared memory:
//   K-major (A of NN and NT, B of NT: rows of 64 K values, 128 bytes; the
//   descriptor steps 32 bytes along K, sbo 1 KB between 8-row groups) or
//   MN-major (B of NN and TN, A of TN: rows of 64 M or N values, one per
//   K; trans flag 1, sbo 1 KB between 8-row groups of K, the descriptor
//   steps 2 KB per k16; lbo, the bytes between 64-column atoms, is unused
//   at this width). TN loads A as two boxes of 64 M x 64 K, one for each
//   warpgroup's 64 rows, which is the same 8 KB offset as the K-major
//   tile's;
// - the serving and the fp32 epilogues work on the accumulator registers
//   and store bf16 or fp32 pairs (or add them atomically). The bf16
//   training chain stages its tiles in shared memory instead: each
//   warpgroup writes its 64 x 64 output tile (and the pre-activation) in
//   the 128-byte swizzle, and one thread stores it by TMA while the
//   warpgroup's next tile runs; aux or resid arrives the same way, loaded
//   by TMA at the start of the tile. Stored from registers, fc1 with the
//   pre-activation ran at 131 TFLOP/s and d_g at 159 (eight warp stores of
//   4 bytes a row per element pair, not overlapped with any product);
//   staged, at 257 and 220 (32768 rows, C = 512, F4 = 2048; device time on
//   an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py's gemm90_train
//   phase).
// The tile width, 64 columns, was chosen by measurement at K1's products
// (M = 4096 / 8192 / 32768 rows, K = 512; device time on an NVIDIA H100
// 80GB HBM3 at 700 W, chip_variants.py gemm): against 128 columns (wgmma
// m64n128k16, two B boxes a stage, lbo the 8 KB between them), qkv (N =
// 1536) 0.0244 / 0.0461 / 0.1685 ms against 0.0273 / 0.0542 / 0.2016, proj
// (N = 512, with bias and residual) 0.0114 / 0.0214 / 0.0898 against
// 0.0150 / 0.0285 / 0.1316: twice the tiles fill the 132 SMs more evenly,
// and a tile's epilogue is half as long.
//
// ptxas (sm_90a): 62 registers a thread without the GELU, 66 with the tanh
// GELU, 72 with the erf GELU, no spills; 99392 bytes of dynamic shared
// memory a block (four 24 KB stages): two blocks an SM. The training
// instantiations take 58 to 72 registers, no spills; the staged ones 107584
// bytes (three stages, four 8 KB tiles), two blocks an SM. On K2's MLP
// products (4096 rows, C = 512, F4 = 2048; device time on an NVIDIA H100
// 80GB HBM3 at 700 W, chip_smoke.py's gemm_sm90 phase) fc1 with the GELU
// runs at 210-218 TFLOP/s, fc2 (K = 2048) at 381-383.
//
// Requires N % 8 == 0, K % 8 == 0 (the 16-byte row strides of the tensor
// maps), 16-byte aligned rows; any M (TMA fills the rows past M with zeros,
// and the epilogue or the TMA store skips them; TN: M % 8 == 0). N and K
// need not be multiples of the tile's 64: a rank's share of GENIE_35M's
// heads at tp = 8 is N = 96 (qkv) and K = 32 (proj). The last tile of N and
// the last step of K then overhang: TMA fills the overhang of the operands
// with zeros (which add nothing to a product), the epilogues skip the
// columns past N (a warp-uniform test of each 8-column group), and the
// staged TMA store writes only the columns that exist. That form is an
// instantiation of its own (RAGGED), launched only where N % 64 or K % 64
// is not 0: the test in the epilogue, compiled into every form, cost the
// serving chain's GELU forms 4-10% (fc1 at 4096 / 8192 rows; A/B on an
// NVIDIA H100 80GB HBM3 at 700 W, `chip_variants.py ab_times groups`).

#pragma once

#include "sm90.cuh"

namespace tpu1x {

constexpr int G9_BM = 128, G9_BN = 64, G9_BK = 64, G9_STAGES = 4;

// The products the GEMM takes (any M >= 0): every row stride of its tensor
// maps a multiple of 16 bytes. TN also needs M % 8 == 0 (A stored (K, M)).
__host__ __device__ constexpr bool g9_shape_ok(int M, int N, int K) {
  return M >= 0 && N > 0 && K > 0 && N % 8 == 0 && K % 8 == 0;
}
// Tiles of N and steps of K, the last of either overhanging where N or K is
// not a multiple of 64.
__host__ __device__ constexpr int g9_n_tiles(int N) {
  return (N + G9_BN - 1) / G9_BN;
}
__host__ __device__ constexpr int g9_k_steps(int K) {
  return (K + G9_BK - 1) / G9_BK;
}
// Whether a product needs the overhanging (RAGGED) form.
__host__ __device__ constexpr bool g9_ragged(int N, int K) {
  return N % G9_BN != 0 || K % G9_BK != 0;
}
// operand layouts, as stored: NN A (M, K) B (K, N); NT B (N, K); TN A (K, M)
enum { G9_NN = 0, G9_NT = 1, G9_TN = 2 };
// epilogues: the serving chain; the training chain (bf16); fp32 store;
// fp32 atomic adds (TN)
enum { G9_SERVE = 0, G9_FUSED = 1, G9_F32 = 2, G9_RED = 3 };
// two consumer warpgroups (threads 0-255) and a producer warp
constexpr int G9_THREADS = 288;

// d (64 x 64, fp32) {=, +=} A (64 x 16) B (16 x 64), both from shared
// memory; TA, TB: the transposed flags (0: K-major, 1: MN-major); acc 0
// overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}
constexpr int G9_A_BYTES = G9_BM * G9_BK * 2;  // 16 KB
constexpr int G9_B_BYTES = G9_BK * G9_BN * 2;  // 8 KB
constexpr int G9_STAGE = G9_A_BYTES + G9_B_BYTES;
// Shared memory of one epilogue's instantiations: 1 KB to align the ring
// on the 128-byte swizzle's repeat, the stages, the staged tiles, the
// stages' full and empty mbarriers and the staged tiles' mbarriers. The
// bf16 training chain stages two 8 KB tiles for each warpgroup: its output,
// stored by TMA, and a second one, the pre-activation stored beside it or
// the tile of aux or resid that the epilogue reads, loaded by TMA while the
// tile's products run; with three stages in the ring, two blocks an SM
// still fit. The other epilogues keep the ring of G9_STAGES and store from
// registers.
template <int EPI>
struct G9Layout {
  static constexpr bool staged = EPI == G9_FUSED;
  static constexpr int stages = staged ? 3 : G9_STAGES;
  static constexpr int out_tile = 64 * G9_BN * 2;
  static constexpr int staging = staged ? 2 * 2 * out_tile : 0;
  static constexpr int smem = 1024 + stages * G9_STAGE + staging +
                              2 * 8 * stages + (staged ? 2 * 8 : 0);
};

struct Gemm90Args {
  bf16* C;            // (M, N)
  const bf16* bias;   // (N,) or null
  const bf16* resid;  // (M, N) or null
  int M, N, K;
  // the training forms
  bf16* pre;          // G9_FUSED: (M, N) rounded acc + bias, or null
  const bf16* aux;    // G9_FUSED with ACT_DGELU_*: (M, N) pre-activation
  float* Cf;          // G9_F32: (M, N) output; G9_RED: (M, N), zeroed
  int splits;         // G9_RED: chunks of the reduction over K (set by
                      // launch_gemm90_act)
};

// The fp32 epilogues on one thread's accumulators, rows r0 and r0 + 8,
// columns c0 + 8 j and + 1 (acc[4 j + 2 h + e]), the tile's first column
// n0: stored (G9_F32) or added atomically (G9_RED); RAGGED skips the
// columns past N.
template <int EPI, bool RAGGED>
__device__ __forceinline__ void f32_epilogue(const Gemm90Args& p,
                                             const float* acc, int r0,
                                             int n0, int c0) {
#pragma unroll
  for (int j = 0; j < G9_BN / 8; ++j) {
    if (RAGGED && n0 + 8 * j >= p.N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= p.M) continue;
      float* o = p.Cf + (long)row * p.N + c0 + 8 * j;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if constexpr (EPI == G9_RED) {
        atomicAdd(o, v0);
        atomicAdd(o + 1, v1);
      } else {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      }
    }
  }
}

// The bf16 training chain on one thread's accumulators, rows r and r + 8
// of its warpgroup's 64-row tile, columns n0 + 8 j + 2 t4 and + 1: fp32
// acc + bias (the pre-activation, rounded into `second` if p.pre), GELU or
// times GELU'(aux), one rounding, + resid rounded, into `out`; aux or resid
// is read from `second`. The tiles are 64 rows of 128 bytes in the
// 128-byte swizzle of their TMA boxes (16-byte chunk j of row r at
// j ^ (r & 7)): a warp's 32 pairs fall in 32 different banks. Rows past M
// and columns past N hold the zeros that TMA loaded (the bias is not read
// there), and TMA does not store them.
template <int ACT, bool RAGGED>
__device__ __forceinline__ void fused_epilogue(const Gemm90Args& p,
                                               const float* acc, int n0,
                                               int r, int t4,
                                               unsigned char* out,
                                               unsigned char* second) {
#pragma unroll
  for (int j = 0; j < G9_BN / 8; ++j) {
    float2 bb = make_float2(0.f, 0.f);
    if (p.bias && (!RAGGED || n0 + 8 * j < p.N))
      bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          p.bias + n0 + 8 * j + 2 * t4));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h;
      uint32_t* const o =
          reinterpret_cast<uint32_t*>(out + rr * 128 + ((j ^ (rr & 7)) << 4) +
                                      4 * t4);
      uint32_t* const o2 = o + (second - out) / 4;
      float v0 = acc[4 * j + 2 * h] + bb.x, v1 = acc[4 * j + 2 * h + 1] + bb.y;
      float2 in = make_float2(0.f, 0.f);  // aux or resid
      if (p.pre)
        *o2 = pack_bf16(v0, v1);
      else if (p.aux || p.resid)
        in = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o2));
      if constexpr (ACT == ACT_GELU_TANH || ACT == ACT_GELU_ERF) {
        v0 = gelu(v0, ACT), v1 = gelu(v1, ACT);
      } else if constexpr (ACT == ACT_DGELU_TANH || ACT == ACT_DGELU_ERF) {
        v0 *= dgelu(in.x, ACT == ACT_DGELU_TANH);
        v1 *= dgelu(in.y, ACT == ACT_DGELU_TANH);
      }
      v0 = bf16r(v0), v1 = bf16r(v1);
      if (p.resid) v0 = bf16r(in.x + v0), v1 = bf16r(in.y + v1);
      *o = pack_bf16(v0, v1);
    }
  }
}

// ta: A in boxes of 64 K x 128 M (K-major) or 64 M x 64 K (TN); tb: B in
// boxes of 64 N x 64 K (MN-major) or 64 K x 64 N (NT); tc, t2 (G9_FUSED
// only): C, and p.pre, p.aux or p.resid (at most one of them), in boxes of
// 64 N x 64 M; all 128-byte swizzle. grid:
// the work units or the resident blocks, whichever are fewer. ACT:
// ACT_NONE, ACT_GELU_TANH or ACT_GELU_ERF, or with G9_FUSED ACT_DGELU_TANH
// or ACT_DGELU_ERF. RAGGED: N or K not a multiple of 64 (g9_ragged).
template <int ACT, int FORM, int EPI, bool RAGGED>
__global__ void __launch_bounds__(G9_THREADS)
    gemm90_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb, Gemm90Args p,
                  const __grid_constant__ CUtensorMap tc,
                  const __grid_constant__ CUtensorMap t2) {
  using Lay = G9Layout<EPI>;
  constexpr int ST = Lay::stages;
  extern __shared__ unsigned char g9_raw[];
  const uint32_t raw = smem_u32(g9_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t full = ring + ST * G9_STAGE + Lay::staging;
  const uint32_t empty = full + 8 * ST;
  const uint32_t loaded = empty + 8 * ST;  // G9_FUSED: a warpgroup's t2 tile
  const int tid = threadIdx.x, wg = tid >> 7;  // 2: the producer warp
  const int n_tiles = RAGGED ? g9_n_tiles(p.N) : p.N / G9_BN;
  const int tiles = (p.M + G9_BM - 1) / G9_BM * n_tiles;
  int units = tiles, steps = RAGGED ? g9_k_steps(p.K) : p.K / G9_BK;
  if constexpr (EPI == G9_RED) units *= p.splits, steps /= p.splits;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    if constexpr (Lay::staged)
      mbar_init(loaded, 1), mbar_init(loaded + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread
    if (tid != 256) return;
    int s = 0;
    uint32_t ph = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int tile = u, k0 = 0;
      if constexpr (EPI == G9_RED) tile = u % tiles, k0 = u / tiles * steps;
      const int m0 = tile / n_tiles * G9_BM, n0 = tile % n_tiles * G9_BN;
      for (int k = 0; k < steps; ++k) {
        mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t dst = ring + s * G9_STAGE, bar = full + 8 * s;
        const int kc = (k0 + k) * G9_BK;
        mbar_expect_tx(bar, G9_STAGE);
        if constexpr (FORM == G9_TN) {
          tma_load_2d(dst, &ta, m0, kc, bar);
          tma_load_2d(dst + G9_A_BYTES / 2, &ta, m0 + 64, kc, bar);
        } else {
          tma_load_2d(dst, &ta, kc, m0, bar);
        }
        if constexpr (FORM == G9_NT)
          tma_load_2d(dst + G9_A_BYTES, &tb, kc, n0, bar);
        else
          tma_load_2d(dst + G9_A_BYTES, &tb, n0, kc, bar);
        if (++s == ST) s = 0, ph ^= 1;
      }
    }
    return;
  }

  // a consumer: rows 64 wg .. + 63 of each tile
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  const int row_off = wg * 64;
  // G9_FUSED: this warpgroup's two staged tiles, its leader thread
  const int buf = ring + ST * G9_STAGE - raw + wg * 2 * Lay::out_tile;
  const bool leader = (tid & 127) == 0, side_in = p.aux || p.resid;
  int s = 0;
  uint32_t ph = 0, lph = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = EPI == G9_RED ? u % tiles : u;
    const int m0 = tile / n_tiles * G9_BM, n0 = tile % n_tiles * G9_BN;
    if constexpr (Lay::staged) {
      // aux or resid lands while the products run; the last tile's
      // epilogue has read the buffer (the barrier after it)
      if (side_in && leader) {
        mbar_expect_tx(loaded + 8 * wg, Lay::out_tile);
        tma_load_2d(raw + buf + Lay::out_tile, &t2, n0, m0 + row_off,
                    loaded + 8 * wg);
      }
    }
    // acc[4 j + e]: row warp 16 + g + 8 (e >> 1), column 8 j + 2 t4 + (e & 1)
    float acc[G9_BN / 2];
    int prev = -1;
    for (int k = 0; k < steps; ++k) {
      mbar_wait(full + 8 * s, ph);
      const uint32_t a = ring + s * G9_STAGE + row_off * 128;
      const uint32_t b = ring + s * G9_STAGE + G9_A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // K-major: 32 bytes a k16 step; MN-major: 16 rows of 128 bytes
        const uint64_t da =
            FORM == G9_TN
                ? gmma_desc(a + 2048 * kk, 1024, 8192, GMMA_SWIZZLE_128B)
                : gmma_desc(a + 32 * kk, 1024, 16, GMMA_SWIZZLE_128B);
        const uint64_t db =
            FORM == G9_NT
                ? gmma_desc(b + 32 * kk, 1024, 16, GMMA_SWIZZLE_128B)
                : gmma_desc(b + 2048 * kk, 1024, 8192, GMMA_SWIZZLE_128B);
        wgmma_n64<FORM == G9_TN, FORM != G9_NT>(acc, da, db, k | kk);
      }
      wgmma_commit();
      // the step before has finished reading its stage
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == ST) s = 0, ph ^= 1;
    }
    wgmma_wait<0>();
    hold(acc);
    if (lane == 0) mbar_arrive(empty + 8 * prev);

    if constexpr (EPI == G9_SERVE) {
#pragma unroll
      for (int j = 0; j < G9_BN / 8; ++j) {
        if (RAGGED && n0 + 8 * j >= p.N) continue;  // past N (N % 8 == 0)
        const int col = n0 + 8 * j + 2 * t4;
        float2 bb = make_float2(0.f, 0.f);
        if (p.bias)
          bb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p.bias + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + row_off + warp * 16 + g + 8 * h;
          if (row >= p.M) continue;
          const long at = (long)row * p.N + col;
          float v0 = bf16r(acc[4 * j + 2 * h]), v1 = bf16r(acc[4 * j + 2 * h + 1]);
          if (p.bias) v0 = bf16r(v0 + bb.x), v1 = bf16r(v1 + bb.y);
          if constexpr (ACT != ACT_NONE)
            v0 = bf16r(gelu(v0, ACT)), v1 = bf16r(gelu(v1, ACT));
          if (p.resid) {
            const float2 rr = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(p.resid + at));
            v0 = bf16r(rr.x + v0), v1 = bf16r(rr.y + v1);
          }
          *reinterpret_cast<uint32_t*>(p.C + at) = pack_bf16(v0, v1);
        }
      }
    } else if constexpr (EPI == G9_FUSED) {
      // this warpgroup's tiles go out by TMA while its next tile runs
      if (leader) bulk_wait_read();  // the last tile's stores have read them
      if (side_in) mbar_wait(loaded + 8 * wg, lph), lph ^= 1;
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      fused_epilogue<ACT, RAGGED>(p, acc, n0, warp * 16 + g, t4,
                                  g9_raw + buf,
                          g9_raw + buf + Lay::out_tile);
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if (leader) {
        tma_store_2d(&tc, raw + buf, n0, m0 + row_off);
        if (p.pre)
          tma_store_2d(&t2, raw + buf + Lay::out_tile, n0, m0 + row_off);
        bulk_commit();
      }
    } else {
      f32_epilogue<EPI, RAGGED>(p, acc, m0 + row_off + warp * 16 + g, n0,
                        n0 + 2 * t4);
    }
  }
  if constexpr (EPI == G9_FUSED)
    if ((tid & 127) == 0) bulk_wait();
}

// One instantiation's launch; `resident` is kept for each, since two
// instantiations need not have the same occupancy. `static`: an `inline`
// launcher's static would be shared by every library of the process that
// includes this header.
// tc and t2 are read by G9_FUSED only. `units`: the output tiles.
template <int ACT, int FORM, int EPI, bool RAGGED>
static cudaError_t launch_gemm90_form(const CUtensorMap& ta,
                                      const CUtensorMap& tb,
                                      const Gemm90Args& a, int units,
                                      cudaStream_t stream,
                                      const CUtensorMap& tc,
                                      const CUtensorMap& t2) {
  constexpr int smem = G9Layout<EPI>::smem;
  // the blocks the card keeps resident, found once a process
  static int resident = 0;
  if (resident == 0)
    TPU1X_TRY(resident_blocks(gemm90_kernel<ACT, FORM, EPI, RAGGED>,
                              G9_THREADS, smem, &resident));
  Gemm90Args p = a;
  if constexpr (EPI == G9_RED) {
    // chunks of the reduction over K: the most, up to 8 and dividing its
    // steps of 64, that keep tiles x chunks within one wave of the resident
    // blocks. On
    // an H100 (chip_variants.py tn): 2 at K13's weight gradients (128 tiles
    // for 264 blocks; 1 and 4 were slower) and at K11's and K12's dWqkv (96
    // tiles); 8 at their dWproj (32 tiles), 13-15% less time than 4 (at
    // 4, one block an SM had nothing to overlap with)
    int s = 8;
    while (s > 1 && (g9_k_steps(a.K) % s || units * s > resident)) --s;
    p.splits = s;
    units *= s;
  }
  gemm90_kernel<ACT, FORM, EPI, RAGGED>
      <<<units < resident ? units : resident, G9_THREADS, smem, stream>>>(
          ta, tb, p, tc, t2);
  return cudaGetLastError();
}

// The form a product takes: RAGGED where N or K is not a multiple of 64.
template <int ACT, int FORM = G9_NN, int EPI = G9_SERVE>
static cudaError_t launch_gemm90_act(const CUtensorMap& ta,
                                     const CUtensorMap& tb, const Gemm90Args& a,
                                     int units, cudaStream_t stream,
                                     const CUtensorMap& tc,
                                     const CUtensorMap& t2) {
  return g9_ragged(a.N, a.K)
             ? launch_gemm90_form<ACT, FORM, EPI, true>(ta, tb, a, units,
                                                        stream, tc, t2)
             : launch_gemm90_form<ACT, FORM, EPI, false>(ta, tb, a, units,
                                                         stream, tc, t2);
}

// C = epilogue(A B) with A (M, K), B (K, N), C and resid (M, N) contiguous
// bf16, bias (N,) bf16 or null, resid null or not, act one of ACT_NONE,
// ACT_GELU_TANH, ACT_GELU_ERF.
static inline cudaError_t launch_gemm90(const void* A, const void* B,
                                        void* C, const void* bias,
                                        const void* resid, int M, int N, int K,
                                        cudaStream_t stream,
                                        int act = ACT_NONE) {
  if (!g9_shape_ok(M, N, K) ||
      (act != ACT_NONE && act != ACT_GELU_TANH && act != ACT_GELU_ERF))
    return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  CUtensorMap ta, tb;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t a_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t a_box[2] = {G9_BK, G9_BM};
  TPU1X_TRY(encode_map(&ta, A, 2, a_dims, a_strides, a_box,
                       CU_TENSOR_MAP_SWIZZLE_128B));
  const cuuint64_t b_dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t b_strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t b_box[2] = {G9_BN, G9_BK};
  TPU1X_TRY(encode_map(&tb, B, 2, b_dims, b_strides, b_box,
                       CU_TENSOR_MAP_SWIZZLE_128B));
  Gemm90Args a{static_cast<bf16*>(C), static_cast<const bf16*>(bias),
               static_cast<const bf16*>(resid), M, N, K, nullptr, nullptr,
               nullptr, 1};
  const int tiles = (M + G9_BM - 1) / G9_BM * g9_n_tiles(N);
  if (act == ACT_GELU_TANH)
    return launch_gemm90_act<ACT_GELU_TANH>(ta, tb, a, tiles, stream, ta, tb);
  if (act == ACT_GELU_ERF)
    return launch_gemm90_act<ACT_GELU_ERF>(ta, tb, a, tiles, stream, ta, tb);
  return launch_gemm90_act<ACT_NONE>(ta, tb, a, tiles, stream, ta, tb);
}

// A (rows, cols) row-major bf16 as a tensor map in boxes of 64 columns x
// box_rows rows, 128-byte swizzle.
static inline cudaError_t g9_map(CUtensorMap* map, const void* base, int rows,
                                 int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return encode_map(map, base, 2, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace tpu1x
