// The flash attention forward (K9), shared by csrc/flash_attention.cu,
// which binds it as `flash_mha`, and csrc/spatial_block.cu, whose pre-LN
// attention it is, so that both compile the same device code.
//
// softmax(q k^T scale [causal]) v over the N tokens of each (row, head), on
// q, k, v shaped (R, N, H, D), head_dim D = 32 or 64 (a template
// parameter), and read in place through their strides (the thirds of a
// (rows, N, 3C) qkv product need no copy); o contiguous (R, N, H, D); and
// the per-query log-sum-exp of the scaled logits that the backward
// (csrc/flash_attention.cu) starts from: lse (R, H, N) fp32,
// element (r, h, n) at (r H + h) N + n, in natural units,
// lse = ln sum_j exp(scale s_nj) over the keys in view.
//
// What bounds it on the H100, at the qk_norm train step's (R, N, H, D) =
// (128, 256, 16, 32): it reads q, k, v and writes o once each, 134 MB,
// 0.040 ms at 3.35 TB/s (lse adds 2 MB); its two products are 17.2 GFLOP,
// 0.017 ms at 989 TFLOP/s; and its 134 M exponentials take 0.036 ms on the
// special function units (16 a clock an SM at 1.755 GHz): two floors of
// about the same height, so the loads, the products and the softmax have
// to run side by side. The design: persistent blocks of two warpgroups,
// two blocks an SM, each walking (row, head) items; each item's q, k and v
// are loaded once, by TMA into a two-stage ring in the 64-byte swizzle of
// wgmma's operands, the next item's loads in flight while the current one
// computes; S = Q K^T and O = P V are wgmma (the second with p from
// registers), an online softmax over 64-key chunks, the row sums on the
// tensor cores too; o leaves by TMA store. The time left goes mostly to
// the softmax's FP32 work and to issuing the wgmma groups (a warpgroup's
// four warps wait for each other there), little to the exponentials or to
// waiting for loads: hence the loads and the store on TMA, the row sums on
// the tensor cores and the scale folded into the FFMA, each of which takes
// work off the issuing threads (PERF.md).
// A chunk loop's last iteration is code of its own: with the next chunk's
// logits issued under a branch, ptxas serialises all of the kernel's wgmma
// (its warning C7520), which cost 3-8% (PERF.md, chip_variants.py).
// ptxas (sm_90a), head_dim 32: 96 registers a thread under the causal
// mask, 100 without (either sign of the scale), no spills (an 8-byte stack
// frame), 100368 bytes of dynamic shared memory a block (two 48 KB stages,
// the ones tile, two mbarriers, 1 KB for alignment): two blocks an SM.
//
// Head_dim 64. A row is 128 bytes, so the operands take the 128-byte
// swizzle (and wgmma's descriptors the same), the logits four k16 steps
// and P V wgmma m64n64k16; o holds 32 fp32 values a thread. An item's q, k
// and v are 96 KB: two stages would leave one block an SM (two
// warpgroups), whose loads and compute then alternate on the SM except
// for the one item in flight. The kernel instead keeps one stage of whole
// heads (the same 100368 bytes) at two blocks an SM: each block loads its
// next item only after its stores have read the stage, and the other
// block's compute covers that load. Streaming key chunks through a ring
// would keep the loads in flight within a block too, but the keys are
// read by all four query tiles, so a chunk could leave the ring only when
// the last tile has passed it: the ring holds the item all the same.
// The bytes, products and exponentials of a (row, C) are those of head_dim
// 32 (the heads halve), so both widths share one bound. ptxas (sm_90a),
// head_dim 64: 126 registers a thread without the causal mask, no spills;
// 128 and a 12-byte spill under it (the causal form runs on no main path).
//
// N <= 256, N % 64 == 0, head_dim 32 or 64, strides multiples of 8.

#pragma once

#include "sm90.cuh"

namespace tpu1x {

constexpr int FA_N = 256;   // most keys of a head held in shared memory
constexpr int FA_QT = 64;   // queries (or keys) a tile: 4 warps x 16 rows

// Byte offset of 16-byte chunk c (0..3) of row n in a swizzled operand of
// 64-byte rows.
__device__ __forceinline__ uint32_t swz64(int n, int c) {
  return n * 64 + ((c ^ ((n >> 1) & 3)) << 4);
}

// The shared-memory layout of an operand of head_dim D: rows of 2 D bytes
// (64 or 128) in the swizzle of that width, as TMA writes them and wgmma's
// descriptors read them.
template <int D>
struct FaRows {
  static_assert(D == 32 || D == 64, "head_dim 32 or 64");
  static constexpr int ROW = 2 * D;         // bytes a row
  static constexpr int TILE = FA_QT * ROW;  // a 64-row tile
  static constexpr int SBO = 8 * ROW;       // bytes between 8-row groups
  static constexpr int LAYOUT = D == 32 ? GMMA_SWIZZLE_64B : GMMA_SWIZZLE_128B;
  static constexpr CUtensorMapSwizzle MAP_SWIZZLE =
      D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  // byte offset of 16-byte chunk c (0 .. D / 8 - 1) of row n
  static __device__ __forceinline__ uint32_t at(int n, int c) {
    return D == 32 ? swz64(n, c) : n * 128 + ((c ^ (n & 7)) << 4);
  }
  // the k16 step k of a 64-row tile as a K-major operand (d contiguous)
  static __device__ __forceinline__ uint64_t kmajor(uint32_t tile, int k) {
    return gmma_desc(tile + 32 * k, SBO, 16, LAYOUT);
  }
  // 16 rows from row `row` as an MN-major B operand (the rows are the
  // product's K axis, d its N axis: one swizzle atom spans d, so the
  // leading byte offset is unused)
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int row) {
    return gmma_desc(base + row * ROW, SBO, D == 32 ? 512 : 8192, LAYOUT);
  }
};

// d (64 x 64, fp32) {=, +=} A (64 x 16) B (16 x 64)^T, both from shared
// memory, K-major; acc 0 overwrites d.
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t da, uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}
// d (64 x 32, fp32) += A (64 x 16, bf16 registers) B (16 x 32), B from
// shared memory, MN-major.
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 64, fp32) += A (64 x 16, bf16 registers) B (16 x 64), B from
// shared memory, MN-major.
__device__ __forceinline__ void wgmma_pv64(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x D) += A (64 x 16, registers) B (16 x D), B MN-major.
template <int D>
__device__ __forceinline__ void wgmma_pv_d(float* d, const uint32_t* a,
                                           uint64_t db) {
  if constexpr (D == 32)
    wgmma_pv(d, a, db);
  else
    wgmma_pv64(d, a, db);
}
// d (64 x 8, fp32) += A (64 x 16, bf16 registers) B (16 x 8), B from
// shared memory: with B all ones, each column of d is the row sum of A.
__device__ __forceinline__ void wgmma_rowsum(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// *p = v where `on`, by a predicated store (no branch).
__device__ __forceinline__ void st_if(bool on, float* p, float v) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %0, 0;\n@q st.global.f32 [%1], %2;\n}\n"
      ::"r"((int)on), "l"(p), "f"(v)
      : "memory");
}

// The tiles of an item that warpgroup wg computes: wg 0 takes tile 0 and,
// from three tiles on, the last; wg 1 the others. Under the causal mask a
// query tile sees qt + 1 key chunks (and key tile kt is seen by tiles - kt
// query chunks), so at N = 256 each warpgroup multiplies 5.
__device__ __forceinline__ int fwd_tiles(int wg, int tiles, int* qt) {
  if (wg == 0) {
    qt[0] = 0, qt[1] = tiles - 1;
    return tiles >= 3 ? 2 : 1;
  }
  qt[0] = 1, qt[1] = 2;
  return tiles == 4 ? 2 : tiles >= 2 ? 1 : 0;
}

// ---- forward ----
//
// A persistent block is two warpgroups (256 threads), two blocks an SM, and
// walks the (row, head) items blockIdx.x, blockIdx.x + gridDim.x, ... .
// Its dynamic shared memory holds a ring of FfShape<D>::STAGES stages (two
// at head_dim 32, one at 64), each the q, k and v of one item (3 x N rows
// of 2 D bytes). Thread 0 loads an item with three TMA copies, one a
// tensor map (a 4-D view (d, h, n, row) of q, k or v with the operand's
// own head, token and row strides), completing on the stage's mbarrier;
// with two stages the loads of item i + gridDim.x are in flight while the
// block computes item i, with one they start when the block's stores have
// read the stage (the SM's other block computes meanwhile), so each item's
// q, k and v come from device memory once and overlap the compute.
//
// Each warpgroup takes two of the item's 64-query tiles (0 and 3, or 1 and
// 2: under the causal mask both multiply 5 chunks of 64 keys), and for each
// walks the 64-key chunks it can see (all, or c <= qt), an online softmax:
//   S = Q K^T   wgmma m64n64k16, A = the Q tile and B = the chunk's keys,
//               both K-major (d contiguous), D / 16 k16 steps;
//   softmax     fp32 in the accumulator registers, 32 a thread: the row max
//               of the raw logits (the min when scale < 0), then
//               p = ex2(s * scale log2(e) - max), one FFMA and ex2.approx a
//               logit; the running max rescales what o and l hold so far;
//               p is rounded to bf16 straight into wgmma's register-A
//               fragment, whose layout is the accumulator's;
//   O += P V    wgmma m64nDk16, A = p from registers, B = 16 keys of V,
//               MN-major (the transposed flag), and beside it l += P 1, the
//               row sums of the rounded p as wgmma m64n8k16 against a tile
//               of ones (the tensor cores take the sums off the FP32 pipe);
//               the logits of the next chunk are issued in the same group;
//   store       o / l into the tile's own Q rows (read for the last time
//               by its last logit product) in the same swizzle, and out by
//               one TMA store a tile (a fourth tensor map, over the
//               contiguous output), which the warpgroup's first thread
//               issues and waits for, before the stage is refilled, only
//               for its reads of shared memory; lse = (max + log2 l) ln 2.
constexpr int FF_THREADS = 256;  // two warpgroups
constexpr int FF_ONES = 1024;    // the ones tile (512 bytes used)
template <int D>
struct FfShape {
  static constexpr int OP = FA_N * D * 2;  // bytes of one operand of an item
  static constexpr int STAGE = 3 * OP;     // q, k, v
  static constexpr int STAGES = D == 32 ? 2 : 1;
  // the ring starts on a 1024-byte boundary: the swizzle repeats every 512
  // or 1024 bytes, and the descriptors take every tile to start on a
  // repeat; then the ones tile and the stages' mbarriers
  static constexpr int SMEM = 1024 + STAGES * STAGE + FF_ONES + 16;
};
static_assert(FfShape<32>::SMEM == FfShape<64>::SMEM, "two blocks an SM");

// grid: the items (R H) or the blocks the card keeps resident (two an SM),
// whichever is fewer; FF_THREADS threads, dynamic shared memory
// FfShape<D>::SMEM. POS: scale > 0, and the row max of the raw logits is
// the max of the scaled ones (otherwise their min is). lse: (R, H, N) fp32.
// NORM: p is normalised before it is rounded to bf16 for P V, as the TPU
// kernel and the plain version round it: a first pass over the chunks
// takes each row's max and fp32 sum of exponentials, a second recomputes
// the logits and multiplies p / l by V (the logits twice, no row sums on
// the tensor cores). K1's qk-LN form takes it, whose int8-cache consumers
// turn a bf16 difference into a whole quantization step; otherwise p is
// rounded unnormalised and o divided by the sum of the rounded p.
template <int D, bool CAUSAL, bool POS, bool NORM = false>
__global__ void __launch_bounds__(FF_THREADS, 2)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to, float* lse,
                     int N, int H, float scale, int items) {
  using L = FaRows<D>;
  using F = FfShape<D>;
  constexpr int STAGES = F::STAGES;
  constexpr int KS = D / 16;  // k16 steps of the logits
  extern __shared__ unsigned char ff_raw[];
  const uint32_t raw = smem_u32(ff_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* ring_p = ff_raw + (ring - raw);
  const uint32_t ones = ring + STAGES * F::STAGE;
  const uint32_t bars = ones + FF_ONES;  // an 8-byte mbarrier a stage
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  const int tiles = N / FA_QT;
  const float sl2 = scale * 1.4426950408889634f;  // scale log2(e)
  const float masked = POS ? -INFINITY : INFINITY;  // ex2 of it is 0
  int my_qt[2];
  const int my_tiles = fwd_tiles(wg, tiles, my_qt);

  reinterpret_cast<uint32_t*>(ring_p + STAGES * F::STAGE)[tid] = 0x3f803f80u;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars +
                                                                    8 * st));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the ones tile is written through the generic proxy, read by wgmma
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // thread 0: the item's q, k and v into stage st, completing on its
  // mbarrier
  auto load_item = [&](int item, int st) {
    const int r = item / H, h = item % H;
    const uint32_t dst = ring + st * F::STAGE, bar = bars + 8 * st;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(3 * N * L::ROW)
        : "memory");
    const CUtensorMap* maps[3] = {&tq, &tk, &tv};
#pragma unroll
    for (int op = 0; op < 3; ++op)
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
              dst + op * F::OP),
          "l"(reinterpret_cast<uint64_t>(maps[op])), "r"(0), "r"(h), "r"(0),
          "r"(r), "r"(bar)
          : "memory");
  };

  const int first = blockIdx.x, stride = gridDim.x;
  uint32_t phase = 0;  // bit st: the parity of stage st's next completion
  if (tid == 0 && first < items) load_item(first, 0);
  int st = 0;
  for (int item = first; item < items;
       item += stride, st = STAGES == 2 ? st ^ 1 : 0) {
    // stage st ^ 1 was released by the barrier that ended the last item
    if constexpr (STAGES == 2)
      if (tid == 0 && item + stride < items) load_item(item + stride, st ^ 1);
    mbar_wait(bars + 8 * st, (phase >> st) & 1);
    phase ^= 1u << st;
    const uint32_t qs = ring + st * F::STAGE, ks = qs + F::OP,
                   vs = ks + F::OP;
    const int r = item / H, h = item % H;
    for (int i = 0; i < my_tiles; ++i) {
      const int qt = my_qt[i];
      const int nc = CAUSAL ? qt + 1 : tiles;  // 64-key chunks in view
      const uint32_t qtile = qs + qt * L::TILE;
      // s[4 j + e]: row warp 16 + g + 8 (e >> 1) of the tile, key
      // 64 c + 8 j + 2 t4 + (e & 1) of chunk c; o[4 j + e]: the same rows,
      // channel 8 j + 2 t4 + (e & 1); m: running max of the scaled logits
      // (times log2(e)) of rows g and g + 8; l: their sums
      float s[32], o[D / 2], l[4] = {0.f, 0.f, 0.f, 0.f};
      uint32_t pa[16];
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KS; ++k)
        wgmma_qk(s, L::kmajor(qtile, k), L::kmajor(ks, k), k);
      wgmma_commit();
      wgmma_wait_all();
      hold(s);
      int c = 0;
      if constexpr (NORM) {
        // pass 1: the row max and the fp32 sum of the exponentials of the
        // scaled logits over every chunk in view (no product with V)
        float e0 = 0.f, e1 = 0.f;  // this lane's share of the sums
        auto stats = [&](auto last) {
          constexpr bool LAST = decltype(last)::value;
          float c0 = masked, c1 = masked;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (CAUSAL && c == qt &&
                  8 * j + 2 * t4 + (e & 1) > warp * 16 + g + 8 * (e >> 1))
                s[4 * j + e] = masked;
            if (POS) {
              c0 = fmaxf(c0, fmaxf(s[4 * j], s[4 * j + 1]));
              c1 = fmaxf(c1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
            } else {
              c0 = fminf(c0, fminf(s[4 * j], s[4 * j + 1]));
              c1 = fminf(c1, fminf(s[4 * j + 2], s[4 * j + 3]));
            }
          }
#pragma unroll
          for (int x = 1; x <= 2; x <<= 1) {
            const float u0 = __shfl_xor_sync(0xffffffffu, c0, x);
            const float u1 = __shfl_xor_sync(0xffffffffu, c1, x);
            c0 = POS ? fmaxf(c0, u0) : fminf(c0, u0);
            c1 = POS ? fmaxf(c1, u1) : fminf(c1, u1);
          }
          const float n0 = fmaxf(m0, c0 * sl2), n1 = fmaxf(m1, c1 * sl2);
          e0 *= ex2(m0 - n0), e1 *= ex2(m1 - n1);
          m0 = n0, m1 = n1;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            e0 += ex2(fmaf(s[4 * j], sl2, -n0)) +
                  ex2(fmaf(s[4 * j + 1], sl2, -n0));
            e1 += ex2(fmaf(s[4 * j + 2], sl2, -n1)) +
                  ex2(fmaf(s[4 * j + 3], sl2, -n1));
          }
          if constexpr (!LAST) {
            const uint32_t kc = ks + (c + 1) * L::TILE;
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < KS; ++k)
              wgmma_qk(s, L::kmajor(qtile, k), L::kmajor(kc, k), k);
            wgmma_commit();
            wgmma_wait_all();
            hold(s);
          }
        };
        for (; c + 1 < nc; ++c) stats(Flag<false>{});
        stats(Flag<true>{});
        l[0] = quad_sum(e0), l[2] = quad_sum(e1);
        const float r0 = 1.f / l[0], r1 = 1.f / l[2];
        // pass 2: the logits again, p = exp(...) / l rounded to bf16 (the
        // normalised p, as the TPU kernel and `mha_reference` round it),
        // o += p V; the next chunk's logits in the same group
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KS; ++k)
          wgmma_qk(s, L::kmajor(qtile, k), L::kmajor(ks, k), k);
        wgmma_commit();
        wgmma_wait_all();
        hold(s);
        c = 0;
        auto weigh = [&](auto last) {
          constexpr bool LAST = decltype(last)::value;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = ex2(fmaf(s[4 * j + e], sl2, (e >> 1) ? -m1 : -m0)) *
                        ((e >> 1) ? r1 : r0);
              if (CAUSAL && c == qt &&
                  8 * j + 2 * t4 + (e & 1) > warp * 16 + g + 8 * (e >> 1))
                p = 0.f;
              s[4 * j + e] = p;
            }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            pa[4 * k] = pack_bf16(s[8 * k], s[8 * k + 1]);
            pa[4 * k + 1] = pack_bf16(s[8 * k + 2], s[8 * k + 3]);
            pa[4 * k + 2] = pack_bf16(s[8 * k + 4], s[8 * k + 5]);
            pa[4 * k + 3] = pack_bf16(s[8 * k + 6], s[8 * k + 7]);
          }
          hold(pa);
          hold(o);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wgmma_pv_d<D>(o, &pa[4 * k], L::mnmajor(vs, c * 64 + k * 16));
          if constexpr (!LAST) {
            const uint32_t kc = ks + (c + 1) * L::TILE;
#pragma unroll
            for (int k = 0; k < KS; ++k)
              wgmma_qk(s, L::kmajor(qtile, k), L::kmajor(kc, k), k);
          }
          wgmma_commit();
          wgmma_wait_all();
          hold(o);
          hold(s);
        };
        for (; c + 1 < nc; ++c) weigh(Flag<false>{});
        weigh(Flag<true>{});
      } else {
        // one key chunk; LAST: no chunk follows, whose logits to issue. The
        // two forms are separate code, so that no wgmma sits behind a branch
        // (ptxas serialises the wgmma of a kernel that has one)
        auto chunk = [&](auto last) {
          constexpr bool LAST = decltype(last)::value;
          float c0 = masked, c1 = masked;
  #pragma unroll
          for (int j = 0; j < 8; ++j) {
  #pragma unroll
            for (int e = 0; e < 4; ++e)
              if (CAUSAL && c == qt &&
                  8 * j + 2 * t4 + (e & 1) > warp * 16 + g + 8 * (e >> 1))
                s[4 * j + e] = masked;
            if (POS) {
              c0 = fmaxf(c0, fmaxf(s[4 * j], s[4 * j + 1]));
              c1 = fmaxf(c1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
            } else {
              c0 = fminf(c0, fminf(s[4 * j], s[4 * j + 1]));
              c1 = fminf(c1, fminf(s[4 * j + 2], s[4 * j + 3]));
            }
          }
  #pragma unroll
          for (int x = 1; x <= 2; x <<= 1) {
            const float u0 = __shfl_xor_sync(0xffffffffu, c0, x);
            const float u1 = __shfl_xor_sync(0xffffffffu, c1, x);
            c0 = POS ? fmaxf(c0, u0) : fminf(c0, u0);
            c1 = POS ? fmaxf(c1, u1) : fminf(c1, u1);
          }
          // key 0 of chunk 0 is in view of every query: the maxima are finite
          const float n0 = fmaxf(m0, c0 * sl2), n1 = fmaxf(m1, c1 * sl2);
          const float a0 = ex2(m0 - n0), a1 = ex2(m1 - n1);
          m0 = n0, m1 = n1;
  #pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[4 * j] = ex2(fmaf(s[4 * j], sl2, -n0));
            s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl2, -n0));
            s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl2, -n1));
            s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl2, -n1));
          }
          l[0] *= a0, l[1] *= a0, l[2] *= a1, l[3] *= a1;
  #pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[4 * j] *= a0, o[4 * j + 1] *= a0;
            o[4 * j + 2] *= a1, o[4 * j + 3] *= a1;
          }
          // p of 16 keys (step k) as the register-A fragment: rows g | g + 8,
          // keys 2 t4.. | 8 + 2 t4..
  #pragma unroll
          for (int k = 0; k < 4; ++k) {
            pa[4 * k] = pack_bf16(s[8 * k], s[8 * k + 1]);
            pa[4 * k + 1] = pack_bf16(s[8 * k + 2], s[8 * k + 3]);
            pa[4 * k + 2] = pack_bf16(s[8 * k + 4], s[8 * k + 5]);
            pa[4 * k + 3] = pack_bf16(s[8 * k + 6], s[8 * k + 7]);
          }
          hold(pa);
          hold(o);
          hold(l);
          // o += p V and l += p 1 of chunk c, and the logits of chunk c + 1
          wgmma_fence();
  #pragma unroll
          for (int k = 0; k < 4; ++k)
            wgmma_pv_d<D>(o, &pa[4 * k], L::mnmajor(vs, c * 64 + k * 16));
  #pragma unroll
          for (int k = 0; k < 4; ++k)
            wgmma_rowsum(l, &pa[4 * k], gmma_desc(ones, 512, 16));
          if constexpr (!LAST) {
            const uint32_t kc = ks + (c + 1) * L::TILE;
  #pragma unroll
            for (int k = 0; k < KS; ++k)
              wgmma_qk(s, L::kmajor(qtile, k), L::kmajor(kc, k), k);
          }
          wgmma_commit();
          wgmma_wait_all();
          hold(o);
          hold(l);
          hold(s);
        };
        for (; c + 1 < nc; ++c) chunk(Flag<false>{});
        chunk(Flag<true>{});
      }

      // o / l into the tile's own Q rows: rows in the swizzle that the TMA
      // store reads, which also spreads the eight rows of a store over the
      // banks
      const float i0 = NORM ? 1.f : 1.f / l[0], i1 = NORM ? 1.f : 1.f / l[2];
      const int r0 = warp * 16 + g;
      unsigned char* ot = ring_p + (qtile - ring);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(ot + L::at(r0, j) + t4 * 4) =
            pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
        *reinterpret_cast<uint32_t*>(ot + L::at(r0 + 8, j) + t4 * 4) =
            pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
      }
      // the tile out by one TMA store of the warpgroup's first thread
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if ((tid & 127) == 0) {
        asm volatile(
            "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, "
            "%2, %3, %4}], [%5];\n" ::"l"(reinterpret_cast<uint64_t>(&to)),
            "r"(0), "r"(h), "r"(qt * FA_QT), "r"(r), "r"(qtile)
            : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      // lse of rows r0 and r0 + 8 from the lane that holds their first
      // column, by predicated stores: a branch on the lane between the
      // wgmma groups would serialise them
      float* lrow = lse + (long)item * N + qt * FA_QT + r0;
      st_if(t4 == 0, lrow, (m0 + __log2f(l[0])) * 0.6931471805599453f);
      st_if(t4 == 0, lrow + 8, (m1 + __log2f(l[2])) * 0.6931471805599453f);
    }
    // the stores have read the stage before it is refilled
    if ((tid & 127) == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    // the stage's generic reads and writes (the output tiles) are ordered
    // before the TMA writes that refill it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // one stage: the next item's loads into the stage just released
    if constexpr (STAGES == 1)
      if (tid == 0 && item + stride < items) load_item(item + stride, 0);
  }
  if ((tid & 127) == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// What the flash kernels require of the shapes and strides.
inline bool flash_ok(int N, int D, const long* strides, int count) {
  if (N < 64 || N > FA_N || N % 64 || (D != 32 && D != 64)) return false;
  for (int i = 0; i < count; ++i)
    if (strides[i] % 8) return false;
  return true;
}

// The (d, h, n, row) view of a (R, N, H, D) operand with row stride rs and
// token stride ts (elements) in the swizzle of its rows (FaRows<D>); a box
// is `rows` tokens of one head of one row (0: all N, one item).
template <int D>
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, long rs,
                              long ts, int R, int N, int H, int rows = 0) {
  const cuuint64_t dims[4] = {D, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)R};
  const cuuint64_t strides[3] = {D * 2, (cuuint64_t)ts * 2,
                                 (cuuint64_t)rs * 2};
  const cuuint32_t box[4] = {D, 1, (cuuint32_t)(rows ? rows : N), 1};
  return encode_map(map, base, 4, dims, strides, box, FaRows<D>::MAP_SWIZZLE);
}

typedef void (*FwdKernel)(CUtensorMap, CUtensorMap, CUtensorMap,
                          CUtensorMap, float*, int, int, float, int);

template <int D>
static inline cudaError_t launch_flash_fwd_d(
    const void* q, const void* k, const void* v, void* out, float* lse,
    long rsq, long tsq, long rsk, long tsk, long rsv, long tsv, int R, int N,
    int H, float scale, bool causal, bool norm, cudaStream_t stream) {
  const int items = R * H;
  if (items == 0) return cudaSuccess;
  CUtensorMap maps[4];
  TPU1X_TRY(tensor_map<D>(&maps[0], q, rsq, tsq, R, N, H));
  TPU1X_TRY(tensor_map<D>(&maps[1], k, rsk, tsk, R, N, H));
  TPU1X_TRY(tensor_map<D>(&maps[2], v, rsv, tsv, R, N, H));
  TPU1X_TRY(tensor_map<D>(&maps[3], out, (long)N * H * D, (long)H * D, R, N,
                          H, FA_QT));
  // set once a process for each form: the shared memory limit and the
  // grid, every resident block of the card
  static const FwdKernel forms[6] = {
      flash_fwd_kernel<D, false, false>,      flash_fwd_kernel<D, false, true>,
      flash_fwd_kernel<D, true, false>,       flash_fwd_kernel<D, true, true>,
      flash_fwd_kernel<D, false, false, true>,
      flash_fwd_kernel<D, false, true, true>};
  static int resident[6] = {0, 0, 0, 0, 0, 0};
  if (norm && causal) return cudaErrorInvalidValue;  // no such form
  const int form = (norm ? 4 : causal ? 2 : 0) + (scale > 0.f ? 1 : 0);
  const FwdKernel kernel = forms[form];
  if (resident[form] == 0)
    TPU1X_TRY(resident_blocks(kernel, FF_THREADS, FfShape<D>::SMEM,
                              &resident[form]));
  const int grid = items < resident[form] ? items : resident[form];
  kernel<<<grid, FF_THREADS, FfShape<D>::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, N, H, scale, items);
  return cudaGetLastError();
}

// q, k, v: bf16 (R, N, H, D) views, D = 32 or 64, element (r, n, h, d) at
// r * rs + n * ts + h * D + d with each tensor's own rs and ts (multiples
// of 8, 16-byte aligned base); out bf16 (R, N, H, D) contiguous; lse fp32
// (R, H, N). norm: the NORM form (not causal).
static inline cudaError_t launch_flash_fwd(const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    long rsq, long tsq, long rsk, long tsk,
                                    long rsv, long tsv, int R, int N, int H,
                                    int D, float scale, bool causal,
                                    cudaStream_t stream, bool norm = false) {
  const long strides[6] = {rsq, tsq, rsk, tsk, rsv, tsv};
  if (!flash_ok(N, D, strides, 6)) return cudaErrorInvalidValue;
  return D == 32
             ? launch_flash_fwd_d<32>(q, k, v, out, lse, rsq, tsq, rsk, tsk,
                                      rsv, tsv, R, N, H, scale, causal, norm,
                                      stream)
             : launch_flash_fwd_d<64>(q, k, v, out, lse, rsq, tsq, rsk, tsk,
                                      rsv, tsv, R, N, H, scale, causal, norm,
                                      stream);
}

}  // namespace tpu1x
