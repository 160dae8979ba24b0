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
// Forward, and what bounds it on the H100. At the qk_norm train step's
// (R, N, H, D) = (128, 256, 16, 32) it reads q, k, v and writes o once each,
// 134 MB, 0.040 ms at 3.35 TB/s; its two products are 17.2 GFLOP, 0.017 ms
// at 989 TFLOP/s; and its 134 M exponentials take 0.036 ms on the special
// function units (16 a clock an SM at 1.755 GHz): two floors of about the
// same height, so the loads, the products and the softmax have to run side
// by side. The design (details above flash_fwd_kernel): persistent blocks of
// two warpgroups, two blocks an SM, each walking (row, head) items; each
// item's q, k and v are loaded once, by TMA into a two-stage ring in the
// 64-byte swizzle of wgmma's operands, the next item's loads in flight while
// the current one computes; S = Q K^T and O = P V are wgmma (the second with
// p from registers), an online softmax over 64-key chunks, the row sums on
// the tensor cores too; o leaves by TMA store. The time left goes mostly
// to the softmax's FP32 work and to issuing the wgmma groups (a
// warpgroup's four warps wait for each other there), little to the
// exponentials or to waiting for loads: hence the loads and the store on
// TMA, the row sums on the tensor cores and the scale folded into the
// FFMA, each of which takes work off the issuing threads (PERF.md).
// ptxas (sm_90a): the forward 117 registers a thread under the causal mask,
// 94 without (either sign of the scale), no spills (an 8-byte stack frame),
// 100368 bytes of dynamic shared memory a block (two 48 KB stages, the
// ones tile, two mbarriers, 1 KB for alignment): two blocks an SM. The
// backward 194 / 191 registers, no spills.
//
// Backward: one block per (row, head) with q, k, v and d_o (4 x 256 x 32
// bf16) in shared memory, the two-phase design of the spatial train block's
// attention backward: phase A walks query rows (softmax, o, delta = sum d_o
// o, dq), phase B walks key rows and recomputes p^T and ds^T from the row
// statistics that phase A left in shared memory (dk, dv), so that ds is
// never transposed and nothing N x N reaches device memory. q k^T is exact
// (bf16 operands, fp32 accumulation); p and ds are rounded to bf16 for
// their products, where the TPU kernel keeps all of the backward in fp32.
// Bound on the H100, by the roofline: device memory (7 tensors of R N H D
// bf16 values); its time goes to the mma.sync products, the recomputation
// (16 N N D FLOP) and the softmax arithmetic.
//
// N <= 256, N % 64 == 0, head_dim 32, strides multiples of 8.

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

using namespace tpu1x;

namespace {

constexpr int FA_N = 256;   // most keys of a head held in shared memory
constexpr int FA_D = 32;    // head_dim
constexpr int FA_QT = 64;   // queries per forward tile: 4 warps x 16 rows
constexpr int FA_LD = FA_D + 8;

// The backward's operands (the forward reads and writes through tensor maps).
struct FlashArgs {
  // element (r, n, h, d) of q at r * rs[0] + n * ts[0] + h * 32 + d; index 1
  // is k, 2 is v, 3 is d_o
  const bf16* in[4];
  long rs[4], ts[4];
  // outputs, contiguous (R, N, H, 32): dq, dk, dv
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

// ---- forward (K9) ----
//
// A persistent block is two warpgroups (256 threads), two blocks an SM, and
// walks the (row, head) items blockIdx.x, blockIdx.x + gridDim.x, ... .
// Its dynamic shared memory holds a ring of two stages, each the q, k and v
// of one item (3 x N rows of 64 bytes). Thread 0 loads an item with three
// TMA copies, one a tensor map (a 4-D view (d, h, n, row) of q, k or v with
// the operand's own head, token and row strides), completing on the stage's
// mbarrier; the loads of item i + gridDim.x are in flight while the block
// computes item i, so each item's q, k and v come from device memory once
// and overlap the compute. TMA writes the 64-byte swizzle (the 16-byte
// chunks of row n permuted by XOR with bits 1-2 of n) that wgmma's
// shared-memory descriptors name, so the tensor cores read the tiles in
// place.
//
// Each warpgroup takes two of the item's 64-query tiles (0 and 3, or 1 and
// 2: under the causal mask both multiply 5 chunks of 64 keys), and for each
// walks the 64-key chunks it can see (all, or c <= qt), an online softmax:
//   S = Q K^T   wgmma m64n64k16, A = the Q tile and B = the chunk's keys,
//               both K-major (d contiguous), two k16 steps;
//   softmax     fp32 in the accumulator registers, 32 a thread: the row max
//               of the raw logits (the min when scale < 0), then
//               p = ex2(s * scale log2(e) - max), one FFMA and ex2.approx a
//               logit; the running max rescales what o and l hold so far;
//               p is rounded to bf16 straight into wgmma's register-A
//               fragment, whose layout is the accumulator's;
//   O += P V    wgmma m64n32k16, A = p from registers, B = 16 keys of V,
//               MN-major (the transposed flag), and beside it l += P 1, the
//               row sums of the rounded p as wgmma m64n8k16 against a tile
//               of ones (the tensor cores take the sums off the FP32 pipe);
//               the logits of the next chunk are issued in the same group;
//   store       o / l into the tile's own Q rows (read for the last time
//               by its last logit product) in the same swizzle, and out by
//               one TMA store a tile (a fourth tensor map, over the
//               contiguous output), which the warpgroup's first thread
//               issues and waits for, before the stage is refilled, only
//               for its reads of shared memory.
constexpr int FF_THREADS = 256;         // two warpgroups
constexpr int FF_OP = FA_N * FA_D * 2;  // bytes of one operand of an item
constexpr int FF_STAGE = 3 * FF_OP;     // q, k, v
constexpr int FF_ONES = 1024;           // the ones tile (512 bytes used)
// the ring starts on a 1024-byte boundary: the swizzle repeats every 512
// bytes, and the descriptors take every tile to start on a repeat; then
// the ones tile and the two stages' mbarriers
constexpr int FF_SMEM = 1024 + 2 * FF_STAGE + FF_ONES + 16;

// Byte offset of 16-byte chunk c (0..3) of row n in a swizzled operand.
__device__ __forceinline__ uint32_t swz64(int n, int c) {
  return n * 64 + ((c ^ ((n >> 1) & 3)) << 4);
}

// wgmma shared-memory matrix descriptor, 64-byte swizzle (layout type 2).
// sbo: bytes between groups of 8 rows (of K-major A and B; of 8 keys of the
// MN-major V); lbo: unused for these shapes, where one swizzle atom spans
// the operand's extent along it.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t sbo,
                                              uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)2 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of the registers across
// the wgmma fence and wait around them.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// The tiles of an item that warpgroup wg computes: wg 0 takes tile 0 and,
// from three tiles on, the last; wg 1 the others. Under the causal mask a
// tile sees qt + 1 chunks, so at N = 256 each warpgroup multiplies 5.
__device__ __forceinline__ int fwd_tiles(int wg, int tiles, int* qt) {
  if (wg == 0) {
    qt[0] = 0, qt[1] = tiles - 1;
    return tiles >= 3 ? 2 : 1;
  }
  qt[0] = 1, qt[1] = 2;
  return tiles == 4 ? 2 : tiles >= 2 ? 1 : 0;
}

// grid: the items (R H) or the blocks the card keeps resident (two an SM),
// whichever is fewer; FF_THREADS threads, dynamic shared memory FF_SMEM.
// POS: scale > 0, and the row max of the raw logits is the max of the
// scaled ones (otherwise their min is).
template <bool CAUSAL, bool POS>
__global__ void __launch_bounds__(FF_THREADS, 2)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to, int N, int H,
                     float scale, int items) {
  extern __shared__ unsigned char ff_raw[];
  const uint32_t raw = smem_u32(ff_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* ring_p = ff_raw + (ring - raw);
  const uint32_t ones = ring + 2 * FF_STAGE;
  const uint32_t bars = ones + FF_ONES;  // two 8-byte mbarriers
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  const int tiles = N / FA_QT;
  const float sl2 = scale * 1.4426950408889634f;  // scale log2(e)
  const float masked = POS ? -INFINITY : INFINITY;  // ex2 of it is 0
  int my_qt[2];
  const int my_tiles = fwd_tiles(wg, tiles, my_qt);

  reinterpret_cast<uint32_t*>(ring_p + 2 * FF_STAGE)[tid] = 0x3f803f80u;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the ones tile is written through the generic proxy, read by wgmma
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // thread 0: the item's q, k and v into stage st, completing on its
  // mbarrier
  auto load_item = [&](int item, int st) {
    const int r = item / H, h = item % H;
    const uint32_t dst = ring + st * FF_STAGE, bar = bars + 8 * st;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(3 * N * 64)
        : "memory");
    const CUtensorMap* maps[3] = {&tq, &tk, &tv};
#pragma unroll
    for (int op = 0; op < 3; ++op)
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
              dst + op * FF_OP),
          "l"(reinterpret_cast<uint64_t>(maps[op])), "r"(0), "r"(h), "r"(0),
          "r"(r), "r"(bar)
          : "memory");
  };

  const int first = blockIdx.x, stride = gridDim.x;
  uint32_t phase = 0;  // bit st: the parity of stage st's next completion
  if (tid == 0 && first < items) load_item(first, 0);
  int st = 0;
  for (int item = first; item < items; item += stride, st ^= 1) {
    // stage st ^ 1 was released by the barrier that ended the last item
    if (tid == 0 && item + stride < items) load_item(item + stride, st ^ 1);
    mbar_wait(bars + 8 * st, (phase >> st) & 1);
    phase ^= 1u << st;
    const uint32_t qs = ring + st * FF_STAGE, ks = qs + FF_OP,
                   vs = ks + FF_OP;
    const int r = item / H, h = item % H;
    for (int i = 0; i < my_tiles; ++i) {
      const int qt = my_qt[i];
      const int nc = CAUSAL ? qt + 1 : tiles;  // 64-key chunks in view
      const uint32_t qtile = qs + qt * 4096;
      // s[4 j + e]: row warp 16 + g + 8 (e >> 1) of the tile, key
      // 64 c + 8 j + 2 t4 + (e & 1) of chunk c; m: running max of the
      // scaled logits (times log2(e)) of rows g and g + 8; l: their sums
      float s[32], o[16], l[4] = {0.f, 0.f, 0.f, 0.f};
      uint32_t pa[16];
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] = 0.f;
      wgmma_fence();
      wgmma_qk(s, gmma_desc(qtile, 512, 16), gmma_desc(ks, 512, 16), 0);
      wgmma_qk(s, gmma_desc(qtile + 32, 512, 16), gmma_desc(ks + 32, 512, 16),
               1);
      wgmma_commit();
      wgmma_wait_all();
      hold(s);
      for (int c = 0;; ++c) {
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
        for (int j = 0; j < 4; ++j) {
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
        const bool more = c + 1 < nc;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_pv(o, &pa[4 * k],
                   gmma_desc(vs + (c * 64 + k * 16) * 64, 512, 512));
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_rowsum(l, &pa[4 * k], gmma_desc(ones, 512, 16));
        if (more) {
          const uint32_t kc = ks + (c + 1) * 4096;
          wgmma_qk(s, gmma_desc(qtile, 512, 16), gmma_desc(kc, 512, 16), 0);
          wgmma_qk(s, gmma_desc(qtile + 32, 512, 16),
                   gmma_desc(kc + 32, 512, 16), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        hold(o);
        hold(l);
        hold(s);
        if (!more) break;
      }

      // o / l into the tile's own Q rows: 64-byte rows in the swizzle that
      // the TMA store reads, which also spreads the eight rows of a store
      // over the banks
      const float i0 = 1.f / l[0], i1 = 1.f / l[2];
      const int r0 = warp * 16 + g;
      unsigned char* ot = ring_p + (qtile - ring);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<uint32_t*>(ot + swz64(r0, j) + t4 * 4) =
            pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
        *reinterpret_cast<uint32_t*>(ot + swz64(r0 + 8, j) + t4 * 4) =
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
    }
    // the stores have read the stage before the item after next refills it
    if ((tid & 127) == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    // the stage's generic reads and writes (the output tiles) are ordered
    // before the TMA writes of the item after next
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  if ((tid & 127) == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// cuTensorMapEncodeTiled from the driver, found at first use through the
// runtime, so that the library needs no link to libcuda.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The (d, h, n, row) view of a (R, N, H, 32) operand with row stride rs and
// token stride ts (elements) in the 64-byte swizzle; a box is `rows` tokens
// of one head of one row (0: all N, one item).
cudaError_t tensor_map(CUtensorMap* map, const void* base, long rs, long ts,
                       int R, int N, int H, int rows = 0) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {FA_D, (cuuint64_t)H, (cuuint64_t)N,
                              (cuuint64_t)R};
  const cuuint64_t strides[3] = {FA_D * 2, (cuuint64_t)ts * 2,
                                 (cuuint64_t)rs * 2};
  const cuuint32_t box[4] = {FA_D, 1, (cuuint32_t)(rows ? rows : N), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

typedef void (*FwdKernel)(CUtensorMap, CUtensorMap, CUtensorMap,
                          CUtensorMap, int, int, float, int);

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
  const int items = R * H;
  if (items == 0) return cudaSuccess;
  CUtensorMap maps[4];
  TPU1X_TRY(tensor_map(&maps[0], q, rsq, tsq, R, N, H));
  TPU1X_TRY(tensor_map(&maps[1], k, rsk, tsk, R, N, H));
  TPU1X_TRY(tensor_map(&maps[2], v, rsv, tsv, R, N, H));
  TPU1X_TRY(tensor_map(&maps[3], out, (long)N * H * FA_D, (long)H * FA_D, R,
                       N, H, FA_QT));
  // set once a process for each form: the shared memory limit and the
  // grid, every resident block of the card
  static const FwdKernel forms[4] = {
      flash_fwd_kernel<false, false>, flash_fwd_kernel<false, true>,
      flash_fwd_kernel<true, false>, flash_fwd_kernel<true, true>};
  static int resident[4] = {0, 0, 0, 0};
  const int form = (causal ? 2 : 0) + (scale > 0.f ? 1 : 0);
  const FwdKernel kernel = forms[form];
  if (resident[form] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    TPU1X_TRY(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FF_SMEM));
    TPU1X_TRY(cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared));
    TPU1X_TRY(cudaGetDevice(&dev));
    TPU1X_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    TPU1X_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, FF_THREADS, FF_SMEM));
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[form] = per_sm * sms;
  }
  const int grid = items < resident[form] ? items : resident[form];
  kernel<<<grid, FF_THREADS, FF_SMEM, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], N, H, scale, items);
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
