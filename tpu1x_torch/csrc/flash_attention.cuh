// The flash attention forward (K9), shared by csrc/flash_attention.cu,
// which binds it as `flash_mha`, and csrc/spatial_block.cu, whose pre-LN
// attention it is, so that both compile the same device code.
//
// softmax(q k^T scale [causal]) v over the N tokens of each (row, head), on
// q, k, v shaped (R, N, H, 32) and read in place through their strides
// (the thirds of a (rows, N, 3C) qkv product need no copy); o contiguous
// (R, N, H, 32); and the per-query log-sum-exp of the scaled logits that
// the backward (csrc/flash_attention.cu) starts from: lse (R, H, N) fp32,
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
// ptxas (sm_90a): 96 registers a thread under the causal mask, 100 without
// (either sign of the scale), no spills (an 8-byte stack frame), 100368
// bytes of dynamic shared memory a block (two 48 KB stages, the ones tile,
// two mbarriers, 1 KB for alignment): two blocks an SM.
//
// N <= 256, N % 64 == 0, head_dim 32, strides multiples of 8.

#pragma once

#include "sm90.cuh"

namespace tpu1x {

constexpr int FA_N = 256;   // most keys of a head held in shared memory
constexpr int FA_D = 32;    // head_dim
constexpr int FA_QT = 64;   // queries (or keys) a tile: 4 warps x 16 rows

// Byte offset of 16-byte chunk c (0..3) of row n in a swizzled operand.
__device__ __forceinline__ uint32_t swz64(int n, int c) {
  return n * 64 + ((c ^ ((n >> 1) & 3)) << 4);
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
// Its dynamic shared memory holds a ring of two stages, each the q, k and v
// of one item (3 x N rows of 64 bytes). Thread 0 loads an item with three
// TMA copies, one a tensor map (a 4-D view (d, h, n, row) of q, k or v with
// the operand's own head, token and row strides), completing on the stage's
// mbarrier; the loads of item i + gridDim.x are in flight while the block
// computes item i, so each item's q, k and v come from device memory once
// and overlap the compute.
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
//               for its reads of shared memory; lse = (max + log2 l) ln 2.
constexpr int FF_THREADS = 256;         // two warpgroups
constexpr int FF_OP = FA_N * FA_D * 2;  // bytes of one operand of an item
constexpr int FF_STAGE = 3 * FF_OP;     // q, k, v
constexpr int FF_ONES = 1024;           // the ones tile (512 bytes used)
// the ring starts on a 1024-byte boundary: the swizzle repeats every 512
// bytes, and the descriptors take every tile to start on a repeat; then
// the ones tile and the two stages' mbarriers
constexpr int FF_SMEM = 1024 + 2 * FF_STAGE + FF_ONES + 16;

// grid: the items (R H) or the blocks the card keeps resident (two an SM),
// whichever is fewer; FF_THREADS threads, dynamic shared memory FF_SMEM.
// POS: scale > 0, and the row max of the raw logits is the max of the
// scaled ones (otherwise their min is). lse: (R, H, N) fp32.
template <bool CAUSAL, bool POS>
__global__ void __launch_bounds__(FF_THREADS, 2)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to, float* lse,
                     int N, int H, float scale, int items) {
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
      // one key chunk; LAST: no chunk follows, whose logits to issue. The
      // two forms are separate code, so that no wgmma sits behind a branch
      // (ptxas serialises the wgmma of a kernel that has one)
      int c = 0;
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
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_pv(o, &pa[4 * k],
                   gmma_desc(vs + (c * 64 + k * 16) * 64, 512, 512));
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_rowsum(l, &pa[4 * k], gmma_desc(ones, 512, 16));
        if constexpr (!LAST) {
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
      };
      for (; c + 1 < nc; ++c) chunk(Flag<false>{});
      chunk(Flag<true>{});

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
      // lse of rows r0 and r0 + 8 from the lane that holds their first
      // column, by predicated stores: a branch on the lane between the
      // wgmma groups would serialise them
      float* lrow = lse + (long)item * N + qt * FA_QT + r0;
      st_if(t4 == 0, lrow, (m0 + __log2f(l[0])) * 0.6931471805599453f);
      st_if(t4 == 0, lrow + 8, (m1 + __log2f(l[2])) * 0.6931471805599453f);
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

// What the flash kernels require of the shapes and strides.
inline bool flash_ok(int N, int D, const long* strides, int count) {
  if (N < 64 || N > FA_N || N % 64 || D != FA_D) return false;
  for (int i = 0; i < count; ++i)
    if (strides[i] % 8) return false;
  return true;
}

// The (d, h, n, row) view of a (R, N, H, 32) operand with row stride rs and
// token stride ts (elements) in the 64-byte swizzle; a box is `rows` tokens
// of one head of one row (0: all N, one item).
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, long rs,
                              long ts, int R, int N, int H, int rows = 0) {
  const cuuint64_t dims[4] = {FA_D, (cuuint64_t)H, (cuuint64_t)N,
                              (cuuint64_t)R};
  const cuuint64_t strides[3] = {FA_D * 2, (cuuint64_t)ts * 2,
                                 (cuuint64_t)rs * 2};
  const cuuint32_t box[4] = {FA_D, 1, (cuuint32_t)(rows ? rows : N), 1};
  return encode_map(map, base, 4, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_64B);
}

typedef void (*FwdKernel)(CUtensorMap, CUtensorMap, CUtensorMap,
                          CUtensorMap, float*, int, int, float, int);

// q, k, v: bf16 (R, N, H, 32) views, element (r, n, h, d) at
// r * rs + n * ts + h * 32 + d with each tensor's own rs and ts (multiples
// of 8, 16-byte aligned base); out bf16 (R, N, H, 32) contiguous; lse fp32
// (R, H, N).
static inline cudaError_t launch_flash_fwd(const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    long rsq, long tsq, long rsk, long tsk,
                                    long rsv, long tsv, int R, int N, int H,
                                    int D, float scale, bool causal,
                                    cudaStream_t stream) {
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
  if (resident[form] == 0)
    TPU1X_TRY(resident_blocks(kernel, FF_THREADS, FF_SMEM, &resident[form]));
  const int grid = items < resident[form] ? items : resident[form];
  kernel<<<grid, FF_THREADS, FF_SMEM, stream>>>(maps[0], maps[1], maps[2],
                                                maps[3], lse, N, H, scale,
                                                items);
  return cudaGetLastError();
}

}  // namespace tpu1x
