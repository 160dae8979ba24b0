// Multi-head attention softmax(q k^T scale [causal]) v over the N tokens of
// each (row, head), forward and backward, on q, k, v shaped (R, N, H, 32)
// and read in place through their strides.
//
// Replaces the Pallas kernels tpu1x/ops/pallas_attention.py: _flash_mha_bhnd
// (_attn_kernel) and _flash_mha_bwd_bhnd (_attn_bwd_kernel). The TPU wrapper
// transposes to (B, H, N, D) because Mosaic wants the head axis leading; here
// the kernels take the (rows, N, H, D) tensors as they lie, each with its own
// row and token strides, so that the v third of a (rows, N, 3, H, D) qkv
// product and the freshly normalised q and k feed them without a copy. The
// backward writes dq, dk and dv through strides of their own too, so that
// the spatial train block gets them as the thirds of one (rows, N, 3C) dqkv.
//
// The forward (K9) is csrc/flash_attention.cuh, which the spatial block
// shares; here it also writes the per-query log-sum-exp that the backward
// starts from.
//
// Backward (K10): the standard flash-attention backward from the residuals
// o and lse (R, H, N), what the TPU kernel computes (_attn_bwd_kernel) with
// 5 products a (row, head) and one exponential a logit:
//   delta_q  = sum_d d_o o                        (prologue, fp32)
//   P^T      = exp2(K Q^T scale log2 e - lse log2 e)
//   dP^T     = V d_o^T
//   dS^T     = P^T (dP^T - delta)                 (fp32 registers)
//   dV      += P^T d_o,  dK += dS^T Q,  dQ += dS K,  dk, dq times scale.
// It is key-major: each warpgroup owns 64-key tiles and walks the 64-query
// chunks that see them, keeping dK and dV in registers; dQ sums over the
// key tiles in an fp32 tile in shared memory, one a warpgroup.
//
// Bounds at the qk_norm train step's (R, N, H, D) = (128, 256, 16, 32): the
// bytes, q, k, v, o, d_o read and dq, dk, dv written once (8 x 33.5 MB) and
// lse (2 MB), 0.081 ms at 3.35 TB/s; the 5 products, 8.6 GFLOP each, 0.043
// ms at 989 TFLOP/s; the 134 M exponentials, 0.036 ms on the special
// function units. The TPU kernel's work (7 tensors, no lse or o) is 0.070
// ms of bytes. The design: persistent blocks of two warpgroups, one block an
// SM, walking (row, head) items; thread 0 loads an item's q, k, v, d_o by
// TMA (the 4-D maps of the forward, 64-byte swizzle) and its lse by a bulk
// copy into a two-stage ring, and thread n < N loads row n of its o into
// registers, both one item ahead, so the loads run while the item before
// computes. A warpgroup takes key tiles 0 and 3, or 1 and 2 (under the
// causal mask both walk 5 query chunks), and for each chunk:
//   S^T, dP^T   wgmma m64n64k16, A = the K (V) tile, B = the chunk's Q
//               (d_o) rows, both K-major, two k16 steps each;
//   P^T, dS^T   one FFMA and one ex2 a logit, lse and delta read from
//               shared memory by query; rounded to bf16 straight into
//               wgmma's register-A fragments (the accumulator's layout);
//   dV, dK      wgmma m64n32k16, A from registers, B = the chunk's d_o (Q)
//               rows, MN-major (the transposed flag);
//   dQ          dS^T to the warpgroup's tile in shared memory in bf16,
//               128-byte swizzle, and wgmma m64n32k16 with A = dS
//               (MN-major, transposed) and B = the K tile (MN-major); the
//               partial sums are added (load, add, store: no other thread
//               writes those words) into the warpgroup's own fp32 dQ tile,
//               its columns permuted by row so that a warp's adds hit 32
//               banks; the two tiles are summed at the end of the item;
//   the next chunk's S^T and dP^T are issued behind these, in a group of
//   their own that runs while the dQ sums go into shared memory.
// dk and dv go into the tile's own K and V rows, dq (after a block barrier)
// into the Q rows, and out by TMA store. p and ds are rounded to bf16 for
// their products, where the TPU kernel keeps the whole backward in fp32;
// delta comes from the bf16 o, where the TPU kernel takes rowsum(p dp).
// One dQ tile for both warpgroups would need atomics, and the card has
// fp32 adds to shared memory only as a compare-and-swap loop
// (ATOMS.CAST.SPIN): measured at 40% of the kernel's time (PERF.md).
// Each chunk loop's last iteration is code of its own, so that no wgmma
// sits behind a branch (ptxas would serialise them all: 0.30 against 0.25
// ms). ptxas (sm_90a): 235 registers a thread under the causal mask, 230
// without, no spills.
// Shared memory a block: 1024 (alignment) + 2 stages x 66560 (4 operands
// of 16 KB, lse 1 KB) + 2 x 8192 (dS^T) + 2 x 32768 (dQ) + 1024 (delta) +
// 16 (mbarriers) = 217104 bytes, one block an SM.
//
// N <= 256, N % 64 == 0, head_dim 32, strides multiples of 8.

#include "flash_attention.cuh"

using namespace tpu1x;

namespace {

// d (64 x 32, fp32) {=, +=} A (64 x 16) B (16 x 32), A and B from shared
// memory, both MN-major (the transposed flags); acc 0 overwrites d.
__device__ __forceinline__ void wgmma_tt(float* d, uint64_t da, uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// Word of an fp32 dQ tile that holds (query n, channel d): row n, its 32
// columns permuted by XOR with bits of n so that the adds of one
// accumulator register (rows g, channels 8 j + 2 t4 + e) fall in 32 banks.
__device__ __forceinline__ int dq_word(int n, int d) {
  return n * FA_D + (d ^ ((n & 1) | ((n & 6) << 2)));
}

// o's row of 32 channels, 16 bytes at a time, past the compiler's
// scheduling (the loads of the next item stay where they are issued).
__device__ __forceinline__ uint4 ldg_nc(const bf16* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

constexpr int FB_THREADS = 256;                 // two warpgroups
constexpr int FB_OP = FA_N * FA_D * 2;          // bytes of one operand
constexpr int FB_STAGE = 4 * FB_OP + FA_N * 4;  // q, k, v, d_o, lse
constexpr int FB_STG = 64 * 128;                // a warpgroup's dS^T tile
constexpr int FB_DQ = FA_N * FA_D * 4;          // a warpgroup's fp32 dQ
constexpr int FB_SMEM =
    1024 + 2 * FB_STAGE + 2 * FB_STG + 2 * FB_DQ + FA_N * 4 + 16;
static_assert(FB_STAGE % 1024 == 0, "stages start on a 1024-byte boundary");

struct BwdMaps {
  CUtensorMap in[4];   // q, k, v, d_o: one item a box
  CUtensorMap out[3];  // dq, dk, dv: 64 rows a box
};

// grid: the items (R H) or the SMs, whichever is fewer; FB_THREADS threads,
// dynamic shared memory FB_SMEM. o: element (r, n, h, d) at
// r rso + n tso + h 32 + d.
template <bool CAUSAL>
__global__ void __launch_bounds__(FB_THREADS, 1)
    flash_bwd_kernel(const __grid_constant__ BwdMaps maps,
                     const float* __restrict__ lse, const bf16* __restrict__ o,
                     long rso, long tso, int N, int H, float scale,
                     int items) {
  extern __shared__ unsigned char fb_raw[];
  const uint32_t raw = smem_u32(fb_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* ring_p = fb_raw + (ring - raw);
  // after the ring: the two warpgroups' dS^T tiles, their fp32 dQ tiles,
  // delta and the mbarriers
  const uint32_t stg_s = ring + 2 * FB_STAGE;
  float* dq_p = reinterpret_cast<float*>(ring_p + 2 * FB_STAGE + 2 * FB_STG);
  float* delta = dq_p + 2 * FA_N * FA_D;
  const uint32_t bars = smem_u32(delta + FA_N);  // two 8-byte mbarriers
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  const int tiles = N / FA_QT;
  const float sl2 = scale * 1.4426950408889634f;  // scale log2(e)
  int my_kt[2];
  const int my_tiles = fwd_tiles(wg, tiles, my_kt);

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_item = [&](int item, int st) {
    const int r = item / H, h = item % H;
    const uint32_t dst = ring + st * FB_STAGE, bar = bars + 8 * st;
    mbar_expect_tx(bar, 4 * N * 64 + N * 4);
#pragma unroll
    for (int op = 0; op < 4; ++op)
      tma_load_4d(dst + op * FB_OP, &maps.in[op], 0, h, 0, r, bar);
    bulk_load(dst + 4 * FB_OP, lse + (long)item * N, N * 4, bar);
  };
  // thread n < N: row n of o of an item, into registers, one item ahead
  auto load_o = [&](int item, uint4 (&dst)[4]) {
    const bf16* row = o + (item / H) * rso + (long)tid * tso + item % H * FA_D;
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[c] = ldg_nc(row + 8 * c);
  };

  const int first = blockIdx.x, stride = gridDim.x;
  uint32_t phase = 0;  // bit st: the parity of stage st's next completion
  if (tid == 0 && first < items) load_item(first, 0);
  uint4 o_cur[4], o_next[4];
  if (tid < N && first < items) load_o(first, o_cur);
  int st = 0;
  for (int item = first; item < items; item += stride, st ^= 1) {
    if (tid == 0 && item + stride < items) load_item(item + stride, st ^ 1);
    if (tid < N && item + stride < items) load_o(item + stride, o_next);
    mbar_wait(bars + 8 * st, (phase >> st) & 1);
    phase ^= 1u << st;
    const uint32_t qs = ring + st * FB_STAGE, ks = qs + FB_OP,
                   vs = ks + FB_OP, gs = vs + FB_OP;
    unsigned char* stage_p = ring_p + (qs - ring);
    float* lse2 = reinterpret_cast<float*>(stage_p + 4 * FB_OP);
    const int r = item / H, h = item % H;

    // prologue, a query row a thread: delta = sum_d d_o o, lse in log2
    // units, the row of both dQ tiles zeroed
    if (tid < N) {
      const unsigned char* grow = stage_p + 3 * FB_OP;
      float dl = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float fg[8];
        load8(reinterpret_cast<const bf16*>(grow + swz64(tid, c)), fg);
        const __nv_bfloat162* oc =
            reinterpret_cast<const __nv_bfloat162*>(&o_cur[c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(oc[i]);
          dl += f.x * fg[2 * i] + f.y * fg[2 * i + 1];
        }
      }
      delta[tid] = dl;
      lse2[tid] *= 1.4426950408889634f;
    }
    // both dQ tiles zeroed, consecutive threads on consecutive 16 bytes
#pragma unroll
    for (int i = 0; i < 2 * FA_N * FA_D / 4 / FB_THREADS; ++i)
      reinterpret_cast<float4*>(dq_p)[tid + i * FB_THREADS] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();

    // this warpgroup's dS^T tile (64 keys x 64 queries bf16) and dQ tile
    const uint32_t stg = stg_s + wg * FB_STG;
    unsigned char* stg_p = ring_p + (stg - ring);
    float* dqw = dq_p + wg * FA_N * FA_D;
    for (int i = 0; i < my_tiles; ++i) {
      const int kt = my_kt[i];
      const uint32_t ktile = ks + kt * 4096, vtile = vs + kt * 4096;
      // dk[4 n + e], dv[4 n + e]: key kt 64 + warp 16 + g + 8 (e >> 1),
      // channel 8 n + 2 t4 + (e & 1)
      float s[32], dp[32], dk[16], dv[16], dq[16];
      uint32_t pa[16], da[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) dk[e] = dv[e] = dq[e] = 0.f;
      int c = CAUSAL ? kt : 0;  // the first query chunk that sees the keys
      auto issue_logits = [&](int chunk) {
        const uint32_t qc = qs + chunk * 4096, gc = gs + chunk * 4096;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          wgmma_qk(s, gmma_desc(ktile + 32 * k, 512, 16),
                   gmma_desc(qc + 32 * k, 512, 16), k);
          wgmma_qk(dp, gmma_desc(vtile + 32 * k, 512, 16),
                   gmma_desc(gc + 32 * k, 512, 16), k);
        }
      };
      wgmma_fence();
      issue_logits(c);
      wgmma_commit();
      wgmma_wait_all();
      hold(s);
      hold(dp);
      // one query chunk; LAST: no chunk follows, whose logits to issue. The
      // two forms are separate code, so that no wgmma sits behind a branch
      // (ptxas serialises the wgmma of a kernel that has one)
      auto step = [&](auto last) {
        constexpr bool LAST = decltype(last)::value;
        // s[4 j + e], dp[4 j + e]: key warp 16 + g + 8 (e >> 1) of the
        // tile, query 64 c + 8 j + 2 t4 + (e & 1)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int q = c * FA_QT + 8 * j + 2 * t4;
          const float2 l2 = *reinterpret_cast<const float2*>(lse2 + q);
          const float2 dl = *reinterpret_cast<const float2*>(delta + q);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(s[4 * j + e], sl2, (e & 1) ? -l2.y : -l2.x));
            if (CAUSAL && c == kt &&
                8 * j + 2 * t4 + (e & 1) < warp * 16 + g + 8 * (e >> 1))
              p = 0.f;
            s[4 * j + e] = p;
            dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
          }
        }
        // P^T and dS^T of 16 queries (step k) as register-A fragments:
        // keys g | g + 8, queries 2 t4.. | 8 + 2 t4..; dS^T also to the
        // staging tile, row = key, 16-byte chunk j ^ (key & 7)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          pa[4 * k] = pack_bf16(s[8 * k], s[8 * k + 1]);
          pa[4 * k + 1] = pack_bf16(s[8 * k + 2], s[8 * k + 3]);
          pa[4 * k + 2] = pack_bf16(s[8 * k + 4], s[8 * k + 5]);
          pa[4 * k + 3] = pack_bf16(s[8 * k + 6], s[8 * k + 7]);
          da[4 * k] = pack_bf16(dp[8 * k], dp[8 * k + 1]);
          da[4 * k + 1] = pack_bf16(dp[8 * k + 2], dp[8 * k + 3]);
          da[4 * k + 2] = pack_bf16(dp[8 * k + 4], dp[8 * k + 5]);
          da[4 * k + 3] = pack_bf16(dp[8 * k + 6], dp[8 * k + 7]);
        }
        const int r0 = warp * 16 + g;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t lo = da[4 * (j >> 1) + 2 * (j & 1)];
          const uint32_t hi = da[4 * (j >> 1) + 2 * (j & 1) + 1];
          *reinterpret_cast<uint32_t*>(stg_p + r0 * 128 +
                                       ((j ^ (r0 & 7)) << 4) + 4 * t4) = lo;
          *reinterpret_cast<uint32_t*>(stg_p + (r0 + 8) * 128 +
                                       ((j ^ ((r0 + 8) & 7)) << 4) + 4 * t4) =
              hi;
        }
        hold(pa);
        hold(da);
        hold(dk);
        hold(dv);
        // the staging tile's generic writes, before this warpgroup's wgmma
        // reads them
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        const uint32_t qc = qs + c * 4096, gc = gs + c * 4096;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wgmma_pv(dv, &pa[4 * k], gmma_desc(gc + k * 16 * 64, 512, 512));
          wgmma_pv(dk, &da[4 * k], gmma_desc(qc + k * 16 * 64, 512, 512));
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_tt(dq,
                   gmma_desc(stg + k * 2048, 1024, 1024, GMMA_SWIZZLE_128B),
                   gmma_desc(ktile + k * 16 * 64, 512, 512), k);
        wgmma_commit();
        // the next chunk's logits in a group of their own, which runs
        // while this chunk's dq goes into shared memory
        if constexpr (!LAST) {
          issue_logits(c + 1);
          wgmma_commit();
          wgmma_wait<1>();
        } else {
          wgmma_wait_all();
        }
        hold(dk);
        hold(dv);
        hold(dq);
        // dq[4 n + e]: query 64 c + warp 16 + g + 8 (e >> 1), channel
        // 8 n + 2 t4 + (e & 1)
        // all 16 loads ahead of the stores, so that they overlap
        auto word = [&](int i) {
          return dq_word(c * FA_QT + r0 + 8 * ((i & 3) >> 1),
                         8 * (i >> 2) + 2 * t4 + (i & 1));
        };
        float sum[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) sum[i] = dqw[word(i)];
#pragma unroll
        for (int i = 0; i < 16; ++i) dqw[word(i)] = sum[i] + dq[i];
        // the staging tile is rewritten for the next chunk only after
        // every warp of the group has passed its wgmma wait
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        if constexpr (!LAST) {
          wgmma_wait_all();
          hold(s);
          hold(dp);
        }
      };
      for (; c + 1 < tiles; ++c) step(Flag<false>{});
      step(Flag<true>{});
      // dk (times scale) and dv into the tile's own K and V rows, in the
      // swizzle the TMA store reads, and out
      unsigned char* kp = stage_p + FB_OP + kt * 4096;
      unsigned char* vp = stage_p + 2 * FB_OP + kt * 4096;
      const int r0 = warp * 16 + g;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<uint32_t*>(kp + swz64(r0, n) + t4 * 4) =
            pack_bf16(dk[4 * n] * scale, dk[4 * n + 1] * scale);
        *reinterpret_cast<uint32_t*>(kp + swz64(r0 + 8, n) + t4 * 4) =
            pack_bf16(dk[4 * n + 2] * scale, dk[4 * n + 3] * scale);
        *reinterpret_cast<uint32_t*>(vp + swz64(r0, n) + t4 * 4) =
            pack_bf16(dv[4 * n], dv[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(vp + swz64(r0 + 8, n) + t4 * 4) =
            pack_bf16(dv[4 * n + 2], dv[4 * n + 3]);
      }
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if ((tid & 127) == 0) {
        tma_store_4d(&maps.out[1], ktile, 0, h, kt * FA_QT, r);
        tma_store_4d(&maps.out[2], vtile, 0, h, kt * FA_QT, r);
        bulk_commit();
      }
    }
    // every partial sum of dQ is in, and Q is read for the last time: dq
    // (the two warpgroups' sums, times scale) into the Q rows, a warpgroup
    // a query chunk, read in the accumulator's layout as the adds were
    __syncthreads();
    for (int cc = wg; cc < tiles; cc += 2) {
      const int r0 = warp * 16 + g;
      unsigned char* qtile = stage_p + cc * 4096;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int qq = cc * FA_QT + r0 + 8 * hh;
          const int w0 = dq_word(qq, 8 * n + 2 * t4);
          const int w1 = dq_word(qq, 8 * n + 2 * t4 + 1);
          *reinterpret_cast<uint32_t*>(qtile + swz64(r0 + 8 * hh, n) +
                                       4 * t4) =
              pack_bf16((dq_p[w0] + dq_p[FA_N * FA_D + w0]) * scale,
                        (dq_p[w1] + dq_p[FA_N * FA_D + w1]) * scale);
        }
    }
    if (tid < N) {
#pragma unroll
      for (int c = 0; c < 4; ++c) o_cur[c] = o_next[c];
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      for (int t = 0; t < tiles; ++t)
        tma_store_4d(&maps.out[0], qs + t * 4096, 0, h, t * FA_QT, r);
      bulk_commit();
    }
    // the stores have read the stage before the item after next refills
    // it, and the generic accesses of the stage and of dQ are ordered
    // before the next item's
    if ((tid & 127) == 0) bulk_wait_read();
    fence_proxy_async();
    __syncthreads();
  }
  if ((tid & 127) == 0) bulk_wait();
}

typedef void (*BwdKernel)(BwdMaps, const float*, const bf16*, long, long, int,
                          int, float, int);

}  // namespace

// q, k, v: bf16 (R, N, H, 32) views, element (r, n, h, d) at
// r * rs + n * ts + h * 32 + d with each tensor's own rs and ts (multiples
// of 8, 16-byte aligned base); out bf16 (R, N, H, 32) contiguous; lse fp32
// (R, H, N), the log-sum-exp of each query's scaled logits.
extern "C" int tpu1x_flash_mha(const void* q, const void* k, const void* v,
                               void* out, void* lse, long rsq, long tsq,
                               long rsk, long tsk, long rsv, long tsv, int R,
                               int N, int H, int D, float scale, int causal,
                               void* stream) {
  return launch_flash_fwd(q, k, v, out, static_cast<float*>(lse), rsq, tsq,
                          rsk, tsk, rsv, tsv, R, N, H, D, scale, causal != 0,
                          static_cast<cudaStream_t>(stream));
}

// q, k, v, o, d_o: bf16 (R, N, H, 32) views as above (o with strides
// (rso, tso), d_o with (rsg, tsg)); lse fp32 (R, H, N) from the forward;
// dq, dk, dv bf16 (R, N, H, 32) views with strides (rsdq, tsdq), (rsdk,
// tsdk), (rsdv, tsdv) (multiples of 8, 16-byte aligned bases): contiguous
// tensors, or the three thirds of one (R, N, 3C) tensor, written by TMA
// stores 64 tokens of one head at a time.
extern "C" int tpu1x_flash_mha_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* d_o,
                                   const void* lse, void* dq, void* dk,
                                   void* dv, long rsq, long tsq, long rsk,
                                   long tsk, long rsv, long tsv, long rso,
                                   long tso, long rsg, long tsg, long rsdq,
                                   long tsdq, long rsdk, long tsdk, long rsdv,
                                   long tsdv, int R, int N, int H, int D,
                                   float scale, int causal, void* stream) {
  const long strides[16] = {rsq,  tsq,  rsk,  tsk,  rsv,  tsv,  rso,  tso,
                            rsg,  tsg,  rsdq, tsdq, rsdk, tsdk, rsdv, tsdv};
  if (!flash_ok(N, D, strides, 16)) return cudaErrorInvalidValue;
  const int items = R * H;
  if (items == 0) return cudaSuccess;
  BwdMaps maps;
  const void* in[4] = {q, k, v, d_o};
  const long rs[4] = {rsq, rsk, rsv, rsg}, ts[4] = {tsq, tsk, tsv, tsg};
  for (int i = 0; i < 4; ++i)
    TPU1X_TRY(tensor_map(&maps.in[i], in[i], rs[i], ts[i], R, N, H));
  void* out[3] = {dq, dk, dv};
  const long ors[3] = {rsdq, rsdk, rsdv}, ots[3] = {tsdq, tsdk, tsdv};
  for (int i = 0; i < 3; ++i)
    TPU1X_TRY(tensor_map(&maps.out[i], out[i], ors[i], ots[i], R, N, H,
                         FA_QT));
  static const BwdKernel forms[2] = {flash_bwd_kernel<false>,
                                     flash_bwd_kernel<true>};
  static int resident[2] = {0, 0};
  const int form = causal ? 1 : 0;
  if (resident[form] == 0)
    TPU1X_TRY(resident_blocks(forms[form], FB_THREADS, FB_SMEM,
                              &resident[form]));
  const int grid = items < resident[form] ? items : resident[form];
  forms[form]<<<grid, FB_THREADS, FB_SMEM, static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<const float*>(lse), static_cast<const bf16*>(o), rso,
      tso, N, H, scale, items);
  return cudaGetLastError();
}
