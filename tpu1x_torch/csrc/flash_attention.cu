// Multi-head attention softmax(q k^T scale [causal]) v over the N tokens of
// each (row, head), forward and backward, on q, k, v shaped (R, N, H, D),
// head_dim D = 32, 64, 72 or 128, and read in place through their strides.
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
// o and lse (R, H, N), what the TPU kernel computes (_attn_bwd_kernel), one
// exponential a logit:
//   delta_q  = sum_d d_o o
//   P        = exp2(Q K^T scale log2 e - lse log2 e)
//   dP       = dO V^T
//   dS       = P (dP - delta)                    (fp32 registers)
//   dV      += P^T dO,  dK += dS^T Q,  dQ += dS K,  dk, dq times scale.
// It splits by what each output sums over, two launches, each (row, head,
// 64-row tile) unit one warpgroup that keeps its tile and streams the other
// operands in 64-row chunks through a ring of FB_STAGES stages (TMA, the
// operands' swizzle), at every N and both head widths:
//   dq pass   (row, head, query tile) units; k and v of a key chunk a
//             stage; S = Q K^T and dP = dO V^T (wgmma m64n64k16), P and dS
//             in registers, dQ += dS K (dS from registers); delta of the
//             tile's rows from o (device memory) and the tile's d_o,
//             written to `delta` (R, H, N) fp32 for the second pass;
//   dkv pass  (row, head, key tile) units; q, d_o, and lse and delta of
//             the query chunk a stage (lse and delta by bulk copies into a
//             ring of their own); S^T = K Q^T and dP^T = V dO^T, dV += P^T
//             dO and dK += dS^T Q, the accumulators in registers.
// Every sum stays in one warpgroup's registers and is written once: no
// shared fp32 tile, no atomics, the same result from run to run. The price
// is the logits and their exponentials twice: seven products a (row, head)
// where the TPU kernel makes five. Each unit is its own consumer, so a
// stage is free once the wgmma group that last read it has completed (in
// the dkv pass also once the warpgroup's generic reads of its lse and
// delta are done: a named barrier); its first thread then loads chunk c +
// FB_STAGES into it by predicate, four chunks in flight. The next chunk's
// logits are issued in the wgmma group of the current chunk's products;
// the last chunk is code of its own (a wgmma behind a branch would make
// ptxas serialise them all). Units of one item are neighbours in the grid,
// so the second and later reads of a chunk mostly come from L2. Numbers: p
// and ds are rounded to bf16 for their products, where the TPU kernel
// keeps the whole backward in fp32; delta comes from the bf16 o, where the
// TPU kernel takes rowsum(p dp).
// Head_dim 32 took a fused kernel up to N = 256 before (key tiles
// outermost, dQ summed in a shared fp32 tile), head_dim 64 two passes that
// held whole operands; these streamed passes were 2-25% faster than the
// former and 25-41% faster than the latter at every N <= 256 timed
// (PERF.md, `chip_variants.py flash`), so they replaced both.
// Bounds at the qk_norm train step's (R, N, H, D) = (128, 256, 16, 32): q,
// k, v, o, d_o read and dq, dk, dv written once (8 x 33.5 MB), lse and
// delta (2 MB each), 0.082 ms at 3.35 TB/s; the TPU kernel's five
// products, 43 GFLOP, 0.043 ms at 989 TFLOP/s; the function's 134 M
// exponentials (one a logit), 0.035 ms on the special function units (16
// a clock an SM at the 1.83 GHz of that peak). At GENIE_138M-S1024's
// (128, 1024, 16, 32): 1.07 GB, 0.326 ms; 687 GFLOP, 0.695 ms; 2.15e9
// exponentials, 0.556 ms: the products bound it. The second pass's
// products and exponentials are overhead of this design (seven products,
// 962 GFLOP, 0.973 ms; the exponentials twice, 1.11 ms), not of the
// function.
// ptxas (sm_90a): the dq pass 122 registers at head_dim 32 and 138 at 64,
// the dk/dv pass 154 and 186, no spills.
//
// Head_dim 128 (tiles of two 64-channel half-tiles, FaRows<128>). The dq
// pass holds dq whole (64 fp32 a thread beside S and dP). The dk/dv pass
// would hold dK and dV whole, 128 fp32 a thread beside S, dP and their
// bf16 fragments, past the 255-register cap: so a unit is (row, head, key
// tile, channel half), each summing dK and dV over its own 64 channels
// (the accumulators of head_dim 64) while S^T and dP^T run over all 128;
// the two halves of a key tile are neighbours in the grid, so the second
// read of each query chunk mostly comes from L2. The price: the logits and
// their exponentials of that pass twice (1.8x the function's products).
// Both passes keep two stages (TILE 16 KB; about 98 KB a block) so that two
// blocks share an SM. Still no atomics and no shared fp32 sum: the result
// is the same from run to run. Bound at GENIE_138M-h128's (128, 256, 4,
// 128): head_dim 32's bytes (0.082 ms with o, lse and delta) and products
// (43 GFLOP, 0.043 ms); a quarter of its exponentials. ptxas (sm_90a): the
// dq pass 174 registers (180 causal), the dk/dv pass 198 (196 causal), no
// spills.
//
// Head_dim 72 (FaRows<72>: a tile's 64 channels in the 128-byte swizzle,
// the last 8 unswizzled, then TMA's zeros). The logits and dP take a fifth
// k16 step over channels 64-79, the last 8 of them zeros in both operands;
// dQ += dS K, dV += P^T dO and dK += dS^T Q are an m64n64k16 and an m64n8k16
// a k16 step. Both passes keep head_dim 64's four stages (TILE 10 KB, 103
// KB a block: two blocks an SM); the dk/dv pass sums all 72 channels in one
// unit (36 fp32 each of dK and dV a thread). delta takes a row's nine
// chunks two a lane, the ninth on the quad's first lane. Bound at
// GENIE_138M-h72's (128, 256, 16, 72): head_dim 32's bytes times 2.25 (0.181
// ms with o, lse and delta), products 96.6 GFLOP (0.098 ms): the bytes.
//
// 64 <= N <= 4096 (FA_MAXN), N % 64 == 0, head_dim 32, 64, 72 or 128,
// strides multiples of 8.

#include "flash_attention.cuh"

using namespace tpu1x;

namespace {

constexpr int FB_THREADS = 128;  // one warpgroup
template <int D>
struct FbShape {
  static constexpr int TILE = FaRows<D>::TILE;
  // chunks in a pass's ring: two at head_dim 128, so that two blocks share
  // an SM
  static constexpr int STAGES = D == 128 ? 2 : 4;
  // the dk/dv pass's units a key tile (channel halves), the channels each
  // sums
  static constexpr int HALVES = D == 128 ? 2 : 1;
  static constexpr int DC = D / HALVES;
  // after 1024 bytes of alignment: the unit's two tiles, the ring of two
  // chunk tiles a stage, the lse and delta ring (512 bytes a stage), then
  // the tiles' mbarrier and each stage's
  static constexpr int SMEM =
      1024 + 2 * TILE + STAGES * (2 * TILE + 512) + 8 * (1 + STAGES);
};

template <int D>
struct BwdMaps {
  FaMap<D> in[4];   // q, k, v, d_o: 64 tokens of one head a box
  FaMap<D> out[3];  // dq, dk, dv: the same
};

// Row n of o (2 D bytes from `row`) times row n of d_o in shared memory
// (FaRows<D> layout at `g`), chunks c0 .. c0 + nc - 1.
template <int D>
__device__ __forceinline__ float delta_part(const bf16* row,
                                            const unsigned char* g, int n,
                                            int c0, int nc) {
  float dl = 0.f;
  for (int c = c0; c < c0 + nc; ++c) {
    float fo[8], fg[8];
    load8(row + 8 * c, fo);
    load8(reinterpret_cast<const bf16*>(g + FaRows<D>::at(n, c)), fg);
#pragma unroll
    for (int i = 0; i < 8; ++i) dl = fmaf(fo[i], fg[i], dl);
  }
  return dl;
}

// grid: R H N / 64 units, unit u = (item u / tiles, query tile u % tiles);
// FB_THREADS threads, dynamic shared memory FbShape<D>::SMEM. maps.in:
// 64-token boxes; delta_out (R, H, N) fp32.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(FB_THREADS, 2)
    flash_bwd_dq_kernel(const __grid_constant__ BwdMaps<D> maps,
                        const float* __restrict__ lse,
                        const bf16* __restrict__ o, long rso, long tso,
                        float* __restrict__ delta_out, int N, int H,
                        float scale) {
  using L = FaRows<D>;
  using F = FbShape<D>;
  constexpr int KS = (D + 15) / 16, FB_STAGES = F::STAGES;
  extern __shared__ unsigned char fqs_raw[];
  const uint32_t raw = smem_u32(fqs_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* base_p = fqs_raw + (base - raw);
  // the q and d_o tiles, the ring (k and v of a chunk a stage), the
  // mbarriers
  const uint32_t qtile = base, gtile = qtile + L::TILE,
                 ring = gtile + L::TILE;
  const uint32_t bar = ring + FB_STAGES * (2 * L::TILE + 512), full = bar + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles = N / FA_QT;
  const int item = blockIdx.x / tiles, qt = blockIdx.x % tiles;
  const int r = item / H, h = item % H;
  const int nc = CAUSAL ? qt + 1 : tiles;  // key chunks in view
  const float sl2 = scale * 1.4426950408889634f;

  // chunk c's k and v into stage c % FB_STAGES, by the first thread where
  // `on`
  auto load = [&](bool on, int c) {
    const uint32_t dst = ring + (c % FB_STAGES) * 2 * L::TILE,
                   b = full + 8 * (c % FB_STAGES);
    mbar_expect_tx_if(on, b, 2 * L::TILE);
    fa_load_if<D>(on, dst, &maps.in[1], h, c * FA_QT, r, b);
    fa_load_if<D>(on, dst + L::TILE, &maps.in[2], h, c * FA_QT, r, b);
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    for (int st = 0; st < FB_STAGES; ++st) mbar_init(full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, 2 * L::TILE);
    L::load(qtile, &maps.in[0], h, qt * FA_QT, r, bar);
    L::load(gtile, &maps.in[3], h, qt * FA_QT, r, bar);
    for (int c = 0; c < FB_STAGES && c < nc; ++c) load(true, c);
  }
  // rows r0 and r0 + 8 of the tile: their lse (log2 units) and delta
  const int r0 = warp * 16 + g;
  const float* lrow = lse + (long)item * N + qt * FA_QT;
  const float l0 = lrow[r0] * 1.4426950408889634f;
  const float l1 = lrow[r0 + 8] * 1.4426950408889634f;
  __syncthreads();  // the mbarriers' initialisation
  mbar_wait(bar, 0);
  const unsigned char* gp = base_p + (gtile - base);
  const bf16* orow = o + r * rso + (long)(qt * FA_QT) * tso + h * D;
  // a row's D / 8 chunks over the quad: D / 32 a lane, or at head_dim 72
  // two a lane and the ninth on the first
  constexpr int PER = D == 72 ? 2 : D / 32;
  float d0 = delta_part<D>(orow + r0 * tso, gp, r0, t4 * PER, PER);
  float d1 = delta_part<D>(orow + (r0 + 8) * tso, gp, r0 + 8, t4 * PER, PER);
  if constexpr (D == 72) {
    if (t4 == 0) {
      d0 += delta_part<D>(orow + r0 * tso, gp, r0, 8, 1);
      d1 += delta_part<D>(orow + (r0 + 8) * tso, gp, r0 + 8, 8, 1);
    }
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  float* drow = delta_out + (long)item * N + qt * FA_QT + r0;
  st_if(t4 == 0, drow, d0);
  st_if(t4 == 0, drow + 8, d1);

  // the stage of chunk c, once its bytes have landed
  auto stage_of = [&](int c) {
    mbar_wait(full + 8 * (c % FB_STAGES), (c / FB_STAGES) & 1);
    return ring + (c % FB_STAGES) * 2 * L::TILE;
  };
  // s[4 j + e], dp[4 j + e]: query warp 16 + g + 8 (e >> 1) of the tile,
  // key 64 c + 8 j + 2 t4 + (e & 1); dq[4 j + e]: the same query, channel
  // 8 j + 2 t4 + (e & 1)
  float s[32], dp[32], dq[D / 2];
  uint32_t da[16];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;
  auto issue_logits = [&](uint32_t kv) {
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      wgmma_qk(s, L::kmajor(qtile, k), L::kmajor(kv, k), k);
      wgmma_qk(dp, L::kmajor(gtile, k), L::kmajor(kv + L::TILE, k), k);
    }
  };
  uint32_t kc = stage_of(0);
  wgmma_fence();
  issue_logits(kc);
  wgmma_commit();
  wgmma_wait_all();
  hold(s);
  hold(dp);
  int c = 0;
  auto step = [&](auto last) {
    constexpr bool LAST = decltype(last)::value;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[4 * j + e], sl2, (e >> 1) ? -l1 : -l0));
        if (CAUSAL && c == qt &&
            8 * j + 2 * t4 + (e & 1) > warp * 16 + g + 8 * (e >> 1))
          p = 0.f;
        dp[4 * j + e] = p * (dp[4 * j + e] - ((e >> 1) ? d1 : d0));
      }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      da[4 * k] = pack_bf16(dp[8 * k], dp[8 * k + 1]);
      da[4 * k + 1] = pack_bf16(dp[8 * k + 2], dp[8 * k + 3]);
      da[4 * k + 2] = pack_bf16(dp[8 * k + 4], dp[8 * k + 5]);
      da[4 * k + 3] = pack_bf16(dp[8 * k + 6], dp[8 * k + 7]);
    }
    hold(da);
    hold(dq);
    uint32_t kn = 0;
    if constexpr (!LAST) kn = stage_of(c + 1);
    // dq += dS K of chunk c, and the logits of chunk c + 1
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_pv_tile<D>(dq, &da[4 * k], kc, k * 16);
    if constexpr (!LAST) issue_logits(kn);
    wgmma_commit();
    wgmma_wait_all();
    hold(dq);
    hold(s);
    hold(dp);
    // chunk c is read: its stage takes chunk c + FB_STAGES
    load(tid == 0 && c + FB_STAGES < nc, c + FB_STAGES);
    kc = kn;
  };
  for (; c + 1 < nc; ++c) step(Flag<false>{});
  step(Flag<true>{});

  // dq times scale into the q tile (its last reader was the last logits)
  // and out by one TMA store
  unsigned char* qp = base_p + (qtile - base);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(qp + L::at(r0, j) + t4 * 4) =
        pack_bf16(dq[4 * j] * scale, dq[4 * j + 1] * scale);
    *reinterpret_cast<uint32_t*>(qp + L::at(r0 + 8, j) + t4 * 4) =
        pack_bf16(dq[4 * j + 2] * scale, dq[4 * j + 3] * scale);
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    L::store(&maps.out[0], qtile, h, qt * FA_QT, r);
    bulk_commit();
    bulk_wait();
  }
}

// grid: R H (N / 64) HALVES units, unit u = (item u / (tiles HALVES), key
// tile u / HALVES % tiles, channel half u % HALVES); FB_THREADS threads,
// dynamic shared memory FbShape<D>::SMEM. delta: (R, H, N) fp32 from the
// dq pass. maps.out[1], out[2]: boxes of one half at head_dim 128.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(FB_THREADS, 2)
    flash_bwd_dkv_kernel(const __grid_constant__ BwdMaps<D> maps,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, int N, int H,
                         float scale) {
  using L = FaRows<D>;
  using F = FbShape<D>;
  constexpr int KS = (D + 15) / 16, FB_STAGES = F::STAGES, DC = F::DC;
  extern __shared__ unsigned char fks_raw[];
  const uint32_t raw = smem_u32(fks_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* base_p = fks_raw + (base - raw);
  // the k and v tiles, the ring (q and d_o of a chunk a stage), the lse
  // and delta ring (64 of each a stage), the mbarriers
  const uint32_t ktile = base, vtile = ktile + L::TILE,
                 ring = vtile + L::TILE;
  const uint32_t ld_ring = ring + FB_STAGES * 2 * L::TILE;
  const float* ld_p =
      reinterpret_cast<const float*>(base_p + (ld_ring - base));
  const uint32_t bar = ld_ring + FB_STAGES * 512, full = bar + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles = N / FA_QT;
  const int unit = blockIdx.x / F::HALVES, half = blockIdx.x % F::HALVES;
  const int item = unit / tiles, kt = unit % tiles;
  const int r = item / H, h = item % H;
  const int c0 = CAUSAL ? kt : 0;  // the first query chunk that sees the keys
  // the unit's channels in a tile: the half-tile `half` (head_dim 128)
  const uint32_t hoff = half * L::HALF;
  const float sl2 = scale * 1.4426950408889634f;
  const float* lrow = lse + (long)item * N;
  const float* drow = delta + (long)item * N;

  // query chunk c's q, d_o, lse and delta into stage (c - c0) % FB_STAGES,
  // by the first thread where `on`
  auto load = [&](bool on, int c) {
    const int st = (c - c0) % FB_STAGES;
    const uint32_t dst = ring + st * 2 * L::TILE, b = full + 8 * st;
    mbar_expect_tx_if(on, b, 2 * L::TILE + 512);
    fa_load_if<D>(on, dst, &maps.in[0], h, c * FA_QT, r, b);
    fa_load_if<D>(on, dst + L::TILE, &maps.in[3], h, c * FA_QT, r, b);
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %7, [%2];\n"
        "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%3], [%4], %7, [%5];\n}\n" ::"r"(ld_ring + st * 512),
        "l"(lrow + c * FA_QT), "r"(b), "r"(ld_ring + st * 512 + 256),
        "l"(drow + c * FA_QT), "r"(b), "r"((int)on), "r"(256)
        : "memory");
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    for (int st = 0; st < FB_STAGES; ++st) mbar_init(full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, 2 * L::TILE);
    L::load(ktile, &maps.in[1], h, kt * FA_QT, r, bar);
    L::load(vtile, &maps.in[2], h, kt * FA_QT, r, bar);
    for (int c = c0; c < c0 + FB_STAGES && c < tiles; ++c) load(true, c);
  }
  __syncthreads();  // the mbarriers' initialisation
  mbar_wait(bar, 0);

  // the stage of query chunk c, once its bytes have landed
  auto stage_of = [&](int c) {
    const int i = c - c0;
    mbar_wait(full + 8 * (i % FB_STAGES), (i / FB_STAGES) & 1);
    return i % FB_STAGES;
  };
  // s[4 j + e], dp[4 j + e]: key warp 16 + g + 8 (e >> 1) of the tile,
  // query 64 c + 8 j + 2 t4 + (e & 1); dk, dv[4 j + e]: the same key,
  // channel DC half + 8 j + 2 t4 + (e & 1)
  float s[32], dp[32], dk[DC / 2], dv[DC / 2];
  uint32_t pa[16], da[16];
#pragma unroll
  for (int e = 0; e < DC / 2; ++e) dk[e] = dv[e] = 0.f;
  auto issue_logits = [&](int st) {
    const uint32_t qc = ring + st * 2 * L::TILE;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      wgmma_qk(s, L::kmajor(ktile, k), L::kmajor(qc, k), k);
      wgmma_qk(dp, L::kmajor(vtile, k), L::kmajor(qc + L::TILE, k), k);
    }
  };
  int c = c0;
  int sc = stage_of(c);  // the stage of the chunk in hand
  wgmma_fence();
  issue_logits(sc);
  wgmma_commit();
  wgmma_wait_all();
  hold(s);
  hold(dp);
  auto step = [&](auto last) {
    constexpr bool LAST = decltype(last)::value;
    const float* l2s = ld_p + sc * 128;  // the chunk's lse, then its delta
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = 8 * j + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(l2s + q);
      const float2 dl = *reinterpret_cast<const float2*>(l2s + 64 + q);
      const float la = l2.x * 1.4426950408889634f,
                  lb = l2.y * 1.4426950408889634f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[4 * j + e], sl2, (e & 1) ? -lb : -la));
        if (CAUSAL && c == kt &&
            8 * j + 2 * t4 + (e & 1) < warp * 16 + g + 8 * (e >> 1))
          p = 0.f;
        s[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
      }
    }
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
    hold(pa);
    hold(da);
    hold(dk);
    hold(dv);
    int sn = 0;
    if constexpr (!LAST) sn = stage_of(c + 1);
    // dv += P^T dO and dk += dS^T Q of chunk c over the unit's channels,
    // and the logits of c + 1
    const uint32_t qc = ring + sc * 2 * L::TILE + hoff;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_pv_tile<D, DC>(dv, &pa[4 * k], qc + L::TILE, k * 16);
      wgmma_pv_tile<D, DC>(dk, &da[4 * k], qc, k * 16);
    }
    if constexpr (!LAST) issue_logits(sn);
    wgmma_commit();
    wgmma_wait_all();
    hold(dk);
    hold(dv);
    hold(s);
    hold(dp);
    // chunk c is read (its lse and delta by every warp of the group): its
    // stage takes chunk c + FB_STAGES
    fence_proxy_async();
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    load(tid == 0 && c + FB_STAGES < tiles, c + FB_STAGES);
    sc = sn;
  };
  for (; c + 1 < tiles; ++c) step(Flag<false>{});
  step(Flag<true>{});

  // dk (times scale) and dv into the unit's channels of the tile's own K
  // and V rows, and out
  unsigned char* kp = base_p + (ktile - base);
  unsigned char* vp = base_p + (vtile - base);
  const int r0 = warp * 16 + g, j0 = half * (DC / 8);
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
    *reinterpret_cast<uint32_t*>(kp + L::at(r0, j0 + j) + t4 * 4) =
        pack_bf16(dk[4 * j] * scale, dk[4 * j + 1] * scale);
    *reinterpret_cast<uint32_t*>(kp + L::at(r0 + 8, j0 + j) + t4 * 4) =
        pack_bf16(dk[4 * j + 2] * scale, dk[4 * j + 3] * scale);
    *reinterpret_cast<uint32_t*>(vp + L::at(r0, j0 + j) + t4 * 4) =
        pack_bf16(dv[4 * j], dv[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(vp + L::at(r0 + 8, j0 + j) + t4 * 4) =
        pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    L::store(&maps.out[1], ktile + hoff, h, kt * FA_QT, r, half);
    L::store(&maps.out[2], vtile + hoff, h, kt * FA_QT, r, half);
    bulk_commit();
    bulk_wait();
  }
}

// The backward in two launches, the dq pass (which writes delta into
// `work`, (R, H, N) fp32) first.
template <int D>
cudaError_t launch_bwd(const void* const* in, const long* rs, const long* ts,
                       void* const* out, const long* ors, const long* ots,
                       const float* lse, const bf16* o, long rso, long tso,
                       float* work, int R, int N, int H, float scale,
                       bool causal, cudaStream_t stream) {
  if (work == nullptr) return cudaErrorInvalidValue;
  BwdMaps<D> maps;
  for (int i = 0; i < 4; ++i)
    TPU1X_TRY(tensor_map<D>(&maps.in[i], in[i], rs[i], ts[i], R, N, H,
                            FA_QT));
  // at head_dim 128 dq leaves whole tiles, dk and dv a half a unit; at 72
  // every store leaves the tile without its zeros
  for (int i = 0; i < 3; ++i)
    TPU1X_TRY(tensor_map<D>(&maps.out[i], out[i], ors[i], ots[i], R, N, H,
                            FA_QT, i == 0 && D != 72 ? 2 : 1));
  typedef void (*DqKernel)(BwdMaps<D>, const float*, const bf16*, long, long,
                           float*, int, int, float);
  typedef void (*DkvKernel)(BwdMaps<D>, const float*, const float*, int, int,
                            float);
  static const DqKernel dq_forms[2] = {flash_bwd_dq_kernel<D, false>,
                                       flash_bwd_dq_kernel<D, true>};
  static const DkvKernel dkv_forms[2] = {flash_bwd_dkv_kernel<D, false>,
                                         flash_bwd_dkv_kernel<D, true>};
  // the shared memory limit, set once a process for each form
  static bool ready[2] = {false, false};
  const int form = causal ? 1 : 0;
  if (!ready[form]) {
    TPU1X_TRY(cudaFuncSetAttribute(dq_forms[form],
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   FbShape<D>::SMEM));
    TPU1X_TRY(cudaFuncSetAttribute(dkv_forms[form],
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   FbShape<D>::SMEM));
    ready[form] = true;
  }
  const unsigned units = (unsigned)(R * H) * (N / FA_QT);
  dq_forms[form]<<<units, FB_THREADS, FbShape<D>::SMEM, stream>>>(
      maps, lse, o, rso, tso, work, N, H, scale);
  TPU1X_TRY(cudaGetLastError());
  dkv_forms[form]<<<units * FbShape<D>::HALVES, FB_THREADS, FbShape<D>::SMEM,
                    stream>>>(maps, lse, work, N, H, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 (R, N, H, D) views, D = 32, 64, 72 or 128, element (r, n,
// h, d) at r * rs + n * ts + h * D + d with each tensor's own rs and ts
// (multiples of 8, 16-byte aligned base); out bf16 (R, N, H, D)
// contiguous; lse fp32 (R, H, N), the log-sum-exp of each query's scaled logits.
extern "C" int tpu1x_flash_mha(const void* q, const void* k, const void* v,
                               void* out, void* lse, long rsq, long tsq,
                               long rsk, long tsk, long rsv, long tsv, int R,
                               int N, int H, int D, float scale, int causal,
                               void* stream) {
  return launch_flash_fwd(q, k, v, out, static_cast<float*>(lse), rsq, tsq,
                          rsk, tsk, rsv, tsv, R, N, H, D, scale, causal != 0,
                          static_cast<cudaStream_t>(stream));
}

// q, k, v, o, d_o: bf16 (R, N, H, D) views as above (o with strides
// (rso, tso), d_o with (rsg, tsg)); lse fp32 (R, H, N) from the forward;
// dq, dk, dv bf16 (R, N, H, D) views with strides (rsdq, tsdq), (rsdk,
// tsdk), (rsdv, tsdv) (multiples of 8, 16-byte aligned bases): contiguous
// tensors, or the three thirds of one (R, N, 3C) tensor, written by TMA
// stores 64 tokens of one head at a time; work: fp32 (R, H, N) scratch
// (delta, from the dq pass to the dk/dv pass).
extern "C" int tpu1x_flash_mha_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* d_o,
                                   const void* lse, void* dq, void* dk,
                                   void* dv, void* work, long rsq, long tsq,
                                   long rsk, long tsk, long rsv, long tsv,
                                   long rso, long tso, long rsg, long tsg,
                                   long rsdq, long tsdq, long rsdk, long tsdk,
                                   long rsdv, long tsdv, int R, int N, int H,
                                   int D, float scale, int causal,
                                   void* stream) {
  const long strides[16] = {rsq,  tsq,  rsk,  tsk,  rsv,  tsv,  rso,  tso,
                            rsg,  tsg,  rsdq, tsdq, rsdk, tsdk, rsdv, tsdv};
  if (!flash_ok(N, D, strides, 16)) return cudaErrorInvalidValue;
  if (R * H == 0) return cudaSuccess;
  const void* in[4] = {q, k, v, d_o};
  const long rs[4] = {rsq, rsk, rsv, rsg}, ts[4] = {tsq, tsk, tsv, tsg};
  void* out[3] = {dq, dk, dv};
  const long ors[3] = {rsdq, rsdk, rsdv}, ots[3] = {tsdq, tsdk, tsdv};
  return (D == 32   ? launch_bwd<32>
          : D == 64 ? launch_bwd<64>
          : D == 72 ? launch_bwd<72>
                    : launch_bwd<128>)(
      in, rs, ts, out, ors, ots, static_cast<const float*>(lse),
      static_cast<const bf16*>(o), rso, tso, static_cast<float*>(work), R, N,
      H, scale, causal != 0, static_cast<cudaStream_t>(stream));
}
