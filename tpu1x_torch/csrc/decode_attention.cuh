// Attention of one query frame, or of a [prev, cur] pair of frames, against
// the KV cache slots t < t_B[b] of one layer plus the in-pass keys: one joint
// fp32 softmax per (token, head). The kernel that the temporal+MLP block
// (csrc/temporal_mlp_block.cu) and the stand-alone decode attention
// (csrc/decode_attention.cu) both launch.
//
// Bound on the H100: device memory, the read of the valid cache slots
// (2 B S C bytes per slot in bf16, half that in int8, plus 8 B S bytes of
// int8 scales). Only slots t < t_B[b] are read: the TPU kernels streamed
// all T slots and masked. Under one FMA a byte, so what limits the kernel
// is bytes in flight and the arithmetic per byte, not the tensor cores
// (each (token, head) has its own keys):
//   - a work item is a tile of `ts` tokens of one row b, all heads up to
//     C = 2048: for each slot t, its K rows and its V rows are each one
//     contiguous run of ts C elements of the cache (and, for int8, its ts
//     scales of K and of V one run each), so one 1-D bulk copy
//     (cp.async.bulk) a tensor brings a slot's tile into shared memory,
//     with no tensor map. Past C = 2048 an item is a group of whole heads
//     of its tokens (the attention over the frame axis is per head): the
//     heads split into the fewest equal groups of at most 2048 channels
//     (C = 3072 and 4096: two), so that every per-item size (rows, item
//     buffer, stage) stays at or below the C = 2048 form's, and a slot's
//     tile is one bulk copy a token and tensor, cg channels at a stride of
//     C (`decode_plan`);
//   - persistent blocks, as many as the card keeps resident, walk the
//     items sorted by their slot count (t_B on the card), block j taking
//     the j-th of each round of G items going one way and the (G - 1 -
//     j)-th coming back, so each block's sum of slots is within a few
//     percent of the mean even with a ragged t_B (a contiguous share of
//     the items left the heaviest block at 1.4-1.8x the mean);
//   - one producer thread keeps the block's ring of stages full (a stage is
//     one slot of one item: K, V and the int8 scales), walking the same
//     items and slots as the consumers, each stage completing on its own
//     "full" mbarrier with the copy's byte count, and reused when every
//     consumer warp has arrived on its "empty" mbarrier; an item with
//     t_B[b] = 0 starts no copy and waits on no barrier. The int8 cache's
//     half-size tiles give twice the stages in the same shared memory, so
//     it keeps as many bytes in flight and reaches its own, halved bound.
//     The K, V and q, k, v copies carry an L2 evict-first policy, and out
//     and the k/v copies are streaming stores: read or written once, none
//     should push out of L2 what the next product reads, nor keep there
//     the qkv product's dirty lines for it to write back (K3's attention,
//     0.061 ms with the policy on K and V alone, took 0.046 with all of it
//     and its proj held: the two A/Bs of PERF.md section 6);
//   - one consumer thread owns 32 channels of one token, a (token, head)
//     row at head_dim 32: q and the output accumulator of each frame in
//     registers (fp32), K and V of each slot read from shared memory in
//     16-byte chunks, in an order rotated by the thread's row so that
//     eight neighbouring lanes hit 32 distinct banks. At head_dim 64 a
//     head row is two neighbouring lanes, each with its 32 channels: the
//     halves of a logit are summed by one shuffle between the pair (both
//     lanes then hold the same logit, bit for bit, and take the same
//     softmax steps), so a thread keeps the registers, loads and stores of
//     head_dim 32 (a whole 64-channel row, q and acc of both frames, would
//     be 256 fp32 values a thread) and an item the same threads and bytes;
//     at head_dim 128 a quad of lanes, its four parts summed by two
//     shuffles (lanes 4i .. 4i + 3: (x0 + x1) + (x2 + x3) in every lane, the
//     same bits, fp32 addition being commutative). At head_dim 72 (2.25
//     lanes of 32) a thread owns 24 channels, three 16-byte chunks of bf16
//     (three 8-byte chunks of int8, whose rows are 24 bytes), a head row
//     three neighbouring lanes, and a warp ten head rows on lanes 0-29
//     (lanes 30 and 31 idle, as `p.lanes` idles a warp's tail), so that no
//     head's lanes cross a warp; the three parts are summed by shuffles
//     from the row's named lanes, (x0 + x1) + x2 in each (the same bits).
//     A thread's 24 channels in 48- (or 24-) byte rows put eight (sixteen)
//     neighbouring lanes on 32 distinct banks with no rotation;
//   - one pass over K and V: an online softmax in the log2 domain, a
//     running maximum and sum per (token, head, frame), each slot's K and
//     V tiles consumed together and freed. The maximum starts at the
//     in-pass logits and moves only when a logit exceeds it by more than
//     DA_LAZY (then the accumulator is rescaled), so the common slot costs
//     one exponential and no rescale; the softmax is the same function,
//     its terms at most 2^DA_LAZY before the division;
//   - an int8 value becomes fp32 by the magic-number trick: the byte,
//     biased to excess-128 by one XOR per four bytes, is placed in the low
//     mantissa of 2^23 by one PRMT, and 2^23 + 128 is subtracted (exact),
//     not by the quarter-rate I2F; the slot's scales multiply the logit
//     and the probability, so no dequantized copy exists;
//   - an item's q, k, v (strided: one bulk copy a token row and tensor)
//     come by the producer too, into an item buffer that it refills as
//     soon as the consumers have read it, so they arrive while the last
//     item's slots are computed (level with the consumer threads' own
//     loads for the bf16 cache, faster for int8); out and the k/v copies
//     are written with 16-byte stores.
// The pair (frames = 2) costs one read of the cache: a thread holds both
// frames' q and accumulators, and each slot's values, converted once, feed
// both. prev attends the cache plus itself; cur the cache, prev's k/v and
// itself. Logits, softmax and the PV sums stay fp32, as the references'.

#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace tpu1x {

// The most cache slots a launch takes. Nothing of the kernel's shape
// depends on T: the ring streams one slot at a time, a row's slot count and
// the walk's order are clamped to T, and every cache and int8-scale offset
// is a slot index times its stride; the online softmax's lazy maximum
// (DA_LAZY) bounds each of at most T + 2 terms by 2^DA_LAZY, so its sum
// stays far below fp32's range.
constexpr int DA_MAXT = 32;
// The tile: the (token, 32-channel) rows of a work item (a consumer thread
// each, whatever the head width), and the shared memory a block gives its
// item buffer and ring with a bf16 cache (three blocks an SM) and with an
// int8 cache (four: its arithmetic a byte is the larger); at least two
// stages. The tokens of an item are DA_ROWS / (cg / 32) for an item of cg
// channels (C, or a head group's past 2048), a multiple of 4 (so that an
// item's int8 scales are whole 16-byte runs), at least 4, where that makes
// the rows whole warps (every cg % 256 == 0); other widths take more
// tokens or idle lanes (`decode_plan`). Measured with `chip_variants.py
// da` (PERF.md section 6).
constexpr int DA_ROWS = 64;
constexpr int DA_SMEM = 64 * 1024;
constexpr int DA_SMEM_Q8 = 52 * 1024;
constexpr int DA_MAX_STAGES = 32;
// Rows a block may hold (2048 channels at 4 tokens: the widest item, since
// an item holds at least 4 tokens; a wider C splits into head groups of at
// most DA_MAX_ROWS * 8 channels), and its threads; at
// head_dim 72 the consumer lanes of 4 tokens of C = 2016 (28 heads, 112
// rows of three lanes, ten a warp: twelve warps), a form of its own (WIDE)
// past DA_THREADS: its 13 warps put 4 on an SM sub-partition, a cap of 128
// registers, under which the pair form spills (at 9 warps, 168).
constexpr int DA_MAX_ROWS = 256;
constexpr int DA_THREADS = DA_MAX_ROWS + 32;
constexpr int DA_MAX_LANES_72 = 384;
constexpr int DA_THREADS_72 = DA_MAX_LANES_72 + 32;
// log2 of the largest term the online softmax lets build up before it
// moves the maximum and rescales.
constexpr float DA_LAZY = 8.f;
// Rows b of one launch: a larger batch takes one launch per DA_MAX_B rows,
// so that shared memory does not depend on B.
constexpr int DA_MAX_B = 256;
// Shared memory: the ring's barriers (full, empty) and the item buffer's
// (full, empty) in the first 1024 bytes; each row's slots and the rows in
// the walk's order (DA_MAX_B ints each); from DA_IO the item buffer (q, k, v
// of each frame), then the ring.
constexpr int DA_IO = 1024 + 8 * DA_MAX_B;

struct DecodeAttnArgs {
  // frame f's q, k, v: element (b, s, c) of kind i (0 q, 1 k, 2 v) at
  // b * sb[i] + s * ld[i] + c; frame 1 is read only with two frames
  const bf16* q[2];
  const bf16* k[2];
  const bf16* v[2];
  long sb[3], ld[3];
  const void* kc;  // (T, L, B, S, C) bf16, or int8 with the scales below
  const void* vc;
  const float* ksc;  // (L, B, T, S) fp32 per-token scales of an int8 cache
  const float* vsc;
  const int* t_B;  // (B,)
  bf16* out[2];    // frame f's output, element (b, s, c) at b osb + s old + c
  long osb, old;
  bf16* k_out;  // (B, S, C) contiguous copies of frame 0's k and v, or null
  bf16* v_out;
  int B, S, C, T, L, layer;
  int D;   // head_dim, 32, 64, 72 or 128
  int nb;  // rows b of this launch (<= DA_MAX_B; B is the caches' own)
  float scale;
};

// The launch's shape, from S, C and the cache type (decode_plan).
struct DecodePlan {
  int ts;        // tokens of an item
  int groups;    // head groups of a token: 1 up to 2048 channels
  int cg;        // an item's channels of a token, C / groups
  int rows;      // (token, 32 channels) rows of an item (24 at head_dim 72)
  int lanes;     // the consumer threads: rows rounded up to a warp (at 72
                 // ten head rows of three lanes a warp)
  int tiles;     // items of one row b: token tiles times head groups
  int stages;    // stages of the ring
  uint32_t tile_bytes;   // one slot's K (or V) rows of a full item
  uint32_t stage_bytes;  // K, V and the int8 scales
  uint32_t io_bytes;     // an item's q, k, v rows (bf16) of every frame
};

// A thread's W channels of a head row (32, or 24 at head_dim 72), the
// channels of one chunk of a cache row (16 bytes: 8 bf16, 16 int8; at 72 an
// int8 chunk is 8 bytes, 8 values), and the chunks of a thread.
template <bool Q, int D = 32>
struct DaRow {
  static constexpr int W = D == 72 ? 24 : 32;
  static constexpr int CPC = Q && D != 72 ? 16 : 8;
  static constexpr int NCH = W / CPC;
  // the chunk of a cache row: 16 bytes, or 8 (int8 at head_dim 72)
  using Chunk = typename std::conditional<Q && D == 72, uint2, uint4>::type;
  // the chunk of register group c of a thread whose chunks are rotated by
  // `rot` (at head_dim 72 not rotated), and its first channel
  static __device__ __forceinline__ int idx(int c, int rot) {
    if constexpr (D == 72) return c;
    return (c + rot) & (NCH - 1);
  }
  static __device__ __forceinline__ int chan(int c, int rot) {
    return idx(c, rot) * CPC;
  }
};

// A 16-byte chunk of the cache as fp32 values: 8 bf16 (shift, mask) or
// 16 int8 (excess-128 byte in the mantissa of 2^23, minus 2^23 + 128).
template <bool Q>
__device__ __forceinline__ void unpack(const uint4 u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (Q) {
      const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] =
            __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 | j)) -
            8388736.f;
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}

// 8 int8 values of an 8-byte chunk (head_dim 72's int8 cache rows), as
// unpack's.
template <bool Q>
__device__ __forceinline__ void unpack(const uint2 u, float* f) {
  static_assert(Q, "8-byte chunks are int8");
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] =
          __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 | j)) -
          8388736.f;
  }
}

// One bf16 row of a thread's W channels of shared memory, rows 2 W bytes
// apart,
// as fp32 values in the thread's rotated order; `raw` keeps the bits.
template <bool Q, int D>
__device__ __forceinline__ void load_row(const uint8_t* rows, int r, int rot,
                                         float* f, uint4* raw) {
  using R = DaRow<Q, D>;
  const uint4* row = reinterpret_cast<const uint4*>(rows + r * 2 * R::W);
#pragma unroll
  for (int c = 0; c < R::NCH; ++c)
#pragma unroll
    for (int h = 0; h < R::CPC / 8; ++h) {
      const int i = c * R::CPC / 8 + h;
      raw[i] = row[R::chan(c, rot) / 8 + h];
      unpack<false>(raw[i], f + 8 * i);
    }
}

// Rows back to global memory with streaming stores (st.global.cs): written
// once and read at most once by the next launch, their lines go first.
template <bool Q, int D>
__device__ __forceinline__ void copy_row(bf16* row, int rot, const uint4* raw) {
  using R = DaRow<Q, D>;
#pragma unroll
  for (int c = 0; c < R::NCH; ++c)
#pragma unroll
    for (int h = 0; h < R::CPC / 8; ++h)
      __stcs(reinterpret_cast<uint4*>(row + R::chan(c, rot) + 8 * h),
             raw[c * R::CPC / 8 + h]);
}

template <bool Q, int D>
__device__ __forceinline__ void store_row(bf16* row, int rot, const float* f) {
  using R = DaRow<Q, D>;
#pragma unroll
  for (int c = 0; c < R::NCH; ++c)
#pragma unroll
    for (int h = 0; h < R::CPC / 8; ++h) {
      const float* x = f + c * R::CPC + 8 * h;
      const uint4 u = {pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                       pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7])};
      __stcs(reinterpret_cast<uint4*>(row + R::chan(c, rot) + 8 * h), u);
    }
}

template <int W>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < W; ++i) d[i & 3] = fmaf(a[i], b[i], d[i & 3]);
  return (d[0] + d[1]) + (d[2] + d[3]);
}

// The logit of a head row from a thread's part: at head_dim 64 the sum of
// the two lanes' halves (the pair of lanes 2i, 2i + 1 of a token; both are
// live or neither), at 72 of the three lanes' thirds (lanes 3i .. 3i + 2 of
// lanes 0-29, all live or none), at 128 of the quad's quarters (lanes 4i
// .. 4i + 3, all live or none), the same value in each.
template <int D>
__device__ __forceinline__ float head_sum(float x) {
  if constexpr (D == 64) {
    const unsigned pair = 3u << (threadIdx.x & 30);
    x += __shfl_xor_sync(pair, x, 1);
  } else if constexpr (D == 72) {
    const int r0 = (threadIdx.x & 31) / 3 * 3;  // the row's first lane
    const unsigned three = 7u << r0;
    x = (__shfl_sync(three, x, r0) + __shfl_sync(three, x, r0 + 1)) +
        __shfl_sync(three, x, r0 + 2);
  } else if constexpr (D == 128) {
    const unsigned quad = 15u << (threadIdx.x & 28);
    x += __shfl_xor_sync(quad, x, 1);
    x += __shfl_xor_sync(quad, x, 2);
  }
  return x;
}

// The item at step `step` of block j's walk over G blocks: the j-th of
// that round of G items, counted back from its end when the step is odd.
__device__ __forceinline__ long da_walk(int step, int j, int G) {
  return (long)step * G + ((step & 1) ? G - 1 - j : j);
}

// F frames per row (1, or 2 = [prev, cur]); Q: int8 cache; D: head_dim.
// Threads: p.lanes consumers (p.rows of them own a row; the rest, fewer
// than a warp, wait and arrive on the barriers with their warp and compute
// nothing), then one producer warp; WIDE: more than DA_THREADS of them
// (head_dim 72 past C = 1440).
template <int F, bool Q, int D, bool WIDE = false>
__global__ void __launch_bounds__(WIDE ? DA_THREADS_72 : DA_THREADS, 1)
    decode_ring_kernel(const DecodeAttnArgs a, const DecodePlan p) {
  using R = DaRow<Q, D>;
  using Chunk = typename R::Chunk;
  constexpr int W = R::W;
  constexpr int ELT = Q ? 1 : 2;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* io = smem + DA_IO;
  uint8_t* ring = io + p.io_bytes;
  int* slots = reinterpret_cast<int*>(smem + 1024);
  int* order = slots + DA_MAX_B;
  const uint32_t full0 = smem_u32(smem), empty0 = full0 + DA_MAX_STAGES * 8;
  const uint32_t io_full = empty0 + DA_MAX_STAGES * 8, io_empty = io_full + 8;
  const int B = a.B, nb = a.nb, S = a.S, C = a.C, T = a.T;
  // head groups only past 2048 channels, which head_dim 72 never reaches:
  // its forms keep the one-group arithmetic (and registers) at compile time
  const int groups = D == 72 ? 1 : p.groups, cg = D == 72 ? C : p.cg;
  const long items = (long)nb * p.tiles;
  const uint32_t row_bytes = p.ts * cg * 2;  // one tensor of an item in io

  for (int i = threadIdx.x; i < nb; i += blockDim.x)
    slots[i] = max(0, min(a.t_B[i], T));
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, p.lanes / 32);
    }
    mbar_init(io_full, 1);
    mbar_init(io_empty, p.lanes / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the rows by slots, most first (ties by b): item n of the walk is tile
  // n % tiles of row order[n / tiles]
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    int rank = 0;
    for (int j = 0; j < nb; ++j)
      rank += slots[j] > slots[i] || (slots[j] == slots[i] && j < i);
    order[rank] = i;
  }
  __syncthreads();

  if (threadIdx.x >= p.lanes) {  // the producer
    if (threadIdx.x != p.lanes) return;
    int stage = 0;
    uint32_t phase = 0;
    long used = 0;
    const uint64_t once = l2_evict_first();
    for (int step = 0;; ++step) {
      const long n = da_walk(step, blockIdx.x, gridDim.x);
      if (n >= items) break;
      // an item's index fits 32 bits (DA_MAX_B rows of at most S / 4
      // tiles of at most C / 32 head groups): the division in 32 bits
      const int ni = (int)n;
      int tile = ni % p.tiles, c0 = 0;  // token tile, the group's channel
      if (groups > 1) {
        const int w = tile;
        tile = w / groups;
        c0 = (w - tile * groups) * cg;
      }
      const int b = order[ni / p.tiles], s0 = tile * p.ts;
      const int ntok = min(p.ts, S - s0), tb = slots[b];
      // the item's q, k, v rows, once the consumers have read the last ones
      if (step > 0) mbar_wait(io_empty, (step - 1) & 1);
      mbar_expect_tx(io_full, 3 * F * ntok * cg * 2);
#pragma unroll
      for (int f = 0; f < F; ++f)
        for (int i = 0; i < 3; ++i) {
          const bf16* x = (i == 0 ? a.q[f] : i == 1 ? a.k[f] : a.v[f]) +
                          b * a.sb[i] + s0 * a.ld[i] + c0;
          const uint32_t dst = smem_u32(io + (f * 3 + i) * row_bytes);
          for (int j = 0; j < ntok; ++j)
            bulk_load_hint(dst + j * cg * 2, x + j * a.ld[i], cg * 2, io_full,
                           once);
        }
      // a slot's K (or V) rows of the item: one run of ntok C elements, or
      // past 2048 channels a run of cg a token, C apart
      const uint32_t run = cg * ELT, bytes = ntok * run;
      const int runs = groups == 1 ? 1 : ntok;
      const uint32_t run_bytes = groups == 1 ? bytes : run;
      for (int t = 0; t < tb; ++t, ++used) {
        if (used >= p.stages) mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t bar = full0 + 8 * stage;
        uint8_t* st = ring + (size_t)stage * p.stage_bytes;
        mbar_expect_tx(bar, 2 * bytes + (Q ? 8 * ntok : 0));
        const long off =
            ((((long)t * a.L + a.layer) * B + b) * S + s0) * C + c0;
        for (int j = 0; j < runs; ++j) {
          const long at = (off + (long)j * C) * ELT;
          bulk_load_hint(smem_u32(st + j * run),
                         static_cast<const uint8_t*>(a.kc) + at, run_bytes,
                         bar, once);
          bulk_load_hint(smem_u32(st + p.tile_bytes + j * run),
                         static_cast<const uint8_t*>(a.vc) + at, run_bytes,
                         bar, once);
        }
        if constexpr (Q) {
          const long so = (((long)a.layer * B + b) * T + t) * S + s0;
          bulk_load(smem_u32(st + 2 * p.tile_bytes), a.ksc + so, 4 * ntok,
                    bar);
          bulk_load(smem_u32(st + 2 * p.tile_bytes + 4 * p.ts), a.vsc + so,
                    4 * ntok, bar);
        }
        if (++stage == p.stages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // a consumer: row r = (token, W channels from hc) of every item, or an
  // idle lane past p.rows (at head_dim 72 also lanes 30 and 31 of a warp,
  // whose rows are 30 a warp)
  int r = threadIdx.x;
  if constexpr (D == 72)
    r = (r & 31) < 30 ? 30 * (r >> 5) + (r & 31) : p.rows;
  const int rw = cg / W;
  const int tok = r / rw;
  const int hr = (r % rw) * W;  // the row's first channel in its group
  const int rot = Q ? (r >> 2) & 1 : (r >> 1) & 3;
  const float sc2 = a.scale * 1.4426950408889634f;  // logits in log2 units
  int stage = 0;
  uint32_t phase = 0;
  for (int step = 0;; ++step) {
    const long n = da_walk(step, blockIdx.x, gridDim.x);
    if (n >= items) break;
    // in 32 bits, as the producer's (the 64-bit division's temporaries
    // cost the pair form a spill at 168 registers)
    const int ni = (int)n;
    int tile = ni % p.tiles, hc = hr;  // token tile, the row's channel
    if (groups > 1) {
      const int w = tile;
      tile = w / groups;
      hc += (w - tile * groups) * cg;
    }
    const int b = order[ni / p.tiles], s = tile * p.ts + tok;
    // a last tile may be short; idle lanes hold no row
    const bool live = r < p.rows && s < S;
    const int tb = slots[b];

    // the in-pass keys: frame 0's k and v are frame 0's own and cur's prev
    float q[F][W], acc[F][W], m[F], l[F];
    mbar_wait(io_full, step & 1);
    if (live) {
      float kf[W];
      uint4 raw[W / 8];
#pragma unroll
      for (int f = 0; f < F; ++f)
        load_row<Q, D>(io + 3 * f * row_bytes, r, rot, q[f], raw);
      load_row<Q, D>(io + row_bytes, r, rot, kf, raw);
      if (a.k_out != nullptr)
        copy_row<Q, D>(a.k_out + ((long)b * S + s) * C + hc, rot, raw);
      const float s00 = head_sum<D>(dot<W>(q[0], kf)) * sc2;
      const float s10 =
          F == 2 ? head_sum<D>(dot<W>(q[F - 1], kf)) * sc2 : 0.f;
      load_row<Q, D>(io + 2 * row_bytes, r, rot, acc[0], raw);
      if (a.v_out != nullptr)
        copy_row<Q, D>(a.v_out + ((long)b * S + s) * C + hc, rot, raw);
      m[0] = s00;
      l[0] = 1.f;
      if constexpr (F == 2) {
        load_row<Q, D>(io + 4 * row_bytes, r, rot, kf, raw);
        const float s11 = head_sum<D>(dot<W>(q[1], kf)) * sc2;
        m[1] = fmaxf(s10, s11);
        const float e10 = ex2(s10 - m[1]), e11 = ex2(s11 - m[1]);
        l[1] = e10 + e11;
        load_row<Q, D>(io + 5 * row_bytes, r, rot, kf, raw);
#pragma unroll
        for (int i = 0; i < W; ++i)
          acc[1][i] = fmaf(e11, kf[i], acc[0][i] * e10);
      }
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(io_empty);

    for (int t = 0; t < tb; ++t) {
      mbar_wait(full0 + 8 * stage, phase);
      if (live) {
        const uint8_t* st = ring + (size_t)stage * p.stage_bytes;
        const Chunk* kr = reinterpret_cast<const Chunk*>(st + r * W * ELT);
        const Chunk* vr =
            reinterpret_cast<const Chunk*>(st + p.tile_bytes + r * W * ELT);
        // V's chunks: with the logits' K chunks at one frame, after the
        // logits with two (both frames' q and acc are 128 fp32 a thread,
        // and DA_THREADS' 9 warps put 3 on one SM sub-partition: a cap of
        // 168 registers, which V's chunks beside K's would pass)
        Chunk ku[R::NCH], vu[R::NCH];
        auto load_v = [&] {
#pragma unroll
          for (int c = 0; c < R::NCH; ++c) vu[c] = vr[R::idx(c, rot)];
        };
#pragma unroll
        for (int c = 0; c < R::NCH; ++c) ku[c] = kr[R::idx(c, rot)];
        if constexpr (F == 1) load_v();
        float sk = sc2, sv = 1.f;
        if constexpr (Q) {
          const float* scl =
              reinterpret_cast<const float*>(st + 2 * p.tile_bytes);
          sk *= scl[tok];
          sv = scl[p.ts + tok];
        }
        float d[F][R::NCH];
#pragma unroll
        for (int c = 0; c < R::NCH; ++c) {
          float kf[R::CPC];
          unpack<Q>(ku[c], kf);
#pragma unroll
          for (int f = 0; f < F; ++f) {
            d[f][c] = 0.f;
#pragma unroll
            for (int i = 0; i < R::CPC; ++i)
              d[f][c] = fmaf(q[f][c * R::CPC + i], kf[i], d[f][c]);
          }
        }
        float pv[F];
#pragma unroll
        for (int f = 0; f < F; ++f) {
          float x = d[f][0];
#pragma unroll
          for (int c = 1; c < R::NCH; ++c) x += d[f][c];
          x = head_sum<D>(x) * sk;
          if (x > m[f] + DA_LAZY) {  // rare: move the maximum, rescale
            const float corr = ex2(m[f] - x);
            l[f] *= corr;
#pragma unroll
            for (int i = 0; i < W; ++i) acc[f][i] *= corr;
            m[f] = x;
          }
          const float e = ex2(x - m[f]);
          l[f] += e;
          pv[f] = e * sv;
        }
        if constexpr (F == 2) load_v();
#pragma unroll
        for (int c = 0; c < R::NCH; ++c) {
          float vf[R::CPC];
          unpack<Q>(vu[c], vf);
#pragma unroll
          for (int f = 0; f < F; ++f)
#pragma unroll
            for (int i = 0; i < R::CPC; ++i)
              acc[f][c * R::CPC + i] =
                  fmaf(pv[f], vf[i], acc[f][c * R::CPC + i]);
        }
      }
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == p.stages) stage = 0, phase ^= 1;
    }

    if (live) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float inv = 1.f / l[f];
#pragma unroll
        for (int i = 0; i < W; ++i) acc[f][i] *= inv;
        store_row<Q, D>(a.out[f] + b * a.osb + s * a.old + hc, rot, acc[f]);
      }
    }
  }
}

// The launch's shape: tokens of an item, its stages from DA_SMEM or
// DA_SMEM_Q8. Up to C = 2048 an item holds all C channels of its tokens
// (groups 1, cg = C); past it the heads split into the fewest equal groups
// of at most DA_MAX_ROWS * 8 = 2048 channels (C = 2304, 3072, 4096: two of
// C / 2; 2080, 65 heads of 32: five of 416; 3968 in 31 heads of 128: 31 of
// 128), and the rule below is cg's. An item holds ts tokens of rw = cg / 32
// rows: DA_ROWS rows'
// worth rounded down to a multiple of 4 tokens, at least 4, as at every C
// % 256 == 0, whose rows are then whole warps. At another C % 32 == 0 the
// consumers count whole warps on the barriers, so: the next multiple of 4
// tokens whose rows are whole warps, where they fit DA_MAX_ROWS (C = 96:
// 32 tokens, 96 rows; 320: 16, 160; 384: 8, 96; 640: 8, 160); else the
// same ts, its rows rounded up to a warp of idle lanes (C = 1152: 4
// tokens, 144 rows on 160 lanes; 1600: 4, 200 on 224). A head row of D
// channels is D / 32 neighbouring rows of one token, never across a warp:
// with D dividing C, a token's rows start at a multiple of D / 32. At head
// dim 72 rows of 24 channels, a head three of them, ten heads a warp: the
// same rule counts heads by tens (C = 1152: 4 tokens, 64 heads on 7 warps,
// 224 lanes; 2016: 4, 112 on 12, 384).
inline DecodePlan decode_plan(int frames, int S, int C_all, bool q8, int D) {
  DecodePlan p{};
  p.groups = 1;
  for (const int heads = C_all / D; C_all / p.groups > 8 * DA_MAX_ROWS ||
                                    heads % p.groups;)
    ++p.groups;
  const int C = p.cg = C_all / p.groups;
  if (D == 72) {
    const int heads = C / 72;
    p.ts = (DA_ROWS * 24 / C) & ~3;
    if (p.ts < 4) p.ts = 4;
    for (int ts = p.ts + 4;
         p.ts * heads % 10 && (ts * heads + 9) / 10 * 32 <= DA_MAX_LANES_72;
         ts += 4)
      if (ts * heads % 10 == 0) p.ts = ts;
    p.rows = p.ts * (C / 24);
    p.lanes = (p.ts * heads + 9) / 10 * 32;
  } else {
    const int rw = C / 32;
    p.ts = (DA_ROWS * 32 / C) & ~3;
    if (p.ts < 4) p.ts = 4;
    for (int ts = p.ts + 4; p.ts * rw % 32 && ts * rw <= DA_MAX_ROWS;
         ts += 4)
      if (ts * rw % 32 == 0) p.ts = ts;
    p.rows = p.ts * rw;
    p.lanes = (p.rows + 31) & ~31;
  }
  p.tiles = (S + p.ts - 1) / p.ts * p.groups;
  p.tile_bytes = (uint32_t)p.ts * C * (q8 ? 1 : 2);
  p.stage_bytes = 2 * p.tile_bytes + (q8 ? 8 * p.ts : 0);
  p.io_bytes = 3 * frames * p.ts * C * 2;
  p.stages = ((q8 ? DA_SMEM_Q8 : DA_SMEM) - DA_IO - (int)p.io_bytes) /
             (int)p.stage_bytes;
  if (p.stages < 2) p.stages = 2;
  if (p.stages > DA_MAX_STAGES) p.stages = DA_MAX_STAGES;
  return p;
}

template <int F, bool Q, int D, bool WIDE>
static cudaError_t launch_ring(const DecodeAttnArgs& a, const DecodePlan& p,
                               cudaStream_t s) {
  const long items = (long)a.nb * p.tiles;
  if (items == 0) return cudaSuccess;
  const int threads = p.lanes + 32;
  const int smem = DA_IO + p.io_bytes + p.stages * (int)p.stage_bytes;
  // the shared-memory limit and the resident blocks, set again when the
  // shape (C) changes
  static int key_threads = -1, key_smem = -1, resident = 0;
  if (threads != key_threads || smem != key_smem) {
    TPU1X_TRY(resident_blocks(decode_ring_kernel<F, Q, D, WIDE>, threads,
                              smem, &resident));
    key_threads = threads, key_smem = smem;
  }
  const int grid = items < resident ? (int)items : resident;
  decode_ring_kernel<F, Q, D, WIDE><<<grid, threads, smem, s>>>(a, p);
  return cudaGetLastError();
}

// The form of F frames and cache type for head_dim D (and at head_dim 72
// past DA_THREADS threads, the WIDE one).
template <int D, bool WIDE = false>
static cudaError_t launch_forms(const DecodeAttnArgs& a, const DecodePlan& p,
                                int frames, bool q8, cudaStream_t s) {
  if constexpr (D == 72 && !WIDE)
    if (p.lanes + 32 > DA_THREADS)
      return launch_forms<72, true>(a, p, frames, q8, s);
  if (q8)
    return frames == 1 ? launch_ring<1, true, D, WIDE>(a, p, s)
                       : launch_ring<2, true, D, WIDE>(a, p, s);
  return frames == 1 ? launch_ring<1, false, D, WIDE>(a, p, s)
                     : launch_ring<2, false, D, WIDE>(a, p, s);
}

// Rows b0 .. b0 + nb of `a`: every per-row pointer moved to row b0, the
// caches and scales by b0 of their B rows (B stays their stride).
inline DecodeAttnArgs decode_rows(const DecodeAttnArgs& a, int frames, int b0,
                                  int nb) {
  DecodeAttnArgs r = a;
  r.nb = nb;
  for (int f = 0; f < frames; ++f) {
    r.q[f] += b0 * a.sb[0];
    r.k[f] += b0 * a.sb[1];
    r.v[f] += b0 * a.sb[2];
    r.out[f] += b0 * a.osb;
  }
  const long rows = (long)b0 * a.S * a.C;  // elements of b0 (S, C) rows
  if (a.k_out != nullptr) r.k_out += rows, r.v_out += rows;
  const long elt = a.ksc != nullptr ? 1 : 2;
  r.kc = static_cast<const uint8_t*>(a.kc) + rows * elt;
  r.vc = static_cast<const uint8_t*>(a.vc) + rows * elt;
  if (a.ksc != nullptr) {
    r.ksc += (long)b0 * a.T * a.S;
    r.vsc += (long)b0 * a.T * a.S;
  }
  r.t_B += b0;
  return r;
}

// The widths the ring takes (`decode_plan`): head_dim D of 32, 64, 72 or
// 128, C a multiple of D (so of 32, or of 24 at head_dim 72, and a head row
// never across a warp) and at most MAX_C = 4096 (an item holds at least 4
// tokens of a head group's cg / 32 rows, cg <= 8 DA_MAX_ROWS = 2048); at
// head_dim 72 at most 8 DA_MAX_ROWS, so C <= 2016 (one group, C / 24 rows
// on at most DA_MAX_LANES_72 lanes). tpu1x_torch/ops/_util.py
// `decode_width_ok` states the same rule.
inline bool decode_width_ok(int C, int D) {
  return (D == 32 || D == 64 || D == 72 || D == 128) && C > 0 &&
         C % D == 0 && C <= (D == 72 ? 8 * DA_MAX_ROWS : MAX_C);
}

// Requires frames in {1, 2}, T <= DA_MAXT, a width that decode_width_ok
// takes, 0 <= layer < L, 16-byte aligned caches; an int8 cache
// (a.ksc not null) also its v scales, S % 4 == 0 and 16-byte aligned
// scales (each item's scales are bulk copies of whole 16-byte units). Any
// B: one launch per DA_MAX_B rows.
static inline cudaError_t launch_decode_attention(const DecodeAttnArgs& a,
                                                  int frames, cudaStream_t s) {
  const bool q8 = a.ksc != nullptr;
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if ((frames != 1 && frames != 2) || a.T > DA_MAXT ||
      !decode_width_ok(a.C, a.D) || a.layer < 0 || a.layer >= a.L ||
      misaligned(a.kc) || misaligned(a.vc) ||
      (q8 && (a.vsc == nullptr || a.S % 4 || misaligned(a.ksc) ||
              misaligned(a.vsc))))
    return cudaErrorInvalidValue;
  const DecodePlan p = decode_plan(frames, a.S, a.C, q8, a.D);
  for (int b0 = 0; b0 < a.B; b0 += DA_MAX_B) {
    const DecodeAttnArgs r =
        decode_rows(a, frames, b0, a.B - b0 < DA_MAX_B ? a.B - b0 : DA_MAX_B);
    TPU1X_TRY(a.D == 32   ? launch_forms<32>(r, p, frames, q8, s)
              : a.D == 64 ? launch_forms<64>(r, p, frames, q8, s)
              : a.D == 72 ? launch_forms<72>(r, p, frames, q8, s)
                          : launch_forms<128>(r, p, frames, q8, s));
  }
  return cudaSuccess;
}

}  // namespace tpu1x
