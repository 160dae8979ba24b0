// C = epilogue(A B) on the tensor cores of Hopper: row-major bf16 A (M, K),
// B (K, N) and C (M, N), fp32 accumulators, and the serving chain of
// csrc/common.cuh's GEMM_NN as the epilogue: round to bf16, + bias
// (rounded), GELU (rounded), + residual (rounded). It carries the weight
// products of the spatial block (K1: qkv, proj) and of the temporal+MLP
// block (K2 and K3: qkv, proj, fc1 with the GELU, fc2); the training
// kernels keep common.cuh's mma.sync GEMM. The GELU, tanh or exact erf, is
// a template parameter of the kernel, so the instantiation without it
// compiles to the code it had before the GELU existed (one epilogue for
// every use once cost the rollout 5%).
//
// Bound on the H100: tensor-core operations for K1's products (2 M K N
// FLOP against (M K + K N + 2 M N) bf16 values: at M = 4096, K = 512,
// N = 1536, 6.4 GFLOP, 0.0065 ms at 989 TFLOP/s, against 18.4 MB, 0.0055 ms
// at 3.35 TB/s); the products must reach the card's rate, which only wgmma
// fed by TMA does. The design:
// - persistent blocks walk output tiles of 128 x 64, tile blockIdx.x,
//   + gridDim.x, ..., n fastest, so that the blocks that run together share
//   A's rows and B stays in L2;
// - one thread of a producer warp loads, per 64-deep step of K, the A tile
//   (128 x 64, K-major) and the B tile (64 x 64) by TMA in the 128-byte
//   swizzle into a ring of G9_STAGES stages, each with a full and an empty
//   mbarrier; it runs ahead of the consumers across tiles, so the next
//   tile's loads overlap this tile's epilogue;
// - two consumer warpgroups each own 64 rows of the tile and issue wgmma
//   m64n64k16 (A K-major; B row-major, which is MN-major for wgmma: the
//   transposed flag; its lbo, the bytes between 64-column atoms, is unused
//   at this width), four k16 steps a stage, keeping one stage's group in
//   flight and releasing the stage before it;
// - the epilogue works on the accumulator registers and stores bf16 pairs;
//   the GELU applies the JAX serving chain's gelu(dense(h, w, b)): the
//   product rounded, + bias rounded, GELU in fp32 rounded.
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
// memory a block (four 24 KB stages): two blocks an SM. On K2's MLP
// products (4096 rows, C = 512, F4 = 2048; device time on an NVIDIA H100
// 80GB HBM3 at 700 W, chip_smoke.py's gemm_sm90 phase) fc1 with the GELU
// runs at 210-218 TFLOP/s, fc2 (K = 2048) at 381-383.
//
// Requires N % 64 == 0, K % 64 == 0, 16-byte aligned rows; any M (TMA fills
// the rows past M with zeros, and the epilogue skips them).

#pragma once

#include "sm90.cuh"

namespace tpu1x {

constexpr int G9_BM = 128, G9_BN = 64, G9_BK = 64, G9_STAGES = 4;
// two consumer warpgroups (threads 0-255) and a producer warp
constexpr int G9_THREADS = 288;

// d (64 x 64, fp32) {=, +=} A (64 x 16) B (16 x 64): A from shared memory,
// K-major; B from shared memory, MN-major (the transposed flag); acc 0
// overwrites d.
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}
constexpr int G9_A_BYTES = G9_BM * G9_BK * 2;  // 16 KB
constexpr int G9_B_BYTES = G9_BK * G9_BN * 2;  // 8 KB
constexpr int G9_STAGE = G9_A_BYTES + G9_B_BYTES;
// 1 KB to align the ring on the 128-byte swizzle's repeat, the stages,
// their full and empty mbarriers
constexpr int G9_SMEM = 1024 + G9_STAGES * G9_STAGE + 2 * 8 * G9_STAGES;

struct Gemm90Args {
  bf16* C;            // (M, N)
  const bf16* bias;   // (N,) or null
  const bf16* resid;  // (M, N) or null
  int M, N, K;
};

// ta: A (M, K) in boxes of 64 x 128; tb: B (K, N) in boxes of 64 x 64;
// both 128-byte swizzle. grid: the tiles or the resident blocks, whichever
// are fewer. ACT: ACT_NONE, ACT_GELU_TANH or ACT_GELU_ERF.
template <int ACT>
__global__ void __launch_bounds__(G9_THREADS)
    gemm90_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb, Gemm90Args p) {
  extern __shared__ unsigned char g9_raw[];
  const uint32_t raw = smem_u32(g9_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t full = ring + G9_STAGES * G9_STAGE;
  const uint32_t empty = full + 8 * G9_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;  // 2: the producer warp
  const int n_tiles = p.N / G9_BN;
  const int tiles = (p.M + G9_BM - 1) / G9_BM * n_tiles;
  const int steps = p.K / G9_BK;

  if (tid == 0) {
    for (int s = 0; s < G9_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread
    if (tid != 256) return;
    int s = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * G9_BM, n0 = tile % n_tiles * G9_BN;
      for (int k = 0; k < steps; ++k) {
        mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t dst = ring + s * G9_STAGE, bar = full + 8 * s;
        mbar_expect_tx(bar, G9_STAGE);
        tma_load_2d(dst, &ta, k * G9_BK, m0, bar);
        tma_load_2d(dst + G9_A_BYTES, &tb, n0, k * G9_BK, bar);
        if (++s == G9_STAGES) s = 0, ph ^= 1;
      }
    }
    return;
  }

  // a consumer: rows 64 wg .. + 63 of each tile
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  const int row_off = wg * 64;
  int s = 0;
  uint32_t ph = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * G9_BM, n0 = tile % n_tiles * G9_BN;
    // acc[4 j + e]: row warp 16 + g + 8 (e >> 1), column 8 j + 2 t4 + (e & 1)
    float acc[G9_BN / 2];
    int prev = -1;
    for (int k = 0; k < steps; ++k) {
      mbar_wait(full + 8 * s, ph);
      const uint32_t a = ring + s * G9_STAGE + row_off * 128;
      const uint32_t b = ring + s * G9_STAGE + G9_A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_n64(acc, gmma_desc(a + 32 * kk, 1024, 16, GMMA_SWIZZLE_128B),
                  gmma_desc(b + 2048 * kk, 1024, 8192, GMMA_SWIZZLE_128B),
                  k | kk);
      wgmma_commit();
      // the step before has finished reading its stage
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == G9_STAGES) s = 0, ph ^= 1;
    }
    wgmma_wait<0>();
    hold(acc);
    if (lane == 0) mbar_arrive(empty + 8 * prev);

#pragma unroll
    for (int j = 0; j < G9_BN / 8; ++j) {
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
  }
}

// One instantiation's launch; `resident` is kept for each, since two
// instantiations need not have the same occupancy. `static`: an `inline`
// launcher's static would be shared by every library of the process that
// includes this header.
template <int ACT>
static cudaError_t launch_gemm90_act(const CUtensorMap& ta,
                                     const CUtensorMap& tb, const Gemm90Args& a,
                                     int tiles, cudaStream_t stream) {
  // the blocks the card keeps resident, found once a process
  static int resident = 0;
  if (resident == 0)
    TPU1X_TRY(resident_blocks(gemm90_kernel<ACT>, G9_THREADS, G9_SMEM,
                              &resident));
  gemm90_kernel<ACT><<<tiles < resident ? tiles : resident, G9_THREADS,
                       G9_SMEM, stream>>>(ta, tb, a);
  return cudaGetLastError();
}

// C = epilogue(A B) with A (M, K), B (K, N), C and resid (M, N) contiguous
// bf16, bias (N,) bf16 or null, resid null or not, act one of ACT_NONE,
// ACT_GELU_TANH, ACT_GELU_ERF.
static inline cudaError_t launch_gemm90(const void* A, const void* B,
                                        void* C, const void* bias,
                                        const void* resid, int M, int N, int K,
                                        cudaStream_t stream,
                                        int act = ACT_NONE) {
  if (N % G9_BN || K % G9_BK || M < 0 ||
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
               static_cast<const bf16*>(resid), M, N, K};
  const int tiles = (M + G9_BM - 1) / G9_BM * (N / G9_BN);
  if (act == ACT_GELU_TANH)
    return launch_gemm90_act<ACT_GELU_TANH>(ta, tb, a, tiles, stream);
  if (act == ACT_GELU_ERF)
    return launch_gemm90_act<ACT_GELU_ERF>(ta, tb, a, tiles, stream);
  return launch_gemm90_act<ACT_NONE>(ta, tb, a, tiles, stream);
}

}  // namespace tpu1x
