// Shared device code of the port's kernels: bf16 helpers, the Hopper
// warp-level tensor-core primitives (ldmatrix, mma.sync m16n8k16, cp.async),
// and one tiled bf16 GEMM with fp32 accumulators that the training kernels
// (K11-K13, csrc/train_block.cu) use for their weight products. The serving
// blocks (K1, K2, K3) run theirs on csrc/gemm_sm90.cuh (TMA, wgmma).
//
// The GEMM computes C = epilogue(prologue(A) @ B) for row-major A (M, K),
// B (K, N) and C (M, N), all bf16 (form GEMM_NN). Two more forms of the same
// kernel serve the training backward:
//   GEMM_NT  C = A @ B^T with B stored (N, K) row-major (dx and the hidden
//            gradients: do Wproj^T, dqkv Wqkv^T, do Wfc2^T, d_h Wfc1^T);
//   GEMM_TN  C += A^T @ B with A stored (K, M) and B (K, N) row-major, the
//            reduction over the K rows split over blockIdx.z and combined
//            with fp32 atomic adds into a zeroed fp32 C (the weight
//            gradients, which sum all N*S rows; the order of the adds, and
//            so the last bits, differ from run to run).
// For GEMM_NN:
//   prologue  optional LayerNorm of each row of A over K (fp32 statistics,
//             variance E[x^2] - E[x]^2, result rounded to bf16), as the JAX
//             package's pre-LN does before its products;
//   epilogue  round to bf16, then each of: + bias (rounded), GELU (tanh or
//             erf, rounded), + residual (rounded): the rounding steps of the
//             JAX serving path's dot -> astype -> add chain. With `fused`
//             the chain is the training kernels': fp32 accumulator + bias,
//             GELU (or times GELU'(aux), the MLP backward), one rounding,
//             then + residual (rounded); `C2`, if given, receives the
//             rounded pre-activation. With `Cf` the fp32 accumulators are
//             stored (or atomically added) as they are and nothing else
//             applies.
// Tiles are 128 x 64 x 32 with two cp.async stages; 8 warps each own a
// 32 x 32 piece of the output as 2 x 4 mma tiles. Bound on the H100: the
// tensor cores for the large products (K = 512 or 2048 at the GENIE widths);
// it uses mma.sync, not wgmma/TMA, so it reaches a fraction of the 989
// TFLOP/s peak; moving K11-K13 onto csrc/gemm_sm90.cuh is still to do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpu1x {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the 4 lanes (xor 1, 2) that share one 32-channel head when each
// lane holds 8 channels.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Two floats as one bf16x2 register: `lo` in the low half, the element with
// the smaller column index in the mma fragments.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float gelu(float x, int act) {
  if (act == 1) {  // tanh approximation, jax.nn.gelu(approximate=True)
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
  }
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));  // exact
}

// d gelu(x) / dx for the same two forms. Both use erff itself: the TPU MLP
// kernel's rational erf stands in for an erf that its compiler lacks, and is
// not copied.
__device__ __forceinline__ float dgelu(float x, int tanh_form) {
  if (tanh_form) {
    const float k = 0.7978845608028654f;
    const float th = tanhf(k * (x + 0.044715f * x * x * x));
    const float du = k * (1.f + 3.f * 0.044715f * x * x);
    return 0.5f * (1.f + th) + 0.5f * x * (1.f - th * th) * du;
  }
  const float phi = __expf(-0.5f * x * x) * 0.3989422804014327f;
  return 0.5f * (1.f + erff(x * 0.7071067811865476f)) + x * phi;
}

enum { ACT_NONE = 0, ACT_GELU_TANH = 1, ACT_GELU_ERF = 2,
       ACT_DGELU_TANH = 3, ACT_DGELU_ERF = 4 };
enum { GEMM_NN = 0, GEMM_NT = 1, GEMM_TN = 2 };

struct GemmParams {
  const bf16* A;
  long lda;
  const bf16* B;  // (K, N) row-major: the JAX package's (in, out) kernels
  long ldb;
  bf16* C;
  long ldc;
  const bf16* bias;      // (N,) or null
  const bf16* resid;     // (M, N) or null
  long ldr;
  const float* ln_scale;  // (K,) or null: LayerNorm prologue on A's rows
  const float* ln_bias;
  int M, N, K;
  int act;
  float eps;
  // training forms (all zero or null on the serving path)
  int fused;        // 1: the training kernels' rounding chain (see above)
  const bf16* aux;  // (M, N) pre-activation for ACT_DGELU_*
  long ld_aux;
  bf16* C2;         // (M, N), ldc: rounded pre-activation, or null
  float* Cf;        // fp32 output instead of C, ldc; GEMM_TN adds atomically
  int k_chunk;      // GEMM_TN: rows of the reduction per blockIdx.z
};

constexpr int GBM = 128, GBN = 64, GBK = 32, GTHREADS = 256;
constexpr int G_ALD = GBK + 8;  // padded rows: ldmatrix reads hit 8 banks
constexpr int G_BLD = GBN + 8;
constexpr int G_TLD = GBM + 8;  // GEMM_TN keeps its A tile as (GBK, GBM)
constexpr int G_ASZ = GBM * G_ALD;  // >= GBK * G_TLD
constexpr int G_BSZ = GBN * G_ALD;  // >= GBK * G_BLD; GEMM_NT keeps (GBN, GBK)

// Requires N % 64 == 0, K % 32 == 0, 16-byte aligned rows; any M (GEMM_TN:
// M % 8 == 0 and k_chunk % 32 == 0). The LN prologue is for GEMM_NN only.
// TRAIN compiles the training epilogues (`fused`, `Cf`) in; without it the
// kernel is the serving path's alone, whose code the training forms must not
// slow down (the one epilogue for both cost the rollout 5%).
template <int MODE, bool TRAIN>
__global__ void __launch_bounds__(GTHREADS) gemm_kernel(GemmParams p) {
  __shared__ __align__(16) bf16 As[2][G_ASZ];
  __shared__ __align__(16) bf16 Bs[2][G_BSZ];
  __shared__ float mu_s[GBM], rs_s[GBM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bm = blockIdx.y * GBM, bn = blockIdx.x * GBN;
  const bool ln = MODE == GEMM_NN && p.ln_scale != nullptr;
  int kbase = 0, kend = p.K;
  if (MODE == GEMM_TN) {
    kbase = blockIdx.z * p.k_chunk;
    kend = min(p.K, kbase + p.k_chunk);
    if (kend <= kbase) return;
  }

  if (ln) {  // row statistics over the whole K axis, one warp per row
    for (int r = warp; r < GBM; r += GTHREADS / 32) {
      const int row = bm + r;
      float s = 0.f, ss = 0.f;
      if (row < p.M) {
        const bf16* a = p.A + (long)row * p.lda;
        for (int k = lane * 8; k < p.K; k += 256) {
          float f[8];
          load8(a + k, f);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            s += f[i];
            ss += f[i] * f[i];
          }
        }
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      if (lane == 0) {
        const float mu = s / p.K;
        mu_s[r] = mu;
        rs_s[r] = rsqrtf(ss / p.K - mu * mu + p.eps);
      }
    }
    __syncthreads();
  }

  auto load_tile = [&](int kt, int st) {
    const int k0 = kbase + kt * GBK;
    if (MODE == GEMM_TN) {  // A is (K, M): a (GBK, GBM) tile, m contiguous
      for (int c = tid; c < GBK * GBM / 8; c += GTHREADS) {
        const int r = c >> 4, mc = (c & 15) * 8;
        const bool ok = bm + mc < p.M;
        cp_async16(&As[st][r * G_TLD + mc],
                   p.A + (long)(k0 + r) * p.lda + (ok ? bm + mc : 0), ok);
      }
    } else {
      for (int c = tid; c < GBM * GBK / 8; c += GTHREADS) {
        const int r = c >> 2, kc = (c & 3) * 8, row = bm + r;
        const bool ok = row < p.M;
        cp_async16(&As[st][r * G_ALD + kc],
                   p.A + (long)(ok ? row : 0) * p.lda + k0 + kc, ok);
      }
    }
    if (MODE == GEMM_NT) {  // B is (N, K): a (GBN, GBK) tile, k contiguous
      for (int c = tid; c < GBN * GBK / 8; c += GTHREADS) {
        const int r = c >> 2, kc = (c & 3) * 8;
        cp_async16(&Bs[st][r * G_ALD + kc],
                   p.B + (long)(bn + r) * p.ldb + k0 + kc, true);
      }
    } else {
      for (int c = tid; c < GBK * GBN / 8; c += GTHREADS) {
        const int r = c >> 3, nc = (c & 7) * 8;
        cp_async16(&Bs[st][r * G_BLD + nc],
                   p.B + (long)(k0 + r) * p.ldb + bn + nc, true);
      }
    }
  };
  // Each thread normalises the A chunks it copied itself, so its own
  // cp.async wait is all the ordering this needs.
  auto norm_tile = [&](int kt, int st) {
    const int k0 = kt * GBK;
    for (int c = tid; c < GBM * GBK / 8; c += GTHREADS) {
      const int r = c >> 2, kc = (c & 3) * 8;
      bf16* e = &As[st][r * G_ALD + kc];
      float f[8];
      load8(e, f);
      const float mu = mu_s[r], rs = rs_s[r];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        f[i] = (f[i] - mu) * rs * p.ln_scale[k0 + kc + i] + p.ln_bias[k0 + kc + i];
      store8(e, f);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int KT = (kend - kbase) / GBK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < KT) {
      load_tile(kt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (ln) norm_tile(kt, st);
    __syncthreads();
    uint32_t bt[4][4];  // GEMM_NT: both k16 steps of each 8-column tile
    if (MODE == GEMM_NT) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        ldmatrix_x4(bt[nt], &Bs[st][(wn + nt * 8 + (lane & 7)) * G_ALD +
                                    (lane >> 3) * 8]);
    }
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (MODE == GEMM_TN)
          ldmatrix_x4_trans(
              a[mt], &As[st][(kk + (lane & 7) + ((lane >> 4) & 1) * 8) * G_TLD +
                             wm + mt * 16 + ((lane >> 3) & 1) * 8]);
        else
          ldmatrix_x4(a[mt], &As[st][(wm + mt * 16 + (lane & 15)) * G_ALD + kk +
                                     (lane >> 4) * 8]);
      }
      if (MODE == GEMM_NT) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          b[nt][0] = bt[nt][kk / 8];
          b[nt][1] = bt[nt][kk / 8 + 1];
        }
      } else {
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          uint32_t r[4];
          ldmatrix_x4_trans(
              r, &Bs[st][(kk + (lane & 7) + ((lane >> 3) & 1) * 8) * G_BLD + wn +
                         nb * 16 + (lane >> 4) * 8]);
          b[nb * 2][0] = r[0];
          b[nb * 2][1] = r[1];
          b[nb * 2 + 1][0] = r[2];
          b[nb * 2 + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = bm + wm + mt * 16 + g + h * 8;
        const int col = bn + wn + nt * 8 + t4 * 2;
        if (row >= p.M) continue;
        if (TRAIN && p.Cf) {  // fp32 accumulators as they are
          float* o = p.Cf + (long)row * p.ldc + col;
          if (MODE == GEMM_TN) {
            atomicAdd(o, acc[mt][nt][2 * h]);
            atomicAdd(o + 1, acc[mt][nt][2 * h + 1]);
          } else {
            *reinterpret_cast<float2*>(o) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          }
          continue;
        }
        float v[2] = {acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]};
        float r[2] = {0.f, 0.f};
        if (p.resid) {
          const float2 rr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              p.resid + (long)row * p.ldr + col));
          r[0] = rr.x;
          r[1] = rr.y;
        }
        if (TRAIN) {
          float x[2] = {0.f, 0.f};
          if (p.aux) {
            const float2 xx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                p.aux + (long)row * p.ld_aux + col));
            x[0] = xx.x;
            x[1] = xx.y;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (p.bias) v[e] += __bfloat162float(p.bias[col + e]);
          if (p.C2)
            *reinterpret_cast<uint32_t*>(p.C2 + (long)row * p.ldc + col) =
                pack_bf16(v[0], v[1]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (p.act == ACT_GELU_TANH || p.act == ACT_GELU_ERF)
              v[e] = gelu(v[e], p.act);
            else if (p.act == ACT_DGELU_TANH || p.act == ACT_DGELU_ERF)
              v[e] *= dgelu(x[e], p.act == ACT_DGELU_TANH);
            v[e] = bf16r(v[e]);
            if (p.resid) v[e] = bf16r(r[e] + v[e]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = bf16r(v[e]);
            if (p.bias) v[e] = bf16r(v[e] + __bfloat162float(p.bias[col + e]));
            if (p.act != ACT_NONE) v[e] = bf16r(gelu(v[e], p.act));
            if (p.resid) v[e] = bf16r(r[e] + v[e]);
          }
        }
        *reinterpret_cast<uint32_t*>(p.C + (long)row * p.ldc + col) =
            pack_bf16(v[0], v[1]);
      }
}

// `mode` is one of GEMM_NN, GEMM_NT, GEMM_TN. GEMM_NT and GEMM_TN are
// training forms: they need `fused` or `Cf`, and GEMM_TN needs Cf (zeroed by
// the caller, on the same stream) and k_chunk.
inline cudaError_t launch_gemm(const GemmParams& p, cudaStream_t s,
                               int mode = GEMM_NN) {
  dim3 grid(p.N / GBN, (p.M + GBM - 1) / GBM);
  const bool train = p.fused || p.Cf;
  if (!train && (mode != GEMM_NN || p.aux || p.C2))
    return cudaErrorInvalidValue;
  if (mode == GEMM_NN) {
    if (train)
      gemm_kernel<GEMM_NN, true><<<grid, GTHREADS, 0, s>>>(p);
    else
      gemm_kernel<GEMM_NN, false><<<grid, GTHREADS, 0, s>>>(p);
  } else if (mode == GEMM_NT) {
    if (p.ln_scale) return cudaErrorInvalidValue;
    gemm_kernel<GEMM_NT, true><<<grid, GTHREADS, 0, s>>>(p);
  } else {
    if (p.ln_scale || !p.Cf || p.k_chunk <= 0 || p.k_chunk % GBK || p.M % 8)
      return cudaErrorInvalidValue;
    grid.z = (p.K + p.k_chunk - 1) / p.k_chunk;
    gemm_kernel<GEMM_TN, true><<<grid, GTHREADS, 0, s>>>(p);
  }
  return cudaGetLastError();
}

// Defaults for GEMM_NN on contiguous operands; the other forms set their
// leading dimensions themselves.
inline GemmParams gemm_params(const void* A, const void* B, void* C, int M,
                              int N, int K) {
  GemmParams p{};
  p.A = static_cast<const bf16*>(A);
  p.lda = K;
  p.B = static_cast<const bf16*>(B);
  p.ldb = N;
  p.C = static_cast<bf16*>(C);
  p.ldc = N;
  p.ldr = N;
  p.ld_aux = N;
  p.M = M;
  p.N = N;
  p.K = K;
  p.act = ACT_NONE;
  p.eps = 1e-5f;
  return p;
}

}  // namespace tpu1x

#define TPU1X_TRY(expr)                 \
  do {                                  \
    cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)
