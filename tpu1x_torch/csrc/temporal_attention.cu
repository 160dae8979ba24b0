// Attention over the frame axis of q, k, v shaped (B, T, S, C), causal or
// not, heads flat in C (head_dim 32), computed in that layout with no
// transpose; forward, and backward (dq, dk, dv).
//
// Replaces the Pallas kernels of tpu1x/ops/temporal_attention.py: the forward
// (_temporal_fwd -> _fwd_kernel) and the backward (_temporal_bwd ->
// _bwd_kernel). The TPU kernel reduced each head's dot
// products through a 0/1 head matrix on the MXU, a lane trick; here four
// lanes hold one head's 32 channels (8 each, 16-byte loads) and reduce with
// two shuffles. One block per (b, s): 64 threads cover C=512. Bound on the
// H100: device memory (q, k, v read once, out written once: 4 B T S C bytes,
// 134 MB at the prefill's B=16, T=8); the T <= 16 logits of a query stay in
// registers, and the re-reads of k and v for later queries hit L1.
// Probabilities are rounded to bf16 before the PV sum, as the reference does.
//
// The backward recomputes the probabilities of each query frame from q and k
// (fp32 softmax), forms ds = p (dp - sum p dp) and rounds p and ds to bf16
// before the products. dk and dv sum over the query frames, so p and ds of
// all (query, key) frame pairs wait in shared memory, (T, T) bf16 per head,
// for a second pass over the key frames. Bound: device memory (q, k, v, dout
// read once, dq, dk, dv written once: 7 B T S C elements); the re-reads of
// the block's 4 T rows hit L1 or L2.

#include "common.cuh"

using namespace tpu1x;

namespace {

constexpr int TA_MAXT = 16;

// element (b, t, s, c) of q/k/v at ((b*T + t)*S + s)*ld + c; out contiguous.
__global__ void temporal_attention_kernel(const bf16* __restrict__ q,
                                          const bf16* __restrict__ k,
                                          const bf16* __restrict__ v,
                                          bf16* __restrict__ out, int T, int S,
                                          int C, int ld, float scale,
                                          int causal) {
  const int s = blockIdx.x, b = blockIdx.y, c0 = threadIdx.x * 8;
  auto at = [&](int t) { return ((long)(b * T + t) * S + s) * ld + c0; };
  for (int t = 0; t < T; ++t) {
    float qf[8];
    load8(q + at(t), qf);
    const int kmax = causal ? t + 1 : T;
    float lg[TA_MAXT];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < TA_MAXT; ++j) {
      if (j < kmax) {
        float kf[8];
        load8(k + at(j), kf);
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d += qf[i] * kf[i];
        lg[j] = quad_sum(d) * scale;
        m = fmaxf(m, lg[j]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < TA_MAXT; ++j) {
      if (j < kmax) {
        lg[j] = __expf(lg[j] - m);
        sum += lg[j];
      }
    }
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < TA_MAXT; ++j) {
      if (j < kmax) {
        const float p = bf16r(lg[j] / sum);
        float vf[8];
        load8(v + at(j), vf);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += p * vf[i];
      }
    }
    store8(out + ((long)(b * T + t) * S + s) * C + c0, acc);
  }
}

// q/k/v rows at stride ld, dout at ld_do, dq/dk/dv at ld_out (so that the
// three gradients can be column slices of one (B, T, S, 3C) tensor).
// grid (S, B, ceil(C / 512)), min(C, 512) / 8 threads: a block covers up to
// 16 heads of one (b, s), four lanes to a head as in the forward.
//   1  per query frame t: the logits and dp = dout_t . v_j of every key
//      frame in registers, softmax, ds = p (dp - sum p dp), then
//      dq_t = scale sum_j ds k_j; p and ds, rounded to bf16, go to shared
//      memory as a (T, T) tile per head;
//   2  per key frame j: dk_j = scale sum_t ds[t][j] q_t and
//      dv_j = sum_t p[t][j] dout_t from those tiles, eight sums per thread.
// A head's tile is written and read by lanes of one warp, so a warp
// barrier orders the two phases.
constexpr int TAB_HEADS = 16;  // heads per block

__global__ void __launch_bounds__(TAB_HEADS * 4) temporal_attention_bwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int T,
    int S, int C, int ld, int ld_do, int ld_out, float scale, int causal) {
  __shared__ bf16 p_s[TAB_HEADS][TA_MAXT * TA_MAXT];
  __shared__ bf16 ds_s[TAB_HEADS][TA_MAXT * TA_MAXT];
  const int s = blockIdx.x, b = blockIdx.y;
  const int c0 = blockIdx.z * TAB_HEADS * 32 + threadIdx.x * 8;
  if (c0 >= C) return;  // a whole warp: C is a multiple of 256
  const int head = threadIdx.x >> 2;
  const bool writer = (threadIdx.x & 3) == 0;
  auto row = [&](int t) { return (long)(b * T + t) * S + s; };

  for (int t = 0; t < T; ++t) {
    float qf[8], df[8];
    load8(q + row(t) * ld + c0, qf);
    load8(dout + row(t) * ld_do + c0, df);
    const int kmax = causal ? t + 1 : T;
    float lg[TA_MAXT], dp[TA_MAXT];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < TA_MAXT; ++j) {
      if (j < kmax) {
        float kf[8], vf[8];
        load8(k + row(j) * ld + c0, kf);
        load8(v + row(j) * ld + c0, vf);
        float a = 0.f, d = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          a += qf[i] * kf[i];
          d += df[i] * vf[i];
        }
        lg[j] = quad_sum(a) * scale;
        dp[j] = quad_sum(d);
        m = fmaxf(m, lg[j]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < TA_MAXT; ++j) {
      if (j < kmax) {
        lg[j] = __expf(lg[j] - m);
        sum += lg[j];
      }
    }
    float delta = 0.f;
#pragma unroll
    for (int j = 0; j < TA_MAXT; ++j) {
      if (j < kmax) {
        lg[j] = lg[j] / sum;
        delta += lg[j] * dp[j];
      }
    }
    float dqa[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < TA_MAXT; ++j) {
      if (j < kmax) {
        const bf16 ds = __float2bfloat16(lg[j] * (dp[j] - delta));
        if (writer) {
          p_s[head][t * TA_MAXT + j] = __float2bfloat16(lg[j]);
          ds_s[head][t * TA_MAXT + j] = ds;
        }
        const float dsf = __bfloat162float(ds) * scale;
        float kf[8];
        load8(k + row(j) * ld + c0, kf);
#pragma unroll
        for (int i = 0; i < 8; ++i) dqa[i] += dsf * kf[i];
      }
    }
    store8(dq + row(t) * ld_out + c0, dqa);
  }
  __syncwarp();

  for (int j = 0; j < T; ++j) {
    float dka[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float dva[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int t = causal ? j : 0; t < T; ++t) {
      float qf[8], df[8];
      load8(q + row(t) * ld + c0, qf);
      load8(dout + row(t) * ld_do + c0, df);
      const float p = __bfloat162float(p_s[head][t * TA_MAXT + j]);
      const float ds = __bfloat162float(ds_s[head][t * TA_MAXT + j]) * scale;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dka[i] += ds * qf[i];
        dva[i] += p * df[i];
      }
    }
    store8(dk + row(j) * ld_out + c0, dka);
    store8(dv + row(j) * ld_out + c0, dva);
  }
}

}  // namespace

// Requires T <= 16, C % 256 == 0 (whole warps of 4-lane heads), ld % 8 == 0.
extern "C" int tpu1x_temporal_attention(const void* q, const void* k,
                                        const void* v, void* out, int B, int T,
                                        int S, int C, int ld, float scale,
                                        int causal, void* stream) {
  if (T > TA_MAXT || C % 256 || ld % 8) return cudaErrorInvalidValue;
  temporal_attention_kernel<<<dim3(S, B), C / 8, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), T, S, C, ld, scale, causal);
  return cudaGetLastError();
}

// Requires T <= 16, C % 256 == 0 (whole warps of 4-lane heads), strides that
// are multiples of 8.
extern "C" int tpu1x_temporal_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, int B, int T, int S, int C, int ld, int ld_do,
    int ld_out, float scale, int causal, void* stream) {
  if (T > TA_MAXT || C % 256 || ld % 8 || ld_do % 8 || ld_out % 8)
    return cudaErrorInvalidValue;
  const int chunk = TAB_HEADS * 32;
  temporal_attention_bwd_kernel<<<dim3(S, B, (C + chunk - 1) / chunk),
                                  (C < chunk ? C : chunk) / 8, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), T,
      S, C, ld, ld_do, ld_out, scale, causal);
  return cudaGetLastError();
}
