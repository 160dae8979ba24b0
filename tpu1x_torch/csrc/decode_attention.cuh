// Attention of one query frame, or of a [prev, cur] pair of frames, against
// the KV cache slots t < t_B[b] of one layer plus the in-pass keys: one joint
// fp32 softmax per (token, head). The kernel that the temporal+MLP block
// (csrc/temporal_mlp_block.cu) and the stand-alone decode attention
// (csrc/decode_attention.cu) both launch.
//
// Bound on the H100: device memory, the read of the valid cache slots
// (2 B S C bytes per slot in bf16, half that in int8). Only slots t < t_B[b]
// are read: the TPU kernels streamed all T slots and masked. A head's 32
// channels live in 32 / CH neighbouring lanes, CH channels to a lane, each
// filled by one 16-byte load of the cache: CH = 8 and four lanes for a bf16
// cache, CH = 16 and two lanes for an int8 cache (a 16-byte load is 16 int8
// channels; halving the load width instead would halve the bytes in flight).
// The lanes of a head reduce their partial dot products with shuffles, which
// takes the place of the TPU kernels' 0/1 head matrix. An int8 slot's
// per-token scales multiply the logit after the dot and the probability
// before the PV sum, so no dequantized copy of the cache exists. Logits,
// softmax, probabilities and the PV sum stay fp32 in registers.

#pragma once

#include "common.cuh"

namespace tpu1x {

constexpr int DA_MAXT = 16;

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
  float scale;
};

template <int CH>
__device__ __forceinline__ void load_row(const bf16* p, float* f) {
#pragma unroll
  for (int i = 0; i < CH; i += 8) load8(p + i, f + i);
}

template <int CH>
__device__ __forceinline__ void store_row(bf16* p, const float* f) {
#pragma unroll
  for (int i = 0; i < CH; i += 8) store8(p + i, f + i);
}

// CH channels of one cache slot: 8 bf16 or 16 int8, one 16-byte load.
template <bool Q>
__device__ __forceinline__ void load_slot(const void* base, long off, float* f) {
  if constexpr (Q) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        static_cast<const signed char*>(base) + off);
    const signed char* c = reinterpret_cast<const signed char*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(c[i]);
  } else {
    load8(static_cast<const bf16*>(base) + off, f);
  }
}

// Sum over the 32 / CH lanes that share one 32-channel head.
template <int CH>
__device__ __forceinline__ float head_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  if constexpr (CH == 8) v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// F frames per row (1, or 2 = [prev, cur]: prev attends the cache plus
// itself, cur attends the cache, prev's k/v and itself). Q: int8 cache.
// grid (S / SPB, B), SPB C / CH threads, SPB = 2 tokens per block for the
// int8 cache, so that C = 256 still fills whole warps.
template <int F, bool Q>
__global__ void decode_attention_kernel(DecodeAttnArgs a) {
  constexpr int CH = Q ? 16 : 8;
  const int lanes = a.C / CH;
  const int s = Q ? blockIdx.x * 2 + threadIdx.x / lanes : blockIdx.x;
  const int b = blockIdx.y;
  const int c0 = (Q ? threadIdx.x % lanes : threadIdx.x) * CH;
  const int B = a.B, S = a.S, C = a.C, T = a.T, L = a.L, layer = a.layer;
  const float scale = a.scale;
  const int tb = max(0, min(a.t_B[b], T));

  float q[F][CH], ks[F][CH], vs[F][CH];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    load_row<CH>(a.q[f] + b * a.sb[0] + s * a.ld[0] + c0, q[f]);
    load_row<CH>(a.k[f] + b * a.sb[1] + s * a.ld[1] + c0, ks[f]);
    load_row<CH>(a.v[f] + b * a.sb[2] + s * a.ld[2] + c0, vs[f]);
    if (f == 0 && a.k_out != nullptr) {  // bf16 values: the store is exact
      const long o = ((long)b * S + s) * C + c0;
      store_row<CH>(a.k_out + o, ks[f]);
      store_row<CH>(a.v_out + o, vs[f]);
    }
  }
  auto slot = [&](int t) { return ((((long)t * L + layer) * B + b) * S + s) * C + c0; };
  auto token = [&](int t) { return (((long)layer * B + b) * T + t) * S + s; };

  float lg[F][DA_MAXT], m[F];
#pragma unroll
  for (int f = 0; f < F; ++f) m[f] = -INFINITY;
#pragma unroll
  for (int j = 0; j < DA_MAXT; ++j) {
    if (j < tb) {
      float kf[CH];
      load_slot<Q>(a.kc, slot(j), kf);
      const float sc = Q ? scale * a.ksc[token(j)] : scale;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < CH; ++i) d += q[f][i] * kf[i];
        lg[f][j] = head_sum<CH>(d) * sc;
        m[f] = fmaxf(m[f], lg[f][j]);
      }
    }
  }
  // in-pass logits: each frame against itself; with a pair, cur against prev
  float ls[F], lp = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) d += q[f][i] * ks[f][i];
    ls[f] = head_sum<CH>(d) * scale;
    m[f] = fmaxf(m[f], ls[f]);
  }
  if (F == 2) {
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) d += q[F - 1][i] * ks[0][i];
    lp = head_sum<CH>(d) * scale;
    m[F - 1] = fmaxf(m[F - 1], lp);
  }

  float den[F], es[F], ep = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    den[f] = 0.f;
#pragma unroll
    for (int j = 0; j < DA_MAXT; ++j) {
      if (j < tb) {
        lg[f][j] = __expf(lg[f][j] - m[f]);
        den[f] += lg[f][j];
      }
    }
    es[f] = __expf(ls[f] - m[f]);
  }
  if (F == 2) {
    ep = __expf(lp - m[F - 1]);
    den[F - 1] += ep;
  }
#pragma unroll
  for (int f = 0; f < F; ++f) den[f] += es[f];

  float acc[F][CH];
#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int i = 0; i < CH; ++i) acc[f][i] = 0.f;
#pragma unroll
  for (int j = 0; j < DA_MAXT; ++j) {
    if (j < tb) {
      float vf[CH];
      load_slot<Q>(a.vc, slot(j), vf);
      const float sc = Q ? a.vsc[token(j)] : 1.f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float p = Q ? lg[f][j] / den[f] * sc : lg[f][j] / den[f];
#pragma unroll
        for (int i = 0; i < CH; ++i) acc[f][i] += p * vf[i];
      }
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float p = es[f] / den[f];
#pragma unroll
    for (int i = 0; i < CH; ++i) acc[f][i] += p * vs[f][i];
  }
  if (F == 2) {
    const float p = ep / den[F - 1];
#pragma unroll
    for (int i = 0; i < CH; ++i) acc[F - 1][i] += p * vs[0][i];
  }
#pragma unroll
  for (int f = 0; f < F; ++f)
    store_row<CH>(a.out[f] + b * a.osb + s * a.old + c0, acc[f]);
}

// Requires frames in {1, 2}, T <= 16, C % 256 == 0 (whole warps of the lanes
// of a head), 0 <= layer < L; an int8 cache (a.ksc not null) also S % 2 == 0.
inline cudaError_t launch_decode_attention(const DecodeAttnArgs& a, int frames,
                                           cudaStream_t s) {
  const bool q8 = a.ksc != nullptr;
  if ((frames != 1 && frames != 2) || a.T > DA_MAXT || a.C % 256 ||
      a.layer < 0 || a.layer >= a.L || (q8 && (a.S % 2 || a.vsc == nullptr)))
    return cudaErrorInvalidValue;
  if (q8) {
    const dim3 grid(a.S / 2, a.B);
    if (frames == 1)
      decode_attention_kernel<1, true><<<grid, a.C / 8, 0, s>>>(a);
    else
      decode_attention_kernel<2, true><<<grid, a.C / 8, 0, s>>>(a);
  } else {
    const dim3 grid(a.S, a.B);
    if (frames == 1)
      decode_attention_kernel<1, false><<<grid, a.C / 8, 0, s>>>(a);
    else
      decode_attention_kernel<2, false><<<grid, a.C / 8, 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace tpu1x
