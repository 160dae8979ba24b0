"""Decode attention of one or two query frames against the stacked KV cache,
bf16 or int8 with per-token scales: the kernels' wrappers, the plain
versions beside them, and the cache quantization."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops._util import (check_decode_width, check_tensor, ptr,
                                   require)
from tpu1x_torch.ops.attention import NEG_INF


def quantize_kv(x: torch.Tensor, dim: int = -1):
    """Symmetric per-token int8 quantization over `dim` (the channels):
    scale = amax / 127 (1 where amax is 0), q = clip(round(x / scale), -127,
    127), rounding half to even in fp32. Returns (q int8, scale fp32 with
    `dim` removed)."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.squeeze(dim)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dim: int = -1) -> torch.Tensor:
    """Inverse of `quantize_kv`, in fp32."""
    return q.float() * scale.unsqueeze(dim)


def temporal_decode_attention_reference(q, k_cache_l, v_cache_l, k_cur, v_cur,
                                        t_B, *, scale: float, num_heads: int):
    """q, k_cur, v_cur (B, S, C); k/v_cache_l (T, B, S, C), one layer of the
    T-major cache; t_B (B,) int: cache slots >= t are masked. One joint fp32
    softmax over the cache slots and the current token. Returns q's dtype."""
    B, S, C = q.shape
    T = k_cache_l.shape[0]
    H = num_heads
    D = C // H
    qf = q.float().reshape(1, B, S, H, D)
    kf = k_cache_l.float().reshape(T, B, S, H, D)
    logits = (qf * kf).sum(-1).permute(1, 2, 0, 3) * scale  # (B, S, T, H)
    logit_s = (q.float() * k_cur.float()).reshape(B, S, H, D).sum(-1) * scale
    t_iota = torch.arange(T, device=q.device)
    valid = t_iota[None, :] < t_B.to(q.device)[:, None]  # (B, T)
    logits = torch.where(valid[:, None, :, None], logits,
                         torch.full_like(logits, NEG_INF))
    m = torch.maximum(logits.amax(2), logit_s)  # (B, S, H)
    e_c = torch.exp(logits - m[:, :, None, :])
    e_s = torch.exp(logit_s - m)
    denom = e_c.sum(2) + e_s
    p = e_c / denom[:, :, None, :]  # (B, S, T, H)
    vf = v_cache_l.float().reshape(T, B, S, H, D)
    out = (p.permute(2, 0, 1, 3)[..., None] * vf).sum(0)  # (B, S, H, D)
    out = out + (e_s / denom)[..., None] * v_cur.float().reshape(B, S, H, D)
    return out.reshape(B, S, C).to(q.dtype)


def _with_slot(cache_l, x_BSC, t_B):
    """A copy of a (T, B, S, C) cache with x written at each row's slot t."""
    T = cache_l.shape[0]
    t_iota = torch.arange(T, device=cache_l.device)
    sel = t_iota[:, None] == t_B.to(cache_l.device)[None, :]  # (T, B)
    sel = sel[:, :, None, None]
    return torch.where(sel, x_BSC[None].to(cache_l.dtype), cache_l)


def temporal_decode2_attention_reference(q_prev, q_cur, k_cache_l, v_cache_l,
                                         k_prev, v_prev, k_cur, v_cur,
                                         t_prev_B, *, scale: float,
                                         num_heads: int):
    """Two query frames against one cache read: prev (frame t_prev) attends
    slots < t_prev plus itself; cur (frame t_prev + 1) attends slots
    < t_prev, prev's k/v and itself. Returns (out_prev, out_cur)."""
    out_prev = temporal_decode_attention_reference(
        q_prev, k_cache_l, v_cache_l, k_prev, v_prev, t_prev_B, scale=scale,
        num_heads=num_heads)
    out_cur = temporal_decode_attention_reference(
        q_cur, _with_slot(k_cache_l, k_prev, t_prev_B),
        _with_slot(v_cache_l, v_prev, t_prev_B), k_cur, v_cur, t_prev_B + 1,
        scale=scale, num_heads=num_heads)
    return out_prev, out_cur


def cache_layer(k_cache, v_cache, layer: int, k_scale=None, v_scale=None,
                dtype=None):
    """One layer's (T, B, S, C) k and v of the stacked (T, L, B, S, C)
    cache; an int8 cache is dequantized with its (L, B, T, S) scales and
    cast to `dtype`. The plain versions read the cache through this; the
    kernels never build such a copy."""
    k_l, v_l = k_cache[:, layer], v_cache[:, layer]
    if k_scale is not None:
        k_l = dequantize_kv(k_l, k_scale[layer].transpose(0, 1)).to(dtype)
        v_l = dequantize_kv(v_l, v_scale[layer].transpose(0, 1)).to(dtype)
    return k_l, v_l


def _deliver(outs, out, kv, kv_out):
    """Copy results into the caller's `out` / `kv_out` tensors, when given,
    as the kernels write them there."""
    if kv_out is not None:
        kv_out[0].copy_(kv[0])
        kv_out[1].copy_(kv[1])
    if out is None:
        return outs
    for dst, src in zip(out, outs):
        dst.copy_(src)
    return tuple(out)


def temporal_decode_attention_plain(q, k_cache, v_cache, k_cur, v_cur, t_B, *,
                                    layer: int, scale: float, num_heads: int,
                                    k_scale=None, v_scale=None, out=None,
                                    kv_out=None):
    """`temporal_decode_attention` in plain torch: the reference on layer
    `layer` of the cache, dequantized when it is int8."""
    k_l, v_l = cache_layer(k_cache, v_cache, layer, k_scale, v_scale, q.dtype)
    res = temporal_decode_attention_reference(
        q, k_l, v_l, k_cur, v_cur, t_B, scale=scale, num_heads=num_heads)
    return _deliver((res,), None if out is None else (out,), (k_cur, v_cur),
                    kv_out)[0]


def temporal_decode2_attention_plain(q_prev, q_cur, k_cache, v_cache, k_prev,
                                     v_prev, k_cur, v_cur, t_prev_B, *,
                                     layer: int, scale: float, num_heads: int,
                                     k_scale=None, v_scale=None, out=None,
                                     kv_out=None):
    """`temporal_decode2_attention` in plain torch."""
    k_l, v_l = cache_layer(k_cache, v_cache, layer, k_scale, v_scale,
                           q_prev.dtype)
    res = temporal_decode2_attention_reference(
        q_prev, q_cur, k_l, v_l, k_prev, v_prev, k_cur, v_cur, t_prev_B,
        scale=scale, num_heads=num_heads)
    return _deliver(res, out, (k_prev, v_prev), kv_out)


def _view_strides(ts, name: str, shape, dev):
    """Check bf16 (B, S, C) views that share their strides; returns the
    (batch, token) strides."""
    strides = ts[0].stride()
    for i, t in enumerate(ts):
        require(t.device == dev and t.dtype == torch.bfloat16
                and tuple(t.shape) == tuple(shape),
                f"{name}[{i}] must be bf16 {tuple(shape)} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        require(t.stride() == strides and strides[2] == 1
                and strides[0] % 8 == 0 and strides[1] % 8 == 0
                and t.data_ptr() % 16 == 0,
                f"{name}[{i}]: strides {t.stride()} must be (8 i, 8 j, 1), "
                f"the same for every frame, and the data 16-byte aligned")
    return strides[0], strides[1]


def _check(qs, ks, vs, k_cache, v_cache, t_B, layer, k_scale, v_scale, out,
           kv_out, num_heads):
    """The contract the kernel takes, checked before a launch: one tuple of
    (B, S, C) views per kind, one view per frame. Returns the (batch, token)
    strides of q, k, v and, where given, out. The cache's slot tiles and an
    int8 cache's scales reach shared memory by bulk copies, which move whole
    16-byte units between 16-byte aligned addresses: the caches and scales
    are contiguous and aligned, and an int8 cache needs S % 4 == 0 (an
    item's scales start at a token that is a multiple of 4)."""
    B, S, C = qs[0].shape
    T, L = k_cache.shape[:2]
    dev = qs[0].device
    require(T <= 32, f"decode attention kernel needs T <= 32, got {T}")
    check_decode_width(C, num_heads, "decode attention kernel")
    require(isinstance(layer, int) and 0 <= layer < L,
            f"layer must be an int in [0, {L}), got {layer!r}")
    require((k_scale is None) == (v_scale is None),
            "pass both cache scales or neither")
    quantized = k_scale is not None
    cache_dtype = torch.int8 if quantized else torch.bfloat16
    check_tensor(k_cache, "k_cache", (T, L, B, S, C), cache_dtype, dev)
    check_tensor(v_cache, "v_cache", (T, L, B, S, C), cache_dtype, dev)
    if quantized:
        require(S % 4 == 0,
                f"the int8 cache kernel needs S % 4 == 0, got {S}")
        check_tensor(k_scale, "k_scale", (L, B, T, S), torch.float32, dev)
        check_tensor(v_scale, "v_scale", (L, B, T, S), torch.float32, dev)
    check_tensor(t_B, "t_B", (B,), torch.int32, dev)
    strides = [_view_strides(ts, name, (B, S, C), dev)
               for ts, name in ((qs, "q"), (ks, "k"), (vs, "v"))]
    if out is not None:
        strides.append(_view_strides(out, "out", (B, S, C), dev))
    if kv_out is not None:
        check_tensor(kv_out[0], "k_out", (B, S, C), torch.bfloat16, dev)
        check_tensor(kv_out[1], "v_out", (B, S, C), torch.bfloat16, dev)
    return strides


def _launch(qs, ks, vs, k_cache, v_cache, t_B, layer, k_scale, v_scale, out,
            kv_out, scale, num_heads):
    frames = len(qs)
    B, S, C = qs[0].shape
    T, L = k_cache.shape[:2]
    if out is None:
        buf = torch.empty(frames, B, S, C, dtype=torch.bfloat16,
                          device=qs[0].device)
        out = tuple(buf.unbind(0))
    sq, sk, sv, so = _check(qs, ks, vs, k_cache, v_cache, t_B, layer,
                            k_scale, v_scale, out, kv_out, num_heads)
    second = (lambda ts: ts[1].data_ptr() if frames == 2 else None)
    err = kernels.lib("decode_attention").tpu1x_decode_attention(
        qs[0].data_ptr(), second(qs), ks[0].data_ptr(), second(ks),
        vs[0].data_ptr(), second(vs), *sq, *sk, *sv, k_cache.data_ptr(),
        v_cache.data_ptr(), ptr(k_scale), ptr(v_scale), t_B.data_ptr(),
        out[0].data_ptr(), second(out), *so,
        None if kv_out is None else kv_out[0].data_ptr(),
        None if kv_out is None else kv_out[1].data_ptr(), B, frames, S, C,
        C // num_heads, T, L, layer, scale, kernels.stream_of(qs[0]))
    kernels.check(err, "decode_attention")
    return tuple(out)


def temporal_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, k_cur: torch.Tensor,
                              v_cur: torch.Tensor, t_B: torch.Tensor, *,
                              layer: int, scale: float, num_heads: int,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None,
                              out: Optional[torch.Tensor] = None,
                              kv_out: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None
                              ) -> torch.Tensor:
    """One query frame against layer `layer` of the stacked cache.

    q, k_cur, v_cur (B, S, C), heads flat; k_cache, v_cache (T, L, B, S, C),
    bf16, or int8 with `k_scale`, `v_scale` (L, B, T, S) fp32 per-token
    scales (`quantize_kv`); t_B (B,) int32, cache slots >= t_B[b] are not
    attended (t_B[b] = 0: the softmax is over the frame's own key alone).
    Returns (B, S, C) in q's dtype, written into `out` when given; `kv_out`,
    a pair of contiguous (B, S, C) tensors, receives copies of k_cur and
    v_cur.

    CPU tensors take `temporal_decode_attention_plain`. CUDA tensors launch
    csrc/decode_attention.cu, which replaces the Pallas kernel
    tpu1x/ops/decode_attention.py:temporal_decode_attention (_kernel): bf16
    q, k_cur, v_cur, int32 t_B, `layer` a plain int, head_dim 32, 64, 72 or
    128, C <= 2048 (`_util.decode_width_ok`: an item of at least 4 tokens on
    at most 256 consumer threads, 384 at head_dim 72), T <= 32, S % 4 == 0
    for the int8 cache. q, k_cur, v_cur and `out` may each be strided
    views, as the column thirds of one qkv product are: last axis
    contiguous, the other two strides multiples of 8, the data 16-byte
    aligned (`_check`).

    The TPU kernel multiplies q and k in bf16 and rounds the probabilities
    to bf16 before PV; this kernel keeps both fp32, as the reference does.
    Bound on the H100: device memory, the read of the cache slots t < t_B[b]
    of one layer (the int8 cache halves it). Persistent blocks stream each
    slot's tile of a few tokens' K and V rows into a ring of shared-memory
    stages by bulk copies, and a thread per (token, 32 channels) runs an
    online softmax over them in one pass (at head_dim 64 two lanes a head
    row, their halves of each logit summed by a shuffle; at 128 four lanes,
    two shuffles; at 72 three lanes of 24 channels, ten heads a warp); an
    int8 slot's
    scales multiply the logit and the probability, and no dequantized copy
    exists.
    """
    kw = dict(layer=layer, scale=scale, num_heads=num_heads, k_scale=k_scale,
              v_scale=v_scale)
    if not q.is_cuda:
        return temporal_decode_attention_plain(
            q, k_cache, v_cache, k_cur, v_cur, t_B, out=out, kv_out=kv_out,
            **kw)
    res = _launch((q,), (k_cur,), (v_cur,), k_cache, v_cache, t_B, layer,
                  k_scale, v_scale, None if out is None else (out,), kv_out,
                  scale, num_heads)
    kernels.count("temporal_decode_attention")
    return res[0]


def temporal_decode2_attention(q_prev: torch.Tensor, q_cur: torch.Tensor,
                               k_cache: torch.Tensor, v_cache: torch.Tensor,
                               k_prev: torch.Tensor, v_prev: torch.Tensor,
                               k_cur: torch.Tensor, v_cur: torch.Tensor,
                               t_prev_B: torch.Tensor, *, layer: int,
                               scale: float, num_heads: int,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None,
                               out: Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]] = None,
                               kv_out: Optional[Tuple[torch.Tensor,
                                                      torch.Tensor]] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two query frames from one read of the cache: prev (frame t_prev)
    attends slots < t_prev plus itself; cur (frame t_prev + 1) attends the
    same slots, prev's k/v and itself. Returns (out_prev, out_cur), written
    into the pair `out` when given; `kv_out` receives copies of k_prev and
    v_prev, which the caller commits at slot t_prev. Other arguments as in
    `temporal_decode_attention`.

    CPU tensors take `temporal_decode2_attention_plain`. CUDA tensors launch
    the same source as `temporal_decode_attention` with two frames per row;
    it replaces the Pallas kernel tpu1x/ops/decode_attention.py:
    temporal_decode2_attention (_kernel2), with the same requirements; the
    two frames of q (of k, of v, of out) share their strides, as the batch
    halves of one tensor do.
    """
    kw = dict(layer=layer, scale=scale, num_heads=num_heads, k_scale=k_scale,
              v_scale=v_scale)
    if not q_prev.is_cuda:
        return temporal_decode2_attention_plain(
            q_prev, q_cur, k_cache, v_cache, k_prev, v_prev, k_cur, v_cur,
            t_prev_B, out=out, kv_out=kv_out, **kw)
    res = _launch((q_prev, q_cur), (k_prev, k_cur), (v_prev, v_cur), k_cache,
                  v_cache, t_prev_B, layer, k_scale, v_scale, out, kv_out,
                  scale, num_heads)
    kernels.count("temporal_decode2_attention")
    return res
