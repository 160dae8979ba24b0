"""Decode-step second half of an STBlock, for one frame or a [prev, cur]
pair: temporal qkv, attention over the KV cache, proj + residual, LN2, MLP +
residual."""

from __future__ import annotations

from typing import Optional

import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops._util import (check_decode_width, check_tensor, dense,
                                   gelu, ptr, require)
from tpu1x_torch.ops.decode_attention import (
    temporal_decode2_attention_reference, temporal_decode_attention_reference)
from tpu1x_torch.ops.layernorm import layer_norm_plain


def _mlp_tail(x, out, *, wproj, bproj, ln_scale, ln_bias, wfc1, bfc1, wfc2,
              bfc2, gelu_tanh):
    x1 = x + dense(out, wproj, bproj)
    h = gelu(dense(layer_norm_plain(x1, ln_scale, ln_bias), wfc1, bfc1),
             gelu_tanh)
    return x1 + dense(h, wfc2, bfc2)


def temporal_mlp_block_plain(x, k_cache_l, v_cache_l, t_B, *, scale: float,
                             num_heads: int, wqkv, wproj, ln_scale, ln_bias,
                             wfc1, wfc2, bqkv=None, bproj=None, bfc1=None,
                             bfc2=None, gelu_tanh: bool = True):
    """The JAX package's `temporal_mlp_block_reference` on one layer's
    (T, B, S, C) cache. Returns (out, k_cur, v_cur)."""
    C = x.shape[-1]
    q, k_cur, v_cur = dense(x, wqkv, bqkv).split(C, dim=-1)
    out = temporal_decode_attention_reference(
        q, k_cache_l, v_cache_l, k_cur, v_cur, t_B, scale=scale,
        num_heads=num_heads)
    y = _mlp_tail(x, out, wproj=wproj, bproj=bproj, ln_scale=ln_scale,
                  ln_bias=ln_bias, wfc1=wfc1, bfc1=bfc1, wfc2=wfc2, bfc2=bfc2,
                  gelu_tanh=gelu_tanh)
    return y, k_cur.contiguous(), v_cur.contiguous()


def temporal_mlp_block_pair_plain(z, k_cache_l, v_cache_l, t_prev_B, *,
                                  scale: float, num_heads: int, wqkv, wproj,
                                  ln_scale, ln_bias, wfc1, wfc2, bqkv=None,
                                  bproj=None, bfc1=None, bfc2=None,
                                  gelu_tanh: bool = True):
    """The JAX package's `temporal_mlp_block_pair_reference`; z (B, 2, S, C)
    = [prev, cur]. Returns (z_out, k_prev, v_prev)."""
    C = z.shape[-1]
    xp, xc = z[:, 0], z[:, 1]
    qp, kp, vp = dense(xp, wqkv, bqkv).split(C, dim=-1)
    qc, kc, vc = dense(xc, wqkv, bqkv).split(C, dim=-1)
    out_p, out_c = temporal_decode2_attention_reference(
        qp, qc, k_cache_l, v_cache_l, kp, vp, kc, vc, t_prev_B, scale=scale,
        num_heads=num_heads)
    w = dict(wproj=wproj, bproj=bproj, ln_scale=ln_scale, ln_bias=ln_bias,
             wfc1=wfc1, bfc1=bfc1, wfc2=wfc2, bfc2=bfc2, gelu_tanh=gelu_tanh)
    z_out = torch.stack([_mlp_tail(xp, out_p, **w), _mlp_tail(xc, out_c, **w)],
                        dim=1)
    return z_out, kp.contiguous(), vp.contiguous()


def plain_on_cache(plain, x, k_cache, v_cache, t_B, *, layer: int,
                   kv_out=None, return_kv: bool = True, **w):
    """`plain` (`temporal_mlp_block_plain` or its pair) called as the
    wrapper calls its kernel: on layer `layer` of the (T, L, B, S, C)
    caches, with k/v copied into `kv_out` when it is given, and (out, None,
    None) returned when return_kv is False."""
    y, k, v = plain(x, k_cache[:, layer], v_cache[:, layer], t_B, **w)
    if not return_kv:
        return y, None, None
    if kv_out is not None:
        kv_out[0].copy_(k)
        kv_out[1].copy_(v)
        k, v = kv_out
    return y, k, v


def _launch(x, k_cache, v_cache, t_B, layer, frames, kv_out, return_kv, *,
            scale, num_heads, wqkv, wproj, ln_scale, ln_bias, wfc1, wfc2,
            bqkv, bproj, bfc1, bfc2, gelu_tanh):
    B, S, C = x.shape[0], x.shape[-2], x.shape[-1]
    T, L = k_cache.shape[:2]
    F4 = wfc1.shape[1]
    dev, bf = x.device, torch.bfloat16
    require(T <= 32, f"temporal_mlp_block kernel needs T <= 32, got {T}")
    D = check_decode_width(C, num_heads, "temporal_mlp_block kernel")
    require(F4 % 64 == 0, f"MLP width {F4} is not a multiple of 64")
    require(isinstance(layer, int) and 0 <= layer < L,
            f"layer must be an int in [0, {L}), got {layer!r}")
    check_tensor(x, "x", (B, S, C) if frames == 1 else (B, 2, S, C), bf, dev)
    check_tensor(k_cache, "k_cache", (T, L, B, S, C), bf, dev)
    check_tensor(v_cache, "v_cache", (T, L, B, S, C), bf, dev)
    check_tensor(t_B, "t_B", (B,), torch.int32, dev)
    check_tensor(wqkv, "wqkv", (C, 3 * C), bf, dev)
    check_tensor(wproj, "wproj", (C, C), bf, dev)
    check_tensor(wfc1, "wfc1", (C, F4), bf, dev)
    check_tensor(wfc2, "wfc2", (F4, C), bf, dev)
    check_tensor(ln_scale, "ln_scale", (C,), torch.float32, dev)
    check_tensor(ln_bias, "ln_bias", (C,), torch.float32, dev)
    for name, b, n in (("bqkv", bqkv, 3 * C), ("bproj", bproj, C),
                       ("bfc1", bfc1, F4), ("bfc2", bfc2, C)):
        if b is not None:
            check_tensor(b, name, (n,), bf, dev)
    M = B * frames * S
    qkv = torch.empty(M, 3 * C, dtype=bf, device=dev)
    attn = torch.empty(M, C, dtype=bf, device=dev)
    x1 = torch.empty(M, C, dtype=bf, device=dev)
    xn = torch.empty(M, C, dtype=bf, device=dev)
    h = torch.empty(M, F4, dtype=bf, device=dev)
    out = torch.empty_like(x)
    k_out = v_out = None
    if return_kv and kv_out is not None:
        k_out, v_out = kv_out
        check_tensor(k_out, "k_out", (B, S, C), bf, dev)
        check_tensor(v_out, "v_out", (B, S, C), bf, dev)
    elif return_kv:
        k_out = torch.empty(B, S, C, dtype=bf, device=dev)
        v_out = torch.empty_like(k_out)
    err = kernels.lib("temporal_mlp_block").tpu1x_temporal_mlp_block(
        x.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), t_B.data_ptr(),
        wqkv.data_ptr(), ptr(bqkv), wproj.data_ptr(), ptr(bproj),
        ln_scale.data_ptr(), ln_bias.data_ptr(), wfc1.data_ptr(), ptr(bfc1),
        wfc2.data_ptr(), ptr(bfc2), qkv.data_ptr(), attn.data_ptr(),
        x1.data_ptr(), xn.data_ptr(), h.data_ptr(), out.data_ptr(),
        ptr(k_out),
        ptr(v_out), B, frames, S, C, D, F4, T, L, layer, int(gelu_tanh),
        scale, kernels.stream_of(x))
    kernels.check(err, "temporal_mlp_block")
    return out, k_out, v_out


def temporal_mlp_block(x: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, t_B: torch.Tensor, *, layer: int,
                       scale: float, num_heads: int, wqkv, wproj, ln_scale,
                       ln_bias, wfc1, wfc2,
                       bqkv: Optional[torch.Tensor] = None, bproj=None,
                       bfc1=None, bfc2=None,
                       gelu_tanh: bool = True, kv_out=None,
                       return_kv: bool = True):
    """One frame: x (B, S, C) after the spatial half; caches (T, L, B, S, C);
    t_B (B,) int32, cache slots >= t are not attended; `layer` picks the
    cache layer. Returns (out, k_cur, v_cur), each (B, S, C). k_cur/v_cur
    are written into `kv_out`, a pair of (B, S, C) tensors, when it is
    given; with return_kv=False they are not written and come back None.

    CPU tensors take `temporal_mlp_block_plain`. CUDA tensors launch
    csrc/temporal_mlp_block.cu, which replaces the Pallas kernel
    tpu1x/ops/temporal_mlp_block.py:temporal_mlp_block (_kernel_single):
    bf16 activations, caches and weights, fp32 LN params, int32 t_B, head_dim
    32, 64, 72 or 128, C <= 2048 (the decode ring's widths,
    `_util.decode_width_ok`), F4 % 64 == 0, T <= 32. Six launches on one
    stream:
    the four weight products on the TMA-fed wgmma GEMM of
    csrc/gemm_sm90.cuh (fc1 with its GELU epilogue), the cache attention
    between qkv and proj, LN2 as a row pass before fc1. Bound on the H100:
    the tensor cores for the products and device memory for the cache read,
    which touches only the slots t < t_B[b] of one layer.
    """
    w = dict(scale=scale, num_heads=num_heads, wqkv=wqkv, wproj=wproj,
             ln_scale=ln_scale, ln_bias=ln_bias, wfc1=wfc1, wfc2=wfc2,
             bqkv=bqkv, bproj=bproj, bfc1=bfc1, bfc2=bfc2, gelu_tanh=gelu_tanh)
    if not x.is_cuda:
        return plain_on_cache(temporal_mlp_block_plain, x, k_cache, v_cache,
                              t_B, layer=layer, kv_out=kv_out,
                              return_kv=return_kv, **w)
    out = _launch(x, k_cache, v_cache, t_B, layer, 1, kv_out, return_kv, **w)
    kernels.count("temporal_mlp_block")
    return out


def temporal_mlp_block_pair(z: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, t_prev_B: torch.Tensor, *,
                            layer: int, scale: float, num_heads: int, wqkv,
                            wproj, ln_scale, ln_bias, wfc1, wfc2, bqkv=None,
                            bproj=None, bfc1=None, bfc2=None,
                            gelu_tanh: bool = True, kv_out=None,
                            return_kv: bool = True):
    """The [prev, cur] pair: z (B, 2, S, C). prev attends cache slots
    < t_prev plus itself; cur attends the same slots, prev's k/v and itself,
    from one read of the cache. Returns (z_out, k_prev, v_prev); the caller
    commits k_prev/v_prev at slot t_prev. `kv_out` and `return_kv` as in
    `temporal_mlp_block`.

    CPU tensors take `temporal_mlp_block_pair_plain`. CUDA tensors launch
    the same source as `temporal_mlp_block` with two frames per row; it
    replaces the Pallas kernel tpu1x/ops/temporal_mlp_block.py:
    temporal_mlp_block_pair (_kernel_pair), with the same requirements.
    """
    w = dict(scale=scale, num_heads=num_heads, wqkv=wqkv, wproj=wproj,
             ln_scale=ln_scale, ln_bias=ln_bias, wfc1=wfc1, wfc2=wfc2,
             bqkv=bqkv, bproj=bproj, bfc1=bfc1, bfc2=bfc2, gelu_tanh=gelu_tanh)
    if not z.is_cuda:
        return plain_on_cache(temporal_mlp_block_pair_plain, z, k_cache,
                              v_cache, t_prev_B, layer=layer, kv_out=kv_out,
                              return_kv=return_kv, **w)
    out = _launch(z, k_cache, v_cache, t_prev_B, layer, 2, kv_out, return_kv,
                  **w)
    kernels.count("temporal_mlp_block_pair")
    return out
