"""Spatial half of an STBlock: x + proj(MHA(qkv(LN1(x)))), bidirectional
over the S tokens of each frame, heads flat in C."""

from __future__ import annotations

from typing import Optional

import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops._util import (check_tensor, dense, gelu, head_dim_of,
                                   ptr, require)
from tpu1x_torch.ops.attention import (FLASH_MAX_TOKENS, FLASH_MIN_TOKENS,
                                       mha_reference)
from tpu1x_torch.ops.layernorm import layer_norm_plain


def spatial_block_plain(x, wqkv, wproj, *, num_heads: int, scale: float,
                        bqkv=None, bproj=None, ln_scale=None, ln_bias=None,
                        qk_ln_scale=None, qk_ln_bias=None):
    """The JAX package's `spatial_block_reference`: the serving path's
    mixed precision, in plain torch."""
    N, S, C = x.shape
    H = num_heads
    xn = x if ln_scale is None else layer_norm_plain(x, ln_scale, ln_bias)
    qkv = dense(xn, wqkv, bqkv)
    q, k, v = (t.reshape(N, S, H, C // H) for t in qkv.split(C, dim=-1))
    if qk_ln_scale is not None:  # fp32 LN over head_dim, shared by q and k
        q = layer_norm_plain(q, qk_ln_scale, qk_ln_bias)
        k = layer_norm_plain(k, qk_ln_scale, qk_ln_bias)
    out = mha_reference(q, k, v, scale=scale, causal=False)
    return x + dense(out.reshape(N, S, C), wproj, bproj)


# the GEMM epilogue's activations, as csrc/common.cuh numbers them
GEMM_ACTS = {None: 0, "tanh": 1, "erf": 2}


def gemm_sm90_plain(a, b, bias=None, resid=None, act=None):
    """What `gemm_sm90` computes, in plain torch: a @ b rounded to a's
    dtype, + bias rounded, GELU rounded (act "tanh" or "erf"; None: none),
    + resid rounded (the serving chain)."""
    require(act in GEMM_ACTS, f"act must be one of {list(GEMM_ACTS)}, "
            f"got {act!r}")
    y = dense(a, b, bias)
    if act is not None:
        y = gelu(y, act == "tanh")
    return y if resid is None else resid + y


def gemm_sm90(a: torch.Tensor, b: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              resid: Optional[torch.Tensor] = None,
              act: Optional[str] = None) -> torch.Tensor:
    """The products of K1 and of K2/K3 alone, for the card checks: a (M, K)
    @ b (K, N) (+ bias (N,)) (GELU) (+ resid (M, N)), bf16, on the GEMM of
    csrc/gemm_sm90.cuh (TMA, wgmma). CPU tensors take `gemm_sm90_plain`.
    Not counted: the blocks' wrappers count the launches that carry these
    products."""
    if not a.is_cuda:
        return gemm_sm90_plain(a, b, bias, resid, act)
    require(act in GEMM_ACTS, f"act must be one of {list(GEMM_ACTS)}, "
            f"got {act!r}")
    (M, K), (Kb, N) = a.shape, b.shape
    dev, bf = a.device, torch.bfloat16
    require(K == Kb and N % 64 == 0 and K % 64 == 0,
            f"gemm_sm90 needs a (M, K) @ b (K, N), N and K multiples of 64, "
            f"got {tuple(a.shape)} @ {tuple(b.shape)}")
    check_tensor(a, "a", (M, K), bf, dev)
    check_tensor(b, "b", (K, N), bf, dev)
    if bias is not None:
        check_tensor(bias, "bias", (N,), bf, dev)
    if resid is not None:
        check_tensor(resid, "resid", (M, N), bf, dev)
    out = torch.empty(M, N, dtype=bf, device=dev)
    err = kernels.lib("spatial_block").tpu1x_gemm_sm90(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), ptr(bias), ptr(resid), M,
        N, K, GEMM_ACTS[act], kernels.stream_of(a))
    kernels.check(err, "gemm_sm90")
    return out


def _check(x, wqkv, wproj, num_heads: int, bqkv=None, bproj=None,
           ln_scale=None, ln_bias=None, qk_ln_scale=None,
           qk_ln_bias=None) -> int:
    """What the kernel requires of its arguments (on any device: the card's
    wrapper calls it before a launch); returns the head_dim."""
    N, S, C = x.shape
    dev, bf = x.device, torch.bfloat16
    require(FLASH_MIN_TOKENS <= S <= FLASH_MAX_TOKENS and S % 64 == 0,
            f"spatial_block kernel needs S % 64 == 0 and "
            f"{FLASH_MIN_TOKENS} <= S <= {FLASH_MAX_TOKENS}, got S={S}")
    D = head_dim_of(C, num_heads, "spatial_block kernel")
    require(C % 64 == 0, f"spatial_block kernel needs C % 64 == 0, got {C}")
    require((ln_scale is None) == (ln_bias is None)
            and (qk_ln_scale is None) == (qk_ln_bias is None),
            "pass both params of a LayerNorm or neither")
    check_tensor(x, "x", (N, S, C), bf, dev)
    check_tensor(wqkv, "wqkv", (C, 3 * C), bf, dev)
    check_tensor(wproj, "wproj", (C, C), bf, dev)
    if bqkv is not None:
        check_tensor(bqkv, "bqkv", (3 * C,), bf, dev)
    if bproj is not None:
        check_tensor(bproj, "bproj", (C,), bf, dev)
    if ln_scale is not None:
        check_tensor(ln_scale, "ln_scale", (C,), torch.float32, dev)
        check_tensor(ln_bias, "ln_bias", (C,), torch.float32, dev)
    if qk_ln_scale is not None:
        check_tensor(qk_ln_scale, "qk_ln_scale", (D,), torch.float32, dev)
        check_tensor(qk_ln_bias, "qk_ln_bias", (D,), torch.float32, dev)
    return D


def spatial_block(x: torch.Tensor, wqkv: torch.Tensor, wproj: torch.Tensor, *,
                  num_heads: int, scale: float,
                  bqkv: Optional[torch.Tensor] = None,
                  bproj: Optional[torch.Tensor] = None,
                  ln_scale: Optional[torch.Tensor] = None,
                  ln_bias: Optional[torch.Tensor] = None,
                  qk_ln_scale: Optional[torch.Tensor] = None,
                  qk_ln_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, S, C) -> x + proj(mha(qkv(ln(x)))), with the optional
    LayerNorm of q and k over head_dim (one pair of parameters shared by q,
    k and all heads) that the qk_norm models have in place of the pre-LN.

    CPU tensors take `spatial_block_plain`. CUDA tensors launch
    csrc/spatial_block.cu, which replaces the Pallas kernel
    tpu1x/ops/spatial_block.py:spatial_block. It takes bf16 x and weights
    ((C, 3C), (C, C), biases (3C,), (C,) or None), fp32 LN params (C,) or
    None, fp32 qk-LN params (head_dim,) or None, S % 64 == 0 with 64 <= S
    <= 4096 (K9's range: whole frames in shared memory up to 256 tokens,
    key chunks streamed past it), head_dim 32, 64 or 128 and C % 64 == 0
    (`_check`).

    Bound on the H100: tensor-core operations. One row is 256 KB in bf16
    at S = 256 (1 MB at 1024), more than a block's shared memory, so the
    TPU's one-program-per-row design becomes launches whose intermediates
    stay in L2: the pre-LN as a row pass (K5's kernel), the qkv product on a TMA-fed wgmma GEMM
    (csrc/gemm_sm90.cuh), with the qk-LN a row pass over each head row of
    the q and k thirds of qkv in place (layer_norm.cuh's head_norm_kernel),
    the attention (K9's flash forward on the q, k, v thirds of qkv), and
    the proj product + bias + residual on the same GEMM; the (N, H, S, S)
    logits never leave the SM.
    """
    if not x.is_cuda:
        return spatial_block_plain(x, wqkv, wproj, num_heads=num_heads,
                                   scale=scale, bqkv=bqkv, bproj=bproj,
                                   ln_scale=ln_scale, ln_bias=ln_bias,
                                   qk_ln_scale=qk_ln_scale,
                                   qk_ln_bias=qk_ln_bias)
    _check(x, wqkv, wproj, num_heads, bqkv, bproj, ln_scale, ln_bias,
           qk_ln_scale, qk_ln_bias)
    N, S, C = x.shape
    dev, bf = x.device, torch.bfloat16
    # the pre-LN's output, then the flash attention's lse
    xn = torch.empty_like(x)
    qkv = torch.empty(N, S, 3 * C, dtype=bf, device=dev)
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    err = kernels.lib("spatial_block").tpu1x_spatial_block(
        x.data_ptr(), wqkv.data_ptr(), ptr(bqkv), wproj.data_ptr(), ptr(bproj),
        ptr(ln_scale), ptr(ln_bias), ptr(qk_ln_scale), ptr(qk_ln_bias),
        xn.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
        out.data_ptr(), N, S, C, num_heads, scale, kernels.stream_of(x))
    kernels.check(err, "spatial_block")
    kernels.count("spatial_block")
    return out
