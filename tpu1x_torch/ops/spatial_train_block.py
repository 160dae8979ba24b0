"""Spatial sub-layer of an STBlock for training: x + proj(MHA(qkv(LN1(x))))
over (N = B T, S, C), differentiable, with a hand-written backward on the
card that returns dx and every weight, bias and LayerNorm gradient."""

from __future__ import annotations

from typing import Optional

import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops import _train_kernels as tk
from tpu1x_torch.ops._util import require
from tpu1x_torch.ops.spatial_block import spatial_block, spatial_block_plain

# The plain version is the serving block's: the same function, and ordinary
# autograd differentiates it.
spatial_train_block_plain = spatial_block_plain


def spatial_attention_bwd(qkv: torch.Tensor, d_o: torch.Tensor, *,
                          num_heads: int, scale: float):
    """qkv (N, S, 3C), d_o (N, S, C) bf16 on the card -> (dqkv (N, S, 3C),
    o (N, S, C)): the attention's gradients and its recomputed output."""
    N, S, C3 = qkv.shape
    C = C3 // 3
    require(S == 256 and C == 32 * num_heads,
            f"spatial attention backward needs S == 256 and head_dim 32, got "
            f"S={S}, C={C}, heads={num_heads}")
    for name, t in (("qkv", qkv), ("d_o", d_o)):
        require(t.is_cuda and t.dtype == torch.bfloat16 and t.is_contiguous()
                and t.data_ptr() % 16 == 0,
                f"{name} must be contiguous, 16-byte aligned bf16 on the card")
    dqkv = torch.empty_like(qkv)
    o = torch.empty_like(d_o)
    err = kernels.lib("spatial_block").tpu1x_spatial_attention_bwd(
        qkv.data_ptr(), d_o.data_ptr(), dqkv.data_ptr(), o.data_ptr(), N, S,
        C, num_heads, scale, kernels.stream_of(qkv))
    kernels.check(err, "spatial_attention_bwd")
    return dqkv, o


def spatial_train_block_bwd(x, dout, wqkv, wproj, bqkv, ln_scale, ln_bias, *,
                            num_heads: int, scale: float, proj_bias: bool):
    """The backward on the card: bf16 x, dout (N, S, C) and weights, fp32 LN
    params. Returns (dx bf16, dwqkv, dwproj, dbqkv, dbproj, dln_scale,
    dln_bias), all but dx in fp32; a bias gradient is None without its bias.

    Launches, in order: LN1 over rows; the qkv GEMM (recompute, the forward's
    rounding); d_o = dout Wproj^T; the attention backward per (row, head),
    which also recomputes the attention output; dWproj = o^T dout and
    dWqkv = LN1(x)^T dqkv (split reductions with fp32 atomics); the bias
    column sums; d_xn = dqkv Wqkv^T in fp32; the LN backward, which adds the
    residual's dout and sums the LN gradients.
    """
    N, S, C = x.shape
    rows = N * S
    x2, do2 = x.reshape(rows, C), dout.reshape(rows, C)
    xn, stats = tk.ln_fwd(x2, ln_scale, ln_bias)
    qkv = tk.gemm(xn, wqkv, bias=bqkv, fused=False)
    d_o = tk.gemm(do2, wproj, mode="nt")
    dqkv, o = spatial_attention_bwd(qkv.view(N, S, 3 * C), d_o.view(N, S, C),
                                    num_heads=num_heads, scale=scale)
    dqkv2 = dqkv.view(rows, 3 * C)
    dwproj = tk.gemm(o.view(rows, C), do2, mode="tn")
    dbproj = tk.col_sum(do2) if proj_bias else None
    dwqkv = tk.gemm(xn, dqkv2, mode="tn")
    dbqkv = tk.col_sum(dqkv2) if bqkv is not None else None
    d_xn = tk.gemm(dqkv2, wqkv, mode="nt", fp32_out=True)
    dx, dln_s, dln_b = tk.ln_bwd(x2, stats, ln_scale, d_xn, do2)
    kernels.count("spatial_train_block_bwd")
    return dx.view(N, S, C), dwqkv, dwproj, dbqkv, dbproj, dln_s, dln_b


class _SpatialTrainBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, wproj, bqkv, bproj, ln_scale, ln_bias,
                num_heads, scale):
        # one bf16 copy of each weight serves the forward and the backward
        w = (tk.as_bf16(wqkv), tk.as_bf16(wproj), tk.as_bf16(bqkv),
             tk.as_f32(ln_scale), tk.as_f32(ln_bias))
        ctx.save_for_backward(x, *w)
        ctx.dtypes = tk.dtypes_of(wqkv, wproj, bqkv, bproj, ln_scale,
                                  ln_bias)
        ctx.args = dict(num_heads=num_heads, scale=scale)
        return spatial_block(x, w[0], w[1], bqkv=w[2], bproj=tk.as_bf16(bproj),
                             ln_scale=w[3], ln_bias=w[4], **ctx.args)

    @staticmethod
    def backward(ctx, dout):
        x, *w = ctx.saved_tensors
        grads = spatial_train_block_bwd(
            x, dout.contiguous(), *w, proj_bias=ctx.dtypes[3] is not None,
            **ctx.args)
        return (grads[0], *tk.like(grads[1:], ctx.dtypes), None, None)


def spatial_train_block(x: torch.Tensor, wqkv: torch.Tensor,
                        wproj: torch.Tensor, *, num_heads: int, scale: float,
                        bqkv: Optional[torch.Tensor] = None,
                        bproj: Optional[torch.Tensor] = None,
                        ln_scale: Optional[torch.Tensor] = None,
                        ln_bias: Optional[torch.Tensor] = None):
    """Differentiable x (N, S, C) -> x + proj(mha(qkv(ln(x)))).

    wqkv (C, 3C), wproj (C, C) and the optional biases and LN params may be
    fp32 master parameters: gradients come back in each parameter's dtype,
    accumulated in fp32.

    CPU tensors take `spatial_train_block_plain` under ordinary autograd.
    CUDA tensors launch the `spatial_block` kernel forward and, under
    autograd, `spatial_train_block_bwd`, which replaces the Pallas kernel
    tpu1x/ops/spatial_train_block.py:_spatial_bwd (_bwd_kernel, default
    arithmetic). The card path takes bf16 x, S == 256, head_dim 32,
    C % 64 == 0, C <= 1024 and needs the LN params (the qk_norm configs,
    which have none, are not on the card yet). Residuals are x and the
    weights only; the backward recomputes LN1, qkv and the probabilities,
    and the (N, H, S, S) probabilities never reach device memory. Bound on
    the H100: tensor-core operations (the GEMMs and the attention's eight
    S x S x 32 products per head). The weight and LN gradients are summed
    with fp32 atomics, so their last bits differ from run to run.
    """
    if not x.is_cuda:
        return spatial_train_block_plain(
            x, wqkv, wproj, num_heads=num_heads, scale=scale, bqkv=bqkv,
            bproj=bproj, ln_scale=ln_scale, ln_bias=ln_bias)
    require(ln_scale is not None and ln_bias is not None,
            "the spatial train block on the card needs the LN1 parameters")
    return _SpatialTrainBlock.apply(x.contiguous(), wqkv, wproj, bqkv, bproj,
                                    ln_scale, ln_bias, num_heads, scale)
