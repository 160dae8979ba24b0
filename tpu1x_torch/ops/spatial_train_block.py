"""Spatial sub-layer of an STBlock for training: x + proj(MHA(qkv(LN1(x))))
over (N = B T, S, C), differentiable, with a hand-written backward on the
card that returns dx and every weight, bias and LayerNorm gradient."""

from __future__ import annotations

from typing import Optional

import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops import _train_kernels as tk
from tpu1x_torch.ops.attention import flash_mha_bwd, flash_mha_fwd
from tpu1x_torch.ops._util import require
from tpu1x_torch.ops.remat import keep
from tpu1x_torch.ops.spatial_block import (gemm_sm90, spatial_block,
                                           spatial_block_plain)

# The plain version is the serving block's: the same function, and ordinary
# autograd differentiates it.
spatial_train_block_plain = spatial_block_plain


def spatial_train_block_steps(x, dout, wqkv, wproj, bqkv, ln_scale, ln_bias,
                              *, num_heads: int, scale: float,
                              proj_bias: bool):
    """The backward's launch sequence as a generator (run it with
    `tk.through`): x, dout (N, S, C) and weights in x's dtype, fp32 LN
    params; wqkv (C, 3C') and wproj (C', C) hold `num_heads` heads, C' = C
    in one process and a rank's share of the heads under tensor parallelism
    (parallel/tensor.py). It yields d_xn, the fp32 gradient of the LN's
    output (a rank's partial), once, and takes back the sum over the model
    group. Returns (dx in x's dtype, dwqkv, dwproj, dbqkv, dbproj,
    dln_scale, dln_bias), all but dx in fp32; a bias gradient is None
    without its bias.

    Launches, in order: LN1 over rows (`tk.ln_fwd`, whose statistics the
    LN backward takes); qkv = xn Wqkv + b on the serving instantiation
    of csrc/gemm_sm90.cuh (`gemm_sm90`, the forward's rounding chain, so
    that qkv is the forward's bit for bit); o and lse from K9's forward
    (`flash_mha_fwd`) on the q, k and v thirds of qkv read in place, the
    forward's o exactly; d_o = dout Wproj^T; K10's backward
    (`flash_mha_bwd`), which writes dq, dk and dv into the thirds of one
    (N, S, 3C') dqkv; dWproj = o^T dout and dWqkv = xn^T dqkv (split
    reductions with fp32 atomics); the bias column sums; d_xn = dqkv Wqkv^T
    in fp32; the LN backward, which adds the residual's dout and sums the
    LN gradients. Every product but the qkv recompute is a training form
    of the same GEMM (`tk.gemm90`). CPU tensors run the same sequence on
    the launchers' plain versions, in x's dtype.
    """
    N, S, C = x.shape
    rows = N * S
    x2, do2 = x.reshape(rows, C), dout.reshape(rows, C)
    xn, stats = tk.ln_fwd(x2, ln_scale, ln_bias)
    qkv = gemm_sm90(xn, wqkv, bqkv).view(N, S, 3, num_heads, -1)
    q, k, v = qkv.unbind(2)
    o, lse = flash_mha_fwd(q, k, v, scale=scale, causal=False)
    d_o = tk.gemm90(do2, wproj, form="nt")
    dqkv = torch.empty_like(qkv)
    flash_mha_bwd(q, k, v, o, lse, d_o.view(o.shape), scale=scale,
                  causal=False, out=dqkv.unbind(2))
    dqkv2 = dqkv.view(rows, -1)
    dwproj = tk.gemm90(o.reshape(rows, -1), do2, form="tn")
    dbproj = tk.col_sum(do2) if proj_bias else None
    dwqkv = tk.gemm90(xn, dqkv2, form="tn")
    dbqkv = tk.col_sum(dqkv2) if bqkv is not None else None
    d_xn = yield tk.gemm90(dqkv2, wqkv, form="nt", fp32_out=True)
    dx, dln_s, dln_b = tk.ln_bwd(x2, stats, ln_scale, d_xn, do2)
    return dx.view(N, S, C), dwqkv, dwproj, dbqkv, dbproj, dln_s, dln_b


def spatial_train_block_bwd(x, dout, wqkv, wproj, bqkv, ln_scale, ln_bias, *,
                            num_heads: int, scale: float, proj_bias: bool):
    """The backward in one process: `spatial_train_block_steps` with
    wqkv (C, 3C) and wproj (C, C), its d_xn taken as it is."""
    grads = tk.through(spatial_train_block_steps(
        x, dout, wqkv, wproj, bqkv, ln_scale, ln_bias, num_heads=num_heads,
        scale=scale, proj_bias=proj_bias))
    if x.is_cuda:
        kernels.count("spatial_train_block_bwd")
    return grads


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
        return keep(frozenset({"attn_out"}), lambda: spatial_block(
            x, w[0], w[1], bqkv=w[2], bproj=tk.as_bf16(bproj), ln_scale=w[3],
            ln_bias=w[4], **ctx.args))

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
    arithmetic). The card path takes bf16 x, S % 64 == 0 with 64 <= S <=
    4096 (K9's and K10's range), head_dim 32, 64, 72 or 128, C % 64 == 0 (K1's
    forward), C <= MAX_C (4096, `_util.MAX_C`: the LN row kernels, a warp
    a row up to 2048, a pair of warps past it); its backward's products take
    a rank's share of the heads under tensor parallelism, C' % 8 == 0
    (`spatial_train_block_steps`, `_util.gemm_shape_ok`),
    and needs the LN params (the qk_norm configs,
    which have none, train through `flash_mha` instead). Residuals are x and
    the weights only; the backward recomputes LN1, qkv, the attention
    output and its log-sum-exp, and the (N, H, S, S) probabilities never
    reach device memory. Bound on the H100: tensor-core operations (the
    weight products, and the attention's forward and five backward
    products of 2 S S D each per head). The attention backward rounds p and
    ds to bf16 for its products and takes delta from the bf16 o (K10's
    contract, `flash_mha`). The weight and LN gradients are summed with fp32
    atomics, so their last bits differ from run to run.
    """
    if not x.is_cuda:
        return spatial_train_block_plain(
            x, wqkv, wproj, num_heads=num_heads, scale=scale, bqkv=bqkv,
            bproj=bproj, ln_scale=ln_scale, ln_bias=ln_bias)
    require(ln_scale is not None and ln_bias is not None,
            "the spatial train block on the card needs the LN1 parameters")
    return _SpatialTrainBlock.apply(x.contiguous(), wqkv, wproj, bqkv, bproj,
                                    ln_scale, ln_bias, num_heads, scale)
