"""MLP sub-layer of an STBlock for training: x + fc2(GELU(fc1(LN2(x))))
over (N, S, C), differentiable, forward and backward by hand on the card."""

from __future__ import annotations

from typing import Optional

import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops import _train_kernels as tk
from tpu1x_torch.ops._util import gelu, require
from tpu1x_torch.ops.layernorm import layer_norm_plain


def mlp_train_block_plain(x, wfc1, wfc2, *, bfc1=None, bfc2=None,
                          ln_scale=None, ln_bias=None,
                          gelu_approx: bool = False):
    """The JAX package's `mlp_train_block_reference` in plain torch: the
    bias and the GELU (exact erf unless `gelu_approx`) in fp32 on the
    product, one rounding to x's dtype; differentiable by ordinary
    autograd. The operands are rounded to x's dtype and multiplied in fp32,
    so that the product keeps its fp32 sum as the reference's does (a bf16
    `torch.matmul` would round it once more)."""
    cd = x.dtype
    xn = x if ln_scale is None else layer_norm_plain(x, ln_scale, ln_bias)
    h = torch.matmul(xn.float(), wfc1.to(cd).float())
    if bfc1 is not None:
        h = h + bfc1.float()
    g = gelu(h, gelu_approx).to(cd)
    y = torch.matmul(g.float(), wfc2.to(cd).float())
    if bfc2 is not None:
        y = y + bfc2.float()
    return x + y.to(cd)


def _act(gelu_approx: bool, derivative: bool = False) -> str:
    return ("dgelu_" if derivative else "gelu_") + (
        "tanh" if gelu_approx else "erf")


def mlp_train_block_fwd(x, wfc1, wfc2, bfc1, bfc2, ln_scale, ln_bias, *,
                        gelu_approx: bool):
    """The forward, bf16 x (N, S, C) and weights, fp32 LN params or None:
    LN2 as a row pass (when there is an LN), the fc1 product with bias and
    GELU in its epilogue, then the fc2 product with bias and residual, both
    on the training forms of csrc/gemm_sm90.cuh. The GELU is exact `erff`
    (the TPU kernel's rational erf stands in for an erf that Mosaic lacks,
    and is not copied). CPU tensors run the same sequence on the launchers'
    plain versions, in x's dtype, and count nothing."""
    C = x.shape[-1]
    x2 = x.reshape(-1, C)
    xn = x2 if ln_scale is None else tk.ln_fwd(x2, ln_scale, ln_bias)[0]
    h = tk.gemm90(xn, wfc1, bias=bfc1, act=_act(gelu_approx))
    out = tk.gemm90(h, wfc2, bias=bfc2, resid=x2)
    if x.is_cuda:
        kernels.count("mlp_train_block")
    return out.view(x.shape)


def mlp_train_block_steps(x, dout, wfc1, wfc2, bfc1, ln_scale, ln_bias, *,
                          gelu_approx: bool, bias: bool, split: bool = False):
    """The backward's launch sequence as a generator (run it with
    `tk.through`): wfc1 (C, F) and wfc2 (F, C), F the hidden width in one
    process and a rank's share of it under tensor parallelism (`split`,
    parallel/tensor.py). Returns (dx in x's dtype, dwfc1, dwfc2, dbfc1,
    dbfc2, dln_scale, dln_bias), all but dx in fp32.

    Launches: LN2 over rows, the forward's row pass; the fc1 product
    (recompute), which writes both GELU(h) and the rounded pre-activation h;
    dWfc2 = g^T dout; d_h = (dout Wfc2^T) GELU'(h), the derivative in the
    product's epilogue in fp32; dWfc1 = LN2(x)^T d_h; the bias column sums;
    d_xn = d_h Wfc1^T in fp32, which the sequence yields and takes back
    summed over the model group; the LN backward with the residual's dout
    and the LN gradients. Without LN params the two LN launches go, and
    dx = dout + d_h Wfc1^T: in one process from the last product's
    residual epilogue (nothing yielded), when `split` from the summed fp32
    store (`tk.epilogue`); dln_scale and dln_bias are None. The products
    run on the training forms of csrc/gemm_sm90.cuh (nn, tn, nt). The
    (rows, F) hidden goes through device memory (the TPU kernel keeps it in
    VMEM). CPU tensors run the same sequence on the plain versions.
    """
    C = x.shape[-1]
    x2, do2 = x.reshape(-1, C), dout.reshape(-1, C)
    has_ln = ln_scale is not None
    xn, stats = tk.ln_fwd(x2, ln_scale, ln_bias) if has_ln else (x2, None)
    g, h = tk.gemm90(xn, wfc1, bias=bfc1, act=_act(gelu_approx), pre_out=True)
    dwfc2 = tk.gemm90(g, do2, form="tn")
    d_h = tk.gemm90(do2, wfc2, form="nt", aux=h, act=_act(gelu_approx, True))
    dwfc1 = tk.gemm90(xn, d_h, form="tn")
    dbfc1 = tk.col_sum(d_h) if bias else None
    dbfc2 = tk.col_sum(do2) if bias else None
    dln_s = dln_b = None
    if has_ln or split:
        d_xn = yield tk.gemm90(d_h, wfc1, form="nt", fp32_out=True)
        if has_ln:
            dx, dln_s, dln_b = tk.ln_bwd(x2, stats, ln_scale, d_xn, do2)
        else:
            dx = tk.epilogue(d_xn, None, do2)
    else:
        dx = tk.gemm90(d_h, wfc1, form="nt", resid=do2)
    return dx.view(x.shape), dwfc1, dwfc2, dbfc1, dbfc2, dln_s, dln_b


def mlp_train_block_bwd(x, dout, wfc1, wfc2, bfc1, ln_scale, ln_bias, *,
                        gelu_approx: bool, bias: bool):
    """The backward in one process: `mlp_train_block_steps` with the whole
    hidden width."""
    grads = tk.through(mlp_train_block_steps(
        x, dout, wfc1, wfc2, bfc1, ln_scale, ln_bias, gelu_approx=gelu_approx,
        bias=bias))
    if x.is_cuda:
        kernels.count("mlp_train_block_bwd")
    return grads


class _MlpTrainBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wfc1, wfc2, bfc1, bfc2, ln_scale, ln_bias,
                gelu_approx):
        w = (tk.as_bf16(wfc1), tk.as_bf16(wfc2), tk.as_bf16(bfc1),
             tk.as_f32(ln_scale), tk.as_f32(ln_bias))
        ctx.save_for_backward(x, *w)
        ctx.dtypes = tk.dtypes_of(wfc1, wfc2, bfc1, bfc2, ln_scale, ln_bias)
        ctx.gelu_approx = gelu_approx
        return mlp_train_block_fwd(x, w[0], w[1], w[2], tk.as_bf16(bfc2),
                                   w[3], w[4], gelu_approx=gelu_approx)

    @staticmethod
    def backward(ctx, dout):
        x, *w = ctx.saved_tensors
        grads = mlp_train_block_bwd(
            x, dout.contiguous(), *w, gelu_approx=ctx.gelu_approx,
            bias=ctx.dtypes[2] is not None)
        return (grads[0], *tk.like(grads[1:], ctx.dtypes), None)


def mlp_train_block(x: torch.Tensor, wfc1: torch.Tensor, wfc2: torch.Tensor,
                    *, bfc1: Optional[torch.Tensor] = None,
                    bfc2: Optional[torch.Tensor] = None,
                    ln_scale: Optional[torch.Tensor] = None,
                    ln_bias: Optional[torch.Tensor] = None,
                    gelu_approx: bool = False):
    """Differentiable x (N, S, C) -> x + fc2(gelu(fc1(ln2(x)))).

    wfc1 (C, hidden), wfc2 (hidden, C), biases both or neither, LN params
    both or neither; all may be fp32 master parameters, and gradients come
    back in each parameter's dtype. `gelu_approx` picks the tanh form over
    the exact erf.

    CPU tensors take `mlp_train_block_plain` under ordinary autograd. CUDA
    tensors launch `mlp_train_block_fwd` and, under autograd,
    `mlp_train_block_bwd`, which replace the Pallas kernels
    tpu1x/ops/mlp_train_block.py:_mlp_fwd and _mlp_bwd. The card path takes
    bf16 contiguous x, C % 8 == 0, C <= MAX_C (4096, `_util.MAX_C`: the
    LN row kernels, a warp a row up to 2048, a pair of warps past it) and
    hidden % 8 == 0 (the GEMM, `_util.gemm_shape_ok`); the LN params are
    optional there too (the qk_norm configs have none).
    Residuals are x and the weights only. Bound on the H100:
    tensor-core operations (16 rows C hidden FLOP forward and recompute,
    8 more in each of the three backward products). The weight and LN
    gradients are summed with fp32 atomics, so their last bits differ from
    run to run.
    """
    require((bfc1 is None) == (bfc2 is None), "pass both MLP biases or neither")
    require((ln_scale is None) == (ln_bias is None),
            "pass both LN params or neither")
    if not x.is_cuda:
        return mlp_train_block_plain(x, wfc1, wfc2, bfc1=bfc1, bfc2=bfc2,
                                     ln_scale=ln_scale, ln_bias=ln_bias,
                                     gelu_approx=gelu_approx)
    return _MlpTrainBlock.apply(x.contiguous(), wfc1, wfc2, bfc1, bfc2,
                                ln_scale, ln_bias, gelu_approx)
