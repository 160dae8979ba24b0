"""Temporal sub-layer of an STBlock for training:
x + proj(causal temporal MHA(qkv(x))) over (B, T, S, C), no pre-LN,
differentiable, forward and backward by hand on the card."""

from __future__ import annotations

from typing import Optional

import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops import _train_kernels as tk
from tpu1x_torch.ops import temporal_attention as ta
from tpu1x_torch.ops._util import dense
from tpu1x_torch.ops.remat import keep


def temporal_train_block_plain(x, wqkv, wproj, *, num_heads: int,
                               scale: float, bqkv=None, bproj=None):
    """The JAX package's `temporal_train_block_reference` in plain torch,
    differentiable by ordinary autograd."""
    C = x.shape[-1]
    q, k, v = dense(x, wqkv, bqkv).split(C, dim=-1)
    out = ta.temporal_attention_plain(q, k, v, scale=scale,
                                      num_heads=num_heads, causal=True)
    return x + dense(out, wproj, bproj)


def _qkv(x, wqkv, bqkv):
    """q, k, v: column views of one (B, T, S, 3C') product with bias, wqkv
    (C, 3C')."""
    B, T, S, C = x.shape
    qkv = tk.gemm90(x.reshape(-1, C), wqkv, bias=bqkv)
    return qkv.view(B, T, S, -1).split(wqkv.shape[1] // 3, dim=-1)


def temporal_train_block_fwd(x, wqkv, wproj, bqkv, bproj, *, num_heads: int,
                             scale: float):
    """The forward, x (B, T, S, C) and weights in x's dtype: the qkv
    product with bias, the temporal attention kernel (K4) on column views of
    qkv, the proj product with bias and residual, both products on the
    training forms of csrc/gemm_sm90.cuh (`tk.gemm90`: the bias added in
    fp32, one rounding, then the residual). CPU tensors run the same
    sequence on the launchers' plain versions and count nothing."""
    C = x.shape[-1]
    ao = ta.launch_forward(*_qkv(x, wqkv, bqkv), scale=scale,
                           num_heads=num_heads, causal=True)
    out = tk.gemm90(ao.reshape(-1, C), wproj, bias=bproj,
                    resid=x.reshape(-1, C))
    if x.is_cuda:
        kernels.count("temporal_train_block")
    return out.view(x.shape)


def temporal_train_block_steps(x, dout, wqkv, wproj, bqkv, *, num_heads: int,
                               scale: float, proj_bias: bool,
                               split: bool = False):
    """The backward's launch sequence as a generator (run it with
    `tk.through`): wqkv (C, 3C') and wproj (C', C) hold `num_heads` heads,
    C' = C in one process and a rank's share of the heads under tensor
    parallelism (`split`, parallel/tensor.py). Returns (dx in x's dtype,
    dwqkv, dwproj, dbqkv, dbproj) with the weight and bias gradients in
    fp32.

    Launches: the qkv product (recompute); d_ao = dout Wproj^T; the
    temporal attention backward (K6), which writes dq, dk, dv into one
    (B, T, S, 3C') tensor and the attention output ao (the forward's, bit
    for bit: it feeds dWproj) beside them; dWproj = ao^T dout and dWqkv =
    x^T dqkv (split reductions, fp32 atomics); the bias column sums; dx =
    dout + dqkv Wqkv^T, in one process from the last product's residual
    epilogue, when `split` from its fp32 store, which the sequence yields
    and takes back summed over the model group before the residual is
    added (`tk.epilogue`). The products are the training forms of
    csrc/gemm_sm90.cuh (nn, nt, tn). CPU tensors run the same sequence on
    the plain versions.
    """
    C = x.shape[-1]
    x2, do2 = x.reshape(-1, C), dout.reshape(-1, C)
    q, k, v = _qkv(x, wqkv, bqkv)
    d_ao = tk.gemm90(do2, wproj, form="nt").view(q.shape)
    ao = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dqkv2 = ta.launch_backward(q, k, v, d_ao, scale=scale,
                               num_heads=num_heads, causal=True,
                               o=ao).view(-1, wqkv.shape[1])
    dwproj = tk.gemm90(ao.reshape(-1, wproj.shape[0]), do2, form="tn")
    dbproj = tk.col_sum(do2) if proj_bias else None
    dwqkv = tk.gemm90(x2, dqkv2, form="tn")
    dbqkv = tk.col_sum(dqkv2) if bqkv is not None else None
    if split:
        part = yield tk.gemm90(dqkv2, wqkv, form="nt", fp32_out=True)
        dx = tk.epilogue(part, None, do2)
    else:
        dx = tk.gemm90(dqkv2, wqkv, form="nt", resid=do2)
    return dx.view(x.shape), dwqkv, dwproj, dbqkv, dbproj


def temporal_train_block_bwd(x, dout, wqkv, wproj, bqkv, *, num_heads: int,
                             scale: float, proj_bias: bool):
    """The backward in one process: `temporal_train_block_steps` with
    wqkv (C, 3C) and wproj (C, C)."""
    grads = tk.through(temporal_train_block_steps(
        x, dout, wqkv, wproj, bqkv, num_heads=num_heads, scale=scale,
        proj_bias=proj_bias))
    if x.is_cuda:
        kernels.count("temporal_train_block_bwd")
    return grads


class _TemporalTrainBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, wproj, bqkv, bproj, num_heads, scale):
        w = (tk.as_bf16(wqkv), tk.as_bf16(wproj), tk.as_bf16(bqkv))
        ctx.save_for_backward(x, *w)
        ctx.dtypes = tk.dtypes_of(wqkv, wproj, bqkv, bproj)
        ctx.args = dict(num_heads=num_heads, scale=scale)
        return keep(frozenset({"attn_out"}), lambda: temporal_train_block_fwd(
            x, *w, tk.as_bf16(bproj), **ctx.args))

    @staticmethod
    def backward(ctx, dout):
        x, *w = ctx.saved_tensors
        grads = temporal_train_block_bwd(
            x, dout.contiguous(), *w, proj_bias=ctx.dtypes[3] is not None,
            **ctx.args)
        return (grads[0], *tk.like(grads[1:], ctx.dtypes), None, None)


def temporal_train_block(x: torch.Tensor, wqkv: torch.Tensor,
                         wproj: torch.Tensor, *, num_heads: int, scale: float,
                         bqkv: Optional[torch.Tensor] = None,
                         bproj: Optional[torch.Tensor] = None):
    """Differentiable x (B, T, S, C) -> x + proj(causal MHA over T of
    qkv(x)), heads flat in C, no pre-norm.

    wqkv (C, 3C), wproj (C, C) and the optional biases may be fp32 master
    parameters: gradients come back in each parameter's dtype.

    CPU tensors take `temporal_train_block_plain` under ordinary autograd.
    CUDA tensors launch `temporal_train_block_fwd` and, under autograd,
    `temporal_train_block_bwd`, which replace the Pallas kernels
    tpu1x/ops/temporal_train_block.py:_ttb_fwd and _ttb_bwd. They take bf16
    contiguous x, T <= 32, head_dim 32, 64 or 128 and an even number of
    heads;
    the products run on
    the training forms of csrc/gemm_sm90.cuh. Residuals are x and
    the weights only. The TPU kernels keep q, k, v and their gradients in
    VMEM; here they make one round trip through device memory as one
    (B, T, S, 3C) tensor each, whose column views the attention kernels
    read and write in place. Bound on the H100: tensor-core operations for
    the GEMMs, device memory for the attention kernels. The weight
    gradients are summed with fp32 atomics, so their last bits differ from
    run to run.
    """
    if not x.is_cuda:
        return temporal_train_block_plain(x, wqkv, wproj, num_heads=num_heads,
                                          scale=scale, bqkv=bqkv, bproj=bproj)
    return _TemporalTrainBlock.apply(x.contiguous(), wqkv, wproj, bqkv, bproj,
                                     num_heads, scale)
