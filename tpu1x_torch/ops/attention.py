"""Multi-head attention over (..., N, H, D): the plain version, which is
also the oracle that the other attention kernels' plain versions build on,
and the fused kernel pair (forward and backward) for the card."""

from __future__ import annotations

import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops import remat
from tpu1x_torch.ops._util import HEAD_DIMS, require

NEG_INF = torch.finfo(torch.float32).min
# `mha` sends fewer tokens than this (the frame axis, T = 16) to the plain
# version
FLASH_MIN_TOKENS = 64
# the most tokens the flash kernels take (csrc/flash_attention.cuh FA_MAXN)
FLASH_MAX_TOKENS = 4096


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = False) -> torch.Tensor:
    """Attention over axis -3 of q, k, v shaped (..., N, H, D).

    Logits and softmax are fp32; the probabilities are cast to v's dtype
    before the PV product, which accumulates in fp32. Returns v's dtype.
    """
    out_dtype = v.dtype
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float())
    logits = logits * scale
    if causal:
        n = q.shape[-3]
        mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(out_dtype)
    out = torch.einsum("...hqk,...khd->...qhd", probs.float(), v.float())
    return out.to(out_dtype)


def mha_lse_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: float, causal: bool = False):
    """`mha_reference` and the residual that the fused backward starts
    from: (o, lse), lse (..., H, N) fp32, the natural log of the sum over
    the keys in view of exp(scale q.k), for each query."""
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float())
    logits = logits * scale
    if causal:
        n = q.shape[-3]
        mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, NEG_INF)
    return (mha_reference(q, k, v, scale=scale, causal=causal),
            torch.logsumexp(logits, dim=-1))


def flash_mha_bwd_plain(q, k, v, o, lse, dout, *, scale: float,
                        causal: bool):
    """The fused backward's arithmetic in plain torch: from the residuals o
    and lse (`mha_lse_reference`), p = exp(scale q.k - lse), delta =
    sum_d dout o, ds = p (dout.v - delta); dv = p^T dout, dq = scale ds k,
    dk = scale ds^T q. p and ds are rounded to dout's dtype for their
    products, as the kernel rounds them to bf16; fp32 inputs keep fp32, the
    JAX VJP's arithmetic. Returns (dq, dk, dv) in q's dtype and shape."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    logits = torch.einsum("...qhd,...khd->...hqk", qf, kf) * scale
    p = torch.exp(logits - lse.float().unsqueeze(-1))
    if causal:
        n = q.shape[-3]
        mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        p = p.masked_fill(~mask, 0.0)
    delta = torch.einsum("...qhd,...qhd->...hq", gf, o.float())
    dp = torch.einsum("...qhd,...khd->...hqk", gf, vf)
    ds = p * (dp - delta.unsqueeze(-1))
    p, ds = (t.to(dout.dtype).float() for t in (p, ds))
    dv = torch.einsum("...hqk,...qhd->...khd", p, gf)
    dq = torch.einsum("...hqk,...khd->...qhd", ds, kf) * scale
    dk = torch.einsum("...hqk,...qhd->...khd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _rows(t: torch.Tensor, name: str, shape, writable: bool = False):
    """`t` as (R, N, H, D) with its leading axes folded into one (a view
    where the strides allow it, as they do for a third of a qkv product),
    checked for what the kernels read; returns (tensor, row stride, token
    stride). A `writable` tensor (an output) must fold into a view."""
    require(t.is_cuda and t.dtype == torch.bfloat16
            and tuple(t.shape) == tuple(shape),
            f"{name} must be a bf16 CUDA tensor of shape {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    N, H, D = shape[-3:]
    folded = t.reshape(-1, N, H, D)
    require(not writable or folded.data_ptr() == t.data_ptr(),
            f"{name}: its leading axes must fold into one row axis without "
            f"a copy, got strides {t.stride()}")
    rs, ts, hs, ds = folded.stride()
    require(ds == 1 and hs == D and rs % 8 == 0 and ts % 8 == 0
            and folded.data_ptr() % 16 == 0,
            f"{name}: strides {folded.stride()} must be (8 i, 8 j, {D}, 1) "
            f"and the data 16-byte aligned")
    return folded, rs, ts


def _check_shape(q, k, v):
    N, H, D = q.shape[-3:]
    require(k.shape == q.shape and v.shape == q.shape,
            "q, k, v must share one shape")
    require(D in HEAD_DIMS,
            f"the flash attention kernels need head_dim 32, 64 or 128, got "
            f"head_dim={D}")
    require(FLASH_MIN_TOKENS <= N <= FLASH_MAX_TOKENS and N % 64 == 0,
            f"the flash attention kernels need N % 64 == 0 and "
            f"{FLASH_MIN_TOKENS} <= N <= {FLASH_MAX_TOKENS}, got N={N}")


def _lse_shape(q):
    *lead, N, H, _ = q.shape
    return (*lead, H, N)


def flash_mha_fwd(q, k, v, *, scale: float, causal: bool):
    """Check, launch the forward kernel on CUDA q, k, v (..., N, H, D),
    head_dim D 32, 64 or 128, and count it. Returns (o, lse): o contiguous of
    q's shape, lse fp32 (..., H, N) as `mha_lse_reference` gives it. CPU
    tensors take `mha_lse_reference` and count nothing."""
    if not q.is_cuda:
        return mha_lse_reference(q, k, v, scale=scale, causal=causal)
    _check_shape(q, k, v)
    N, H, D = q.shape[-3:]
    (q4, rsq, tsq), (k4, rsk, tsk), (v4, rsv, tsv) = (
        _rows(t, name, q.shape) for name, t in (("q", q), ("k", k), ("v", v)))
    out = torch.empty(q4.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(_lse_shape(q), dtype=torch.float32, device=q.device)
    err = kernels.lib("flash_attention").tpu1x_flash_mha(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
        lse.data_ptr(), rsq, tsq, rsk, tsk, rsv, tsv, q4.shape[0], N, H, D,
        scale, int(causal), kernels.stream_of(q))
    kernels.check(err, "flash_mha")
    kernels.count("flash_mha")
    return out.view(q.shape), lse


def flash_mha_bwd(q, k, v, o, lse, dout, *, scale: float, causal: bool,
                  out=None):
    """Check, launch the backward kernel on the forward's inputs and
    residuals (o, lse) and the output's gradient, and count it. Returns
    (dq, dk, dv) of q's shape: new contiguous tensors, or with `out` the
    three given tensors (views such as the thirds of one qkv gradient),
    written in place. CPU tensors take `flash_mha_bwd_plain` and count
    nothing."""
    if out is not None:
        require(len(out) == 3 and all(
            tuple(t.shape) == tuple(q.shape) and t.dtype == q.dtype
            and t.device == q.device for t in out),
            "out must be three tensors of q's shape, dtype and device")
    if not q.is_cuda:
        grads = flash_mha_bwd_plain(q, k, v, o, lse, dout, scale=scale,
                                    causal=causal)
        if out is None:
            return grads
        for t, g in zip(out, grads):
            t.copy_(g)
        return tuple(out)
    _check_shape(q, k, v)
    N, H, D = q.shape[-3:]
    (q4, rsq, tsq), (k4, rsk, tsk), (v4, rsv, tsv), (o4, rso, tso), \
        (g4, rsg, tsg) = (
            _rows(t, name, q.shape) for name, t in (
                ("q", q), ("k", k), ("v", v), ("o", o), ("dout", dout)))
    require(lse.is_cuda and lse.dtype == torch.float32
            and tuple(lse.shape) == _lse_shape(q) and lse.is_contiguous(),
            f"lse must be a contiguous fp32 CUDA tensor of shape "
            f"{_lse_shape(q)}")
    if out is None:
        out = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device)
                    for _ in range(3))
    (dq4, rsdq, tsdq), (dk4, rsdk, tsdk), (dv4, rsdv, tsdv) = (
        _rows(t, name, q.shape, writable=True)
        for name, t in zip(("dq", "dk", "dv"), out))
    work = torch.empty_like(lse)  # delta, from the dq pass to the dk/dv pass
    err = kernels.lib("flash_attention").tpu1x_flash_mha_bwd(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
        g4.data_ptr(), lse.data_ptr(), dq4.data_ptr(), dk4.data_ptr(),
        dv4.data_ptr(), work.data_ptr(), rsq, tsq, rsk, tsk, rsv, tsv, rso,
        tso, rsg, tsg, rsdq, tsdq, rsdk, tsdk, rsdv, tsdv, q4.shape[0], N, H,
        D, scale, int(causal), kernels.stream_of(q))
    kernels.check(err, "flash_mha_bwd")
    kernels.count("flash_mha_bwd")
    return tuple(out)


class _FlashMha(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        ctx.args = dict(scale=scale, causal=causal)
        # under remat "attn_outs" the rerun takes both residuals from the
        # first run, so K10 runs without K9 (the kernel is no dot to JAX)
        out, lse = remat.keep(frozenset({"attn_out"}),
                              lambda: flash_mha_fwd(q, k, v, **ctx.args))
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return (*flash_mha_bwd(*ctx.saved_tensors, dout.contiguous(),
                               **ctx.args), None, None)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool = False) -> torch.Tensor:
    """`mha_reference`'s contract, fused and differentiable: q, k, v
    (..., N, H, D) with any leading axes, softmax(q k^T scale [causal]) v
    per (row, head), in v's dtype.

    CPU tensors take `mha_reference` under ordinary autograd. CUDA tensors
    launch csrc/flash_attention.cu, which replaces the Pallas kernels
    tpu1x/ops/pallas_attention.py:_flash_mha_bhnd (forward) and, under
    autograd, _flash_mha_bwd_bhnd (backward). The card path takes bf16,
    head_dim 32, 64 or 128, N % 64 == 0 and 64 <= N <= 4096
    (FLASH_MAX_TOKENS);
    fp32 inputs are for the CPU.
    q, k and v are read where they lie, each with its own strides (the last
    two axes contiguous, the others multiples of 8 that fold into one row
    stride), so the v third of a (rows, N, 3, H, D) qkv product needs no
    copy; the output and the gradients are new contiguous tensors here
    (`flash_mha_bwd` also writes into given views). The residuals
    are q, k, v, the output o (which the caller's next product keeps
    anyway) and the per-query log-sum-exp lse (4 bytes a query and head).

    The forward multiplies q k^T exactly (bf16 operands, fp32
    accumulation) and keeps the softmax in fp32 with a running max over
    64-key chunks; it rounds the unnormalised p to bf16 for p v and divides
    by the row sum of the rounded p at the end, where the TPU kernel rounds
    the normalised p. On the H100, up to N = 256, it is persistent blocks
    of two warpgroups, each (row, head) loaded once by TMA into a two-stage
    ring (one stage at head_dim 64, two blocks an SM) while the one before
    computes, both products on wgmma, o stored by TMA; its floors are the
    bytes (q, k, v, o once each) and the exponentials, about equal. Past
    256 (and at every N at head_dim 128, whose tiles lie as two 64-channel
    halves) a block takes 128 queries of a (row, head) and streams the keys
    and values in 64-token chunks through a four-stage TMA ring; the
    exponentials bound it at head_dim 32. The backward
    (`flash_mha_bwd_plain`'s arithmetic) takes p from lse with one
    exponential a logit and delta = sum d_o o, in two passes on wgmma, one
    query-major for dq (which also writes delta) and one key-major for dk
    and dv, each keeping its 64-token tile's sums in registers and
    streaming the other operands in 64-token chunks (seven products where
    the TPU kernel makes five); it rounds p and ds to bf16 for its
    products, where the TPU kernel keeps them fp32. Nothing N x N reaches
    device memory either way; PERF.md has both kernels' times against
    their floors and against SDPA.
    """
    if not q.is_cuda:
        return remat.attention(mha_reference, q, k, v, scale=scale,
                               causal=causal)
    return _FlashMha.apply(q, k, v, scale, causal)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
        causal: bool = False) -> torch.Tensor:
    """Attention over axis -3: `flash_mha` from FLASH_MIN_TOKENS tokens up
    (the spatial axis, S = 64 to 4096), `mha_reference` below (at T = 16
    the kernel's grid of one block per (row, head) would be all launch and
    no work), as the JAX package chooses."""
    if q.shape[-3] >= FLASH_MIN_TOKENS:
        return flash_mha(q, k, v, scale=scale, causal=causal)
    return remat.attention(mha_reference, q, k, v, scale=scale,
                           causal=causal)
