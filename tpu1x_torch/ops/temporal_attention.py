"""Attention over the frame axis of (B, T, S, C), causal or not, heads flat
(the serving prefill's temporal attention, and the attention part of the
temporal train block), differentiable: forward and backward each have a
kernel on the card."""

from __future__ import annotations

from typing import Optional

import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops._util import head_dim_of, require
from tpu1x_torch.ops.attention import mha_reference


def temporal_attention_plain(q, k, v, *, scale: float, num_heads: int,
                             causal: bool = True):
    """The JAX package's `temporal_attention_reference`: transpose to
    (B, S, T, H, D), attend over T, transpose back. Differentiable by
    ordinary autograd."""
    B, T, S, C = q.shape
    H = num_heads

    def to_ref(t):
        return t.transpose(1, 2).reshape(B, S, T, H, C // H)

    out = mha_reference(to_ref(q), to_ref(k), to_ref(v), scale=scale,
                        causal=causal)
    return out.reshape(B, S, T, C).transpose(1, 2)


def temporal_attention_bwd_plain(q, k, v, dout, *, scale: float,
                                 num_heads: int, causal: bool = True,
                                 o: Optional[torch.Tensor] = None):
    """The backward of `temporal_attention_plain`: its VJP at dout, by
    ordinary autograd. Returns dqkv, one new (B, T, S, 3C) tensor whose
    column thirds are dq, dk, dv, as the backward kernel returns it; where
    `o` is given, the forward's output is written into it, as the kernel
    writes it."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = temporal_attention_plain(*leaves, scale=scale,
                                       num_heads=num_heads, causal=causal)
        grads = torch.autograd.grad(out, leaves, dout)
    if o is not None:
        o.copy_(out.detach())
    return torch.cat(grads, dim=-1)


def _check_qkv(q, k, v, num_heads: int) -> int:
    """The checks both kernels share; returns the row stride of q, k, v."""
    B, T, S, C = q.shape
    require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
            "temporal_attention kernels take bf16 q, k, v")
    require(k.shape == q.shape and v.shape == q.shape,
            "q, k, v must share one shape")
    require(q.device == k.device == v.device, "q, k, v on different devices")
    require(T <= 32, f"temporal_attention kernels need T <= 32, got {T}")
    # any number of heads: a tile takes the largest of 256 // D, 4, 2 and 1
    # heads that divides them
    head_dim_of(C, num_heads, "temporal_attention kernels")
    ld = q.stride(2)
    want = (T * S * ld, S * ld, ld, 1)
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t.stride() == want,
                f"{name} strides {t.stride()} are not (T S ld, S ld, ld, 1)")
        require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    require(ld % 8 == 0, "row stride must be a multiple of 8")
    return ld


def launch_forward(q, k, v, *, scale: float, num_heads: int,
                   causal: bool) -> torch.Tensor:
    """Check, launch the forward kernel on CUDA q, k, v and count it. CPU
    tensors take `temporal_attention_plain` and count nothing."""
    if not q.is_cuda:
        return temporal_attention_plain(q, k, v, scale=scale,
                                        num_heads=num_heads, causal=causal)
    B, T, S, C = q.shape
    ld = _check_qkv(q, k, v, num_heads)
    out = torch.empty(B, T, S, C, dtype=q.dtype, device=q.device)
    err = kernels.lib("temporal_attention").tpu1x_temporal_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S, C,
        C // num_heads, ld, scale, int(causal), kernels.stream_of(q))
    kernels.check(err, "temporal_attention")
    kernels.count("temporal_attention")
    return out


def launch_backward(q, k, v, dout, *, scale: float, num_heads: int,
                    causal: bool, o: Optional[torch.Tensor] = None):
    """Check, launch the backward kernel and count it. Returns dqkv, one
    new (B, T, S, 3C) tensor whose column thirds are dq, dk, dv. Where `o`
    (a contiguous tensor like dout) is given, the kernel also writes the
    forward's output into it, equal to `launch_forward`'s bit for bit. CPU
    tensors take `temporal_attention_bwd_plain` and count nothing."""
    if not q.is_cuda:
        return temporal_attention_bwd_plain(q, k, v, dout, scale=scale,
                                            num_heads=num_heads,
                                            causal=causal, o=o)
    B, T, S, C = q.shape
    ld = _check_qkv(q, k, v, num_heads)
    require(dout.dtype == torch.bfloat16 and dout.device == q.device
            and dout.shape == q.shape and dout.is_contiguous(),
            "dout must be a contiguous bf16 tensor like q")
    require(o is None or (o.dtype == torch.bfloat16 and o.device == q.device
                          and o.shape == q.shape and o.is_contiguous()),
            "o must be a contiguous bf16 tensor like q")
    dqkv = torch.empty(B, T, S, 3 * C, dtype=q.dtype, device=q.device)
    dq, dk, dv = dqkv.split(C, dim=-1)
    err = kernels.lib("temporal_attention").tpu1x_temporal_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        None if o is None else o.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, T, S, C, C // num_heads, ld, C, 3 * C, scale,
        int(causal),
        kernels.stream_of(q))
    kernels.check(err, "temporal_attention_bwd")
    kernels.count("temporal_attention_bwd")
    return dqkv


class _TemporalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, num_heads, causal):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(scale=scale, num_heads=num_heads, causal=causal)
        return launch_forward(q, k, v, **ctx.args)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dqkv = launch_backward(q, k, v, dout.contiguous(), **ctx.args)
        return (*dqkv.split(q.shape[-1], dim=-1), None, None, None)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       scale: float, num_heads: int,
                       causal: bool = True) -> torch.Tensor:
    """Attention over axis 1 of q, k, v (B, T, S, C), causal by default;
    returns (B, T, S, C). Differentiable.

    CPU tensors take `temporal_attention_plain`. CUDA tensors launch
    csrc/temporal_attention.cu, which replaces the Pallas kernels of
    tpu1x/ops/temporal_attention.py: the forward (_temporal_fwd /
    _fwd_kernel) and, under autograd, the backward (_temporal_bwd /
    _bwd_kernel), which recomputes the probabilities from q and k. Both take
    bf16 q, k, v that may be column slices of one (B, T, S, 3C) qkv tensor
    (last axis contiguous, the same strides for all three), T <= 32,
    head_dim 32, 64 or 128 and any number of heads (`_check_qkv`). The
    backward returns dq, dk, dv as column slices of one (B, T, S, 3C)
    tensor.

    Bound on the H100: device memory (q, k, v, out read or written once:
    0.040 ms at the train step's (8, 16, 256, 512); the backward's seven
    tensors 0.070 ms). Persistent blocks, one an SM, walk tiles of 2
    positions (4 where T <= 8) x 8 heads (where C % 256 != 0, as at a
    rank's share of GENIE_35M's heads at tp = 2, twice the positions x 4
    heads; where C % 128 != 0, as at tp = 4, four times the positions x 2
    heads; with an odd number of heads, as one head a rank at tp = 8, eight
    times the positions x 1 head: the same bytes); a producer warp loads
    each tile's
    frames by TMA into a ring of stages, one warp computes one (position,
    head) at a time with mma.sync (16 x 16 problems, too small for wgmma's
    64-row tiles) and writes the results over the operands, and a storer
    warp stores them by TMA. Where 16 < T <= 32 a tile holds half the
    positions, each (position, head) one 32 x 32 problem that two warps
    share: in the forward a query block each, in the backward half the
    columns each after both computed P and dS; under `causal` the first
    query block skips the second key block.
    """
    if not q.is_cuda:
        return temporal_attention_plain(q, k, v, scale=scale,
                                        num_heads=num_heads, causal=causal)
    return _TemporalAttention.apply(q, k, v, scale, num_heads, causal)
