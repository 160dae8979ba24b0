"""Causal attention over the frame axis of (B, T, S, C), heads flat (the
serving prefill's temporal attention). Forward and causal only: the
backward and the non-causal form wait for the training slice."""

from __future__ import annotations

import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops._util import require
from tpu1x_torch.ops.attention import mha_reference


def temporal_attention_plain(q, k, v, *, scale: float, num_heads: int):
    """The JAX package's `temporal_attention_reference`: transpose to
    (B, S, T, H, D), attend over T, transpose back."""
    B, T, S, C = q.shape
    H = num_heads

    def to_ref(t):
        return t.transpose(1, 2).reshape(B, S, T, H, C // H)

    out = mha_reference(to_ref(q), to_ref(k), to_ref(v), scale=scale,
                        causal=True)
    return out.reshape(B, S, T, C).transpose(1, 2)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       scale: float, num_heads: int) -> torch.Tensor:
    """Causal attention over axis 1 of q, k, v (B, T, S, C); returns
    (B, T, S, C).

    CPU tensors take `temporal_attention_plain`. CUDA tensors launch
    csrc/temporal_attention.cu, which replaces the forward Pallas kernel of
    tpu1x/ops/temporal_attention.py (_temporal_fwd / _fwd_kernel). It takes
    bf16 q, k, v that may be column slices of one (B, T, S, 3C) qkv tensor
    (last axis contiguous, the same strides for all three), T <= 16,
    head_dim 32 and C % 256 == 0.

    Bound on the H100: device memory. One block per (b, s) reads each frame
    of q, k, v once from device memory, four lanes per head, and keeps the
    <= 16 logits of a query in registers.
    """
    if not q.is_cuda:
        return temporal_attention_plain(q, k, v, scale=scale,
                                        num_heads=num_heads)
    B, T, S, C = q.shape
    require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
            "temporal_attention kernel takes bf16 q, k, v")
    require(k.shape == q.shape and v.shape == q.shape,
            "q, k, v must share one shape")
    require(q.device == k.device == v.device, "q, k, v on different devices")
    require(T <= 16, f"temporal_attention kernel needs T <= 16, got {T}")
    require(C == 32 * num_heads and C % 256 == 0,
            f"temporal_attention kernel needs head_dim 32 and C % 256 == 0, "
            f"got C={C}, heads={num_heads}")
    ld = q.stride(2)
    want = (T * S * ld, S * ld, ld, 1)
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t.stride() == want,
                f"{name} strides {t.stride()} are not (T S ld, S ld, ld, 1)")
        require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    require(ld % 8 == 0, "row stride must be a multiple of 8")
    out = torch.empty(B, T, S, C, dtype=q.dtype, device=q.device)
    err = kernels.lib("temporal_attention").tpu1x_temporal_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S, C,
        ld, scale, kernels.stream_of(q))
    kernels.check(err, "temporal_attention")
    kernels.count("temporal_attention")
    return out
