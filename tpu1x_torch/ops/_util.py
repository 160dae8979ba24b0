"""Helpers shared by the op modules: the plain dense layer and GELU, and the
argument checks that the kernel wrappers make before they hand pointers to
CUDA."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b) in x's dtype: products accumulate in fp32 and round once,
    then the bias adds in x's dtype, as the JAX package's dot + astype."""
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def gelu(x: torch.Tensor, tanh: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if tanh else "none")


def dgelu(x: torch.Tensor, tanh: bool) -> torch.Tensor:
    """d gelu(x) / dx, of the tanh approximation or of the exact erf form
    (the JAX package's `_dgelu_f32`, with erf itself)."""
    if tanh:
        k = 0.7978845608028654  # sqrt(2 / pi)
        th = torch.tanh(k * (x + 0.044715 * x * x * x))
        du = k * (1.0 + 3 * 0.044715 * x * x)
        return 0.5 * (1.0 + th) + 0.5 * x * (1.0 - th * th) * du
    phi = torch.exp(-0.5 * x * x) * 0.3989422804014327
    return 0.5 * (1.0 + torch.erf(x * 0.7071067811865476)) + x * phi


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_tensor(t: torch.Tensor, name: str, shape, dtype,
                 device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device` whose data is 16-byte aligned (the kernels' vector loads)."""
    require(t.device == device, f"{name} is on {t.device}, expected {device}")
    require(t.dtype == dtype, f"{name} has dtype {t.dtype}, expected {dtype}")
    require(tuple(t.shape) == tuple(shape),
            f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    require(t.is_contiguous(), f"{name} must be contiguous")
    require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


# The head widths that every attention kernel of the port is built for.
HEAD_DIMS = (32, 64, 128)


def head_dim_of(C: int, num_heads: int, what: str) -> int:
    """C / num_heads where it is one of HEAD_DIMS; raises, naming them,
    for any other head width (the kernels have no fallback)."""
    D = C // num_heads if num_heads > 0 else 0
    require(num_heads > 0 and D * num_heads == C and D in HEAD_DIMS,
            f"{what} needs head_dim 32, 64 or 128, got C={C}, "
            f"heads={num_heads}")
    return D


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()
