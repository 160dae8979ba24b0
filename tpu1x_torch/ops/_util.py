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


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()
