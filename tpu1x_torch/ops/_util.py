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
HEAD_DIMS = (32, 64, 72, 128)


def head_dims_text() -> str:
    """HEAD_DIMS as words: "32, 64, 72 or 128"."""
    return ", ".join(map(str, HEAD_DIMS[:-1])) + f" or {HEAD_DIMS[-1]}"


def head_dim_of(C: int, num_heads: int, what: str) -> int:
    """C / num_heads where it is one of HEAD_DIMS; raises, naming them,
    for any other head width (the kernels have no fallback)."""
    D = C // num_heads if num_heads > 0 else 0
    require(num_heads > 0 and D * num_heads == C and D in HEAD_DIMS,
            f"{what} needs head_dim {head_dims_text()}, got C={C}, "
            f"heads={num_heads}")
    return D


# The widest d_model of the port's kernels, one limit for every wrapper
# that checks a width: K5's row pass (and K1's, K2's and K3's LN), the
# training LN rows (K11, K13, the TP sub-layers) and the decode ring (K7,
# K8, K2/K3's cache attention). `MAX_C` in csrc/common.cuh is the same
# value, which the kernels' own rules read: the LN rows hold a row in one
# warp up to 2048 channels and in a pair of warps past it; the ring's items
# hold at most 2048 channels of their tokens, past that a group of whole
# heads.
MAX_C = 4096
# head_dim 72's widest C: the ring's rows of 24 channels, three a head and
# ten heads a warp, on at most 384 lanes (C / 24 rows of an item of 4
# tokens, no head groups).
MAX_C_72 = 2016


def decode_width_ok(C: int, num_heads: int) -> bool:
    """Whether the decode ring of csrc/decode_attention.cuh (K7, K8 and the
    cache attention of K2 and K3) takes d_model C in `num_heads` heads, as
    its `decode_width_ok` decides: a head width of HEAD_DIMS (so C % 32 ==
    0, or C % 24 == 0 at head_dim 72, and a head row never lies across a
    warp) and C <= MAX_C (at head_dim 72 C <= MAX_C_72). Any such C: where
    an item's rows are not whole warps, the ring takes more tokens an item
    or idle lanes, and past 2048 channels an item is a group of whole heads
    (`decode_plan`)."""
    D = C // num_heads if num_heads > 0 else 0
    return (num_heads > 0 and D * num_heads == C and D in HEAD_DIMS
            and 0 < C <= (MAX_C_72 if D == 72 else MAX_C))


def check_decode_width(C: int, num_heads: int, what: str) -> int:
    """Raise, naming the limit, for a width `decode_width_ok` refuses;
    returns the head width."""
    D = head_dim_of(C, num_heads, what)
    limit, name = (MAX_C_72, "MAX_C_72") if D == 72 else (MAX_C, "MAX_C")
    require(decode_width_ok(C, num_heads),
            f"{what} needs C <= {limit} at head_dim {D} ({name}), got C={C}")
    return D


def check_width(C: int, what: str) -> None:
    """Raise, naming the limit, unless 0 < C <= MAX_C and C % 8 == 0 (the
    16-byte chunks of the LN rows)."""
    require(C % 8 == 0 and 0 < C <= MAX_C,
            f"{what} needs C % 8 == 0 and C <= {MAX_C} (MAX_C), got {C}")


def gemm_shape_ok(M: int, N: int, K: int, form: str = "nn") -> bool:
    """Whether csrc/gemm_sm90.cuh takes a product of M rows, N columns and
    depth K in `form` ("nn", "nt", "tn"; the serving chain is "nn"), as its
    `g9_shape_ok` decides: every row stride of its tensor maps a multiple of
    16 bytes, so N and K multiples of 8, and M too where "tn" stores A as
    (K, M). Any M otherwise; N and K need not be multiples of the tile's 64
    (the last tile overhangs)."""
    return (M >= 0 and N > 0 and K > 0 and N % 8 == 0 and K % 8 == 0
            and (form != "tn" or M % 8 == 0))


def check_gemm_shape(M: int, N: int, K: int, what: str,
                     form: str = "nn") -> None:
    """Raise, naming the limit, for a product `gemm_shape_ok` refuses."""
    require(gemm_shape_ok(M, N, K, form),
            f"{what} needs N % 8 == 0 and K % 8 == 0"
            + (" and M % 8 == 0" if form == "tn" else "")
            + f" (16-byte rows), got M={M}, N={N}, K={K}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()
