"""Row LayerNorm: fp32 statistics, bf16 in and out on the card.

The variance is E[x^2] - E[x]^2, the JAX package's formula; torch's
`layer_norm` computes it another way, so the plain version here spells the
formula out.
"""

from __future__ import annotations

import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops._util import check_tensor, check_width


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32, cast to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of x (any leading shape).

    CPU tensors take `layer_norm_plain`. CUDA tensors launch the kernel in
    csrc/layer_norm.cu, which replaces the Pallas kernel
    tpu1x/ops/layernorm.py:layer_norm: x and the result bf16, scale and bias
    fp32 (C,), C % 8 == 0 and C <= MAX_C (4096, `_util.MAX_C`), any number
    of rows. The kernel is bound by device memory: each warp walks rows
    (past C = 2048 each pair of warps, the row's two sums meeting in shared
    memory), holding a row in registers between the statistics and the
    write (each byte moves once) while the next row's 16-byte loads are in
    flight, with gamma and beta in registers up to C = 1024, on a grid of
    the blocks the card keeps resident.
    """
    if not x.is_cuda:
        return layer_norm_plain(x, scale, bias, eps)
    C = x.shape[-1]
    check_width(C, "layer_norm kernel")
    check_tensor(x, "x", x.shape, torch.bfloat16, x.device)
    check_tensor(scale, "scale", (C,), torch.float32, x.device)
    check_tensor(bias, "bias", (C,), torch.float32, x.device)
    y = torch.empty_like(x)
    err = kernels.lib("layer_norm").tpu1x_layer_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        x.numel() // C, C, eps, kernels.stream_of(x))
    kernels.check(err, "layer_norm")
    kernels.count("layer_norm")
    return y
