"""Launchers of the device kernels that the three train blocks are built
from (csrc/train_block.cu, csrc/common.cuh): the shared GEMM in its three
forms, column sums, and the LayerNorm forward and backward over rows.

Every function here takes CUDA tensors only and launches on the current
stream; the train-block wrappers sequence them. None of them counts a
launch: the counters belong to the blocks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops._util import ptr, require

BF16 = torch.bfloat16
ACT = {None: 0, "gelu_tanh": 1, "gelu_erf": 2, "dgelu_tanh": 3, "dgelu_erf": 4}
MODE = {"nn": 0, "nt": 1, "tn": 2}
# blocks the GEMM_TN grid aims for: four waves of the H100's 132 SMs
TN_BLOCKS = 4 * 132


def _rows2d(t: torch.Tensor, name: str) -> None:
    require(t.is_cuda and t.dim() == 2 and t.stride(1) == 1
            and t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0,
            f"{name} must be a 2-D CUDA tensor with contiguous, 16-byte "
            f"aligned rows, got shape {tuple(t.shape)} strides {t.stride()}")


def gemm(a: torch.Tensor, b: torch.Tensor, *, mode: str = "nn",
         bias: Optional[torch.Tensor] = None,
         resid: Optional[torch.Tensor] = None,
         aux: Optional[torch.Tensor] = None, act: Optional[str] = None,
         fused: bool = True, ln: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
         fp32_out: bool = False, pre_out: bool = False):
    """One launch of the shared GEMM on bf16 operands.

    mode "nn": a (M, K) @ b (K, N); "nt": a (M, K) @ b (N, K)^T;
    "tn": a (K, M)^T @ b (K, N), always fp32 (split reduction, atomics).
    `bias` (N,) bf16, `resid` (M, N) bf16, `act` a key of ACT (`aux` is the
    (M, N) pre-activation of the "dgelu_*" forms), `ln` = (scale, bias) fp32
    for the LayerNorm prologue of "nn". `fused` picks the training kernels'
    rounding (fp32 through bias and activation, one rounding, then the
    residual) over the serving chain's (a rounding after every step).
    `fp32_out` returns the fp32 accumulators with no epilogue; `pre_out`
    also returns the rounded pre-activation (acc + bias). Returns (M, N).
    """
    _rows2d(a, "a")
    _rows2d(b, "b")
    require(a.dtype == BF16 and b.dtype == BF16, "gemm takes bf16 operands")
    if mode == "nn":
        (M, K), (Kb, N) = a.shape, b.shape
    elif mode == "nt":
        (M, K), (N, Kb) = a.shape, b.shape
    else:
        (K, M), (Kb, N) = a.shape, b.shape
    require(K == Kb, f"gemm {mode}: inner sizes {K} and {Kb} differ")
    require(N % 64 == 0 and K % 32 == 0,
            f"gemm needs N % 64 == 0 and K % 32 == 0, got N={N}, K={K}")
    dev = a.device
    k_chunk = 0
    out = out2 = outf = None
    if mode == "tn":
        require(M % 8 == 0, f"gemm tn needs M % 8 == 0, got {M}")
        require(not (bias is not None or resid is not None or act or ln),
                "gemm tn has no epilogue")
        tiles = (N // 64) * ((M + 127) // 128)
        splits = max(1, min(K // 32, -(-TN_BLOCKS // tiles)))
        k_chunk = -(-K // (splits * 32)) * 32
        outf = torch.zeros(M, N, dtype=torch.float32, device=dev)
    elif fp32_out:
        outf = torch.empty(M, N, dtype=torch.float32, device=dev)
    else:
        out = torch.empty(M, N, dtype=BF16, device=dev)
        if pre_out:
            out2 = torch.empty_like(out)
    for name, t, shape in (("bias", bias, (N,)), ("resid", resid, (M, N)),
                           ("aux", aux, (M, N))):
        if t is not None:
            require(t.is_cuda and t.dtype == BF16 and tuple(t.shape) == shape
                    and t.stride(-1) == 1,
                    f"gemm {name} must be bf16 {shape}, got {t.dtype} "
                    f"{tuple(t.shape)}")
    if ln is not None:
        require(mode == "nn", "the LayerNorm prologue is for mode nn")
        for t in ln:
            require(t.is_cuda and t.dtype == torch.float32
                    and tuple(t.shape) == (K,) and t.is_contiguous(),
                    "LayerNorm params must be contiguous fp32 (K,)")
    require(("dgelu" in (act or "")) == (aux is not None),
            "aux goes with the dgelu activations")
    require(fused or (mode == "nn" and aux is None and not pre_out
                      and not fp32_out),
            "the serving chain (fused=False) is for mode nn with a bf16 "
            "output only")
    err = kernels.lib("train_block").tpu1x_gemm(
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), ptr(out),
        ptr(out2), ptr(outf), N, ptr(bias), ptr(resid),
        0 if resid is None else resid.stride(0), ptr(aux),
        0 if aux is None else aux.stride(0),
        None if ln is None else ln[0].data_ptr(),
        None if ln is None else ln[1].data_ptr(), M, N, K, MODE[mode],
        ACT[act], int(fused), k_chunk, kernels.stream_of(a))
    kernels.check(err, f"gemm {mode}")
    res = outf if out is None else out
    return (res, out2) if pre_out else res


def col_sum(x: torch.Tensor) -> torch.Tensor:
    """fp32 column sums of a bf16 (rows, N) tensor (a bias gradient)."""
    _rows2d(x, "x")
    require(x.dtype == BF16 and x.shape[1] % 8 == 0,
            "col_sum takes bf16 with N % 8 == 0")
    out = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    err = kernels.lib("train_block").tpu1x_col_sum(
        x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], x.stride(0),
        kernels.stream_of(x))
    kernels.check(err, "col_sum")
    return out


def _ln_args(x, scale, bias=None):
    rows, C = x.shape
    require(x.is_cuda and x.dtype == BF16 and x.is_contiguous()
            and x.data_ptr() % 16 == 0, "LayerNorm rows must be contiguous bf16")
    require(C % 8 == 0 and C <= 1024,
            f"the LayerNorm row kernels need C % 8 == 0 and C <= 1024, got {C}")
    for t in (scale, bias):
        if t is not None:
            require(t.is_cuda and t.dtype == torch.float32
                    and tuple(t.shape) == (C,) and t.is_contiguous(),
                    "LayerNorm params must be contiguous fp32 (C,)")
    return rows, C


def ln_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           eps: float = 1e-5):
    """x (rows, C) bf16 -> (LN(x) bf16, stats (rows, 2) fp32 = mean, rstd)."""
    rows, C = _ln_args(x, scale, bias)
    xn = torch.empty_like(x)
    stats = torch.empty(rows, 2, dtype=torch.float32, device=x.device)
    err = kernels.lib("train_block").tpu1x_ln_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), xn.data_ptr(),
        stats.data_ptr(), rows, C, eps, kernels.stream_of(x))
    kernels.check(err, "ln_fwd")
    return xn, stats


def ln_bwd(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
           d_xn: torch.Tensor, dout: torch.Tensor):
    """The LayerNorm backward over rows plus the residual's gradient:
    returns (dx bf16 = LN'(d_xn) + dout, dscale fp32, dbias fp32)."""
    rows, C = _ln_args(x, scale)
    require(d_xn.dtype == torch.float32 and d_xn.is_contiguous()
            and d_xn.shape == x.shape, "d_xn must be contiguous fp32 like x")
    require(dout.dtype == BF16 and dout.is_contiguous()
            and dout.shape == x.shape, "dout must be contiguous bf16 like x")
    dx = torch.empty_like(x)
    dscale = torch.zeros(C, dtype=torch.float32, device=x.device)
    dbias = torch.zeros_like(dscale)
    err = kernels.lib("train_block").tpu1x_ln_bwd(
        x.data_ptr(), stats.data_ptr(), scale.data_ptr(), d_xn.data_ptr(),
        dout.data_ptr(), dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
        rows, C, kernels.stream_of(x))
    kernels.check(err, "ln_bwd")
    return dx, dscale, dbias


def as_bf16(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A contiguous bf16 copy of a weight or bias (itself if it is one)."""
    return None if t is None else t.detach().to(BF16).contiguous()


def as_f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.detach().float().contiguous()


def dtypes_of(*params: Optional[torch.Tensor]):
    """What a backward needs to know of its parameters: each one's dtype,
    None for an absent one."""
    return tuple(None if p is None else p.dtype for p in params)


def like(grads, dtypes):
    """Each fp32 gradient in its parameter's dtype, None for an absent
    parameter."""
    return tuple(None if d is None or g is None else g.to(d)
                 for g, d in zip(grads, dtypes))
