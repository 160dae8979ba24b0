"""Launchers of the device kernels that the three train blocks are built
from (csrc/train_block.cu): the training forms of the TMA/wgmma GEMM of
csrc/gemm_sm90.cuh (every weight product of the train blocks but the
spatial block's qkv recompute, which is the serving chain's `gemm_sm90`),
column sums, and the LayerNorm forward and backward over rows.

Each takes CPU tensors too, and then computes its plain version
(`*_plain`: the kernel's arithmetic and rounding points in plain torch,
rounding to the operands' dtype where the kernel rounds to bf16), so that a
train block's launch sequence runs on the CPU. On CUDA tensors each
launches its kernel on the current stream or raises; the train-block
wrappers sequence them. None of them counts a launch: the counters belong
to the blocks.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops._util import dgelu, gelu, ptr, require

BF16 = torch.bfloat16
ACT = {None: 0, "gelu_tanh": 1, "gelu_erf": 2, "dgelu_tanh": 3, "dgelu_erf": 4}
MODE = {"nn": 0, "nt": 1, "tn": 2}


def _rows2d(t: torch.Tensor, name: str) -> None:
    require(t.is_cuda and t.dim() == 2 and t.stride(1) == 1
            and t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0,
            f"{name} must be a 2-D CUDA tensor with contiguous, 16-byte "
            f"aligned rows, got shape {tuple(t.shape)} strides {t.stride()}")


def _gemm90_check(a, b, form, bias, resid, aux, act, fp32_out, pre_out):
    """(M, N, K) of a training-form product; raises on a form, an epilogue
    or a shape that the kernel has no instantiation for."""
    require(form in MODE, f"form must be one of {list(MODE)}, got {form!r}")
    require(act in ACT, f"act must be one of {list(ACT)}, got {act!r}")
    require(a.dim() == 2 and b.dim() == 2, "gemm90 takes 2-D operands")
    if form == "nn":
        (M, K), (Kb, N) = a.shape, b.shape
    elif form == "nt":
        (M, K), (N, Kb) = a.shape, b.shape
    else:
        (K, M), (Kb, N) = a.shape, b.shape
    require(K == Kb, f"gemm90 {form}: inner sizes {K} and {Kb} differ")
    dg = act is not None and act.startswith("dgelu")
    bare = (bias is None and resid is None and aux is None and act is None
            and not pre_out)
    if form == "tn":
        require(bare, "gemm90 tn has no epilogue: it returns A^T B in fp32")
    elif fp32_out:
        require(form == "nt" and bare,
                "the fp32 store is the nt form's, without an epilogue")
    else:
        require(dg == (aux is not None), "aux goes with the dgelu activations")
        require(not dg if form == "nn" else act is None or dg,
                "nn takes the GELU, nt the GELU' (dgelu) epilogue")
        require(not pre_out or form == "nn", "pre_out is the nn form's")
        require(pre_out + (aux is not None) + (resid is not None) <= 1,
                "at most one of pre_out, aux and resid: the epilogue "
                "stages it beside the output")
    for name, t, shape in (("bias", bias, (N,)), ("resid", resid, (M, N)),
                           ("aux", aux, (M, N))):
        if t is not None:
            require(tuple(t.shape) == shape,
                    f"gemm90 {name} must be {shape}, got {tuple(t.shape)}")
    return M, N, K


def gemm90_plain(a, b, *, form="nn", bias=None, resid=None, aux=None,
                 act=None, fp32_out=False, pre_out=False):
    """What `gemm90` computes, in plain torch: the product of the operands
    in fp32 (each product exact, fp32 sums); "tn" and `fp32_out` return it as
    it is. Otherwise the training chain: + bias in fp32, then GELU ("gelu_*")
    or times GELU'(aux) ("dgelu_*") in fp32, one rounding to a's dtype, +
    resid rounded; `pre_out` also returns acc + bias rounded."""
    _gemm90_check(a, b, form, bias, resid, aux, act, fp32_out, pre_out)
    acc = torch.matmul(a.float().t() if form == "tn" else a.float(),
                       b.float().t() if form == "nt" else b.float())
    if form == "tn" or fp32_out:
        return acc
    cd = a.dtype
    if bias is not None:
        acc = acc + bias.float()
    pre = acc.to(cd)
    if act in ("gelu_tanh", "gelu_erf"):
        acc = gelu(acc, act == "gelu_tanh")
    elif act is not None:
        acc = acc * dgelu(aux.float(), act == "dgelu_tanh")
    out = acc.to(cd)
    if resid is not None:
        out = (resid.float() + out.float()).to(cd)
    return (out, pre) if pre_out else out


def gemm90(a: torch.Tensor, b: torch.Tensor, *, form: str = "nn",
           bias: Optional[torch.Tensor] = None,
           resid: Optional[torch.Tensor] = None,
           aux: Optional[torch.Tensor] = None, act: Optional[str] = None,
           fp32_out: bool = False, pre_out: bool = False):
    """One launch of a training form of csrc/gemm_sm90.cuh (TMA, wgmma).

    form "nn": a (M, K) @ b (K, N); "nt": a (M, K) @ b (N, K)^T; "tn":
    a (K, M)^T @ b (K, N), always fp32, the reduction over K in chunks (as
    many as fill the card, chosen by the launcher) added with fp32 atomics,
    so its last bits differ from run to run. `fp32_out` ("nt" only) returns the fp32
    accumulators. Otherwise the bf16 training chain of `gemm90_plain`:
    `bias` (N,), `act` "gelu_tanh" / "gelu_erf" ("nn") or "dgelu_tanh" /
    "dgelu_erf" ("nt", with `aux` the (M, N) pre-activation), `resid` (M,
    N); `pre_out` ("nn") also returns the rounded pre-activation; at most
    one of `pre_out`, `aux` and `resid`. Returns (M, N). CPU tensors take
    `gemm90_plain`; CUDA tensors must be contiguous, 16-byte aligned bf16
    with N % 64 == 0 and K % 64 == 0.
    """
    M, N, K = _gemm90_check(a, b, form, bias, resid, aux, act, fp32_out,
                            pre_out)
    if not a.is_cuda:
        return gemm90_plain(a, b, form=form, bias=bias, resid=resid, aux=aux,
                            act=act, fp32_out=fp32_out, pre_out=pre_out)
    require(N % 64 == 0 and K % 64 == 0,
            f"gemm90 needs N % 64 == 0 and K % 64 == 0, got N={N}, K={K}")
    for name, t in (("a", a), ("b", b), ("bias", bias), ("resid", resid),
                    ("aux", aux)):
        if t is not None:
            require(t.is_cuda and t.dtype == BF16 and t.is_contiguous()
                    and t.data_ptr() % 16 == 0,
                    f"gemm90 {name} must be a contiguous, 16-byte aligned "
                    f"bf16 CUDA tensor, got {t.dtype} on {t.device}")
    dev = a.device
    out = pre = outf = None
    if form == "tn":
        require(M % 8 == 0, f"gemm90 tn needs M % 8 == 0, got {M}")
        outf = torch.zeros(M, N, dtype=torch.float32, device=dev)
    elif fp32_out:
        outf = torch.empty(M, N, dtype=torch.float32, device=dev)
    else:
        out = torch.empty(M, N, dtype=BF16, device=dev)
        if pre_out:
            pre = torch.empty_like(out)
    err = kernels.lib("train_block").tpu1x_gemm90_train(
        a.data_ptr(), b.data_ptr(), ptr(out), ptr(pre), ptr(outf), ptr(bias),
        ptr(resid), ptr(aux), M, N, K, MODE[form], ACT[act],
        kernels.stream_of(a))
    kernels.check(err, f"gemm90 {form}")
    res = outf if out is None else out
    return (res, pre) if pre_out else res


def col_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """`col_sum` in plain torch: fp32 sums down the rows."""
    return x.float().sum(0)


def col_sum(x: torch.Tensor) -> torch.Tensor:
    """fp32 column sums of a (rows, N) tensor (a bias gradient); on the
    card bf16 with N % 8 == 0, CPU tensors take `col_sum_plain`."""
    require(x.dim() == 2, "col_sum takes a 2-D tensor")
    if not x.is_cuda:
        return col_sum_plain(x)
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
    """(rows, C); on the card also the kernels' dtypes and layout."""
    require(x.dim() == 2, "the LayerNorm row passes take (rows, C)")
    rows, C = x.shape
    for t in (scale, bias):
        if t is not None:
            require(tuple(t.shape) == (C,), "LayerNorm params must be (C,)")
    if not x.is_cuda:
        return rows, C
    require(x.dtype == BF16 and x.is_contiguous()
            and x.data_ptr() % 16 == 0, "LayerNorm rows must be contiguous bf16")
    require(C % 8 == 0 and C <= 1024,
            f"the LayerNorm row kernels need C % 8 == 0 and C <= 1024, got {C}")
    for t in (scale, bias):
        if t is not None:
            require(t.is_cuda and t.dtype == torch.float32
                    and t.is_contiguous(),
                    "LayerNorm params must be contiguous fp32 (C,)")
    return rows, C


def ln_fwd_plain(x, scale, bias, eps: float = 1e-5):
    """The row pass of `ln_fwd` in plain torch: fp32 statistics, variance
    E[x^2] - E[x]^2, the result rounded to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1)
    rs = torch.rsqrt((xf * xf).mean(-1) - mu * mu + eps)
    xn = ((xf - mu[:, None]) * rs[:, None] * scale.float()
          + bias.float()).to(x.dtype)
    return xn, torch.stack([mu, rs], 1)


def ln_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           eps: float = 1e-5):
    """x (rows, C) bf16 -> (LN(x) bf16, stats (rows, 2) fp32 = mean, rstd).
    CPU tensors take `ln_fwd_plain`."""
    rows, C = _ln_args(x, scale, bias)
    if not x.is_cuda:
        return ln_fwd_plain(x, scale, bias, eps)
    xn = torch.empty_like(x)
    stats = torch.empty(rows, 2, dtype=torch.float32, device=x.device)
    err = kernels.lib("train_block").tpu1x_ln_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), xn.data_ptr(),
        stats.data_ptr(), rows, C, eps, kernels.stream_of(x))
    kernels.check(err, "ln_fwd")
    return xn, stats


def ln_bwd_plain(x, stats, scale, d_xn, dout):
    """The LayerNorm backward of `ln_bwd` in plain torch, in fp32 from the
    forward's (mean, rstd), dx rounded once to x's dtype."""
    mu, rs = stats[:, :1], stats[:, 1:]
    xh = (x.float() - mu) * rs
    dh = d_xn * scale.float()
    dx = dout.float() + rs * (dh - dh.mean(-1, keepdim=True)
                              - xh * (dh * xh).mean(-1, keepdim=True))
    return dx.to(x.dtype), (d_xn * xh).sum(0), d_xn.sum(0)


def ln_bwd(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
           d_xn: torch.Tensor, dout: torch.Tensor):
    """The LayerNorm backward over rows plus the residual's gradient:
    returns (dx bf16 = LN'(d_xn) + dout, dscale fp32, dbias fp32). CPU
    tensors take `ln_bwd_plain`."""
    rows, C = _ln_args(x, scale)
    require(d_xn.shape == x.shape and dout.shape == x.shape,
            "d_xn and dout must have x's shape")
    if not x.is_cuda:
        return ln_bwd_plain(x, stats, scale, d_xn, dout)
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
