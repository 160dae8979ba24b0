"""Tensor parallelism over the mesh's "model" axis: the JAX package's
sharding rules (tpu1x/parallel/sharding.py) computed Megatron-style.

Each rank of a model group holds its share of every STBlock: the qkv
product's columns for its heads, the proj product's rows for them, fc1's
columns and fc2's rows of its share of the hidden width. It runs the
existing kernels on that share, and one all-reduce over the model group
follows each row-parallel product in the forward, one the gradient of the
sub-layer's input in the backward. Biases after a row-parallel product, the
LayerNorms, the qk-LN, the embeddings and the head stay whole on every rank,
as the JAX rules replicate them. Their gradients come out the same on
every rank of a model group up to the order of the card's fp32 atomics,
and the optimizer gives the whole group its first rank's
(`TrainOptimizer._agree`), so that the ranks' copies stay equal bit for
bit; the qk-LN's, which each rank takes from its own heads, is summed over
the group in the backward (`copy_to_model` on its parameters).

- `shard_state_dict` / `gather_state_dict`: a whole state dict into a
  rank's shard (the reference's parameter names, narrower tensors) and
  back. qkv's torch weight (3C, C) is laid out (3, H, D) along its rows, so
  rank r takes heads [r H / tp, (r + 1) H / tp) of q, of k and of v.
- `split_model`: shard an `STMaskGIT` in place on a `Mesh`.
- The three TP sub-layers (`tp_spatial_train_block`,
  `tp_temporal_train_block`, `tp_mlp_train_block`), each an
  `autograd.Function` composed of the launchers of the train blocks: on
  CUDA tensors they launch the kernels, on CPU tensors the same launchers
  take their plain versions. Each is a sequence of launches that yields its
  fp32 partial sum once and takes back the sum over the model group
  (`tk.through`), the backwards the train blocks' own sequences, so that
  one process can run the ranks of a group side by side and add their
  partials itself.
- `column_parallel` (the column-parallel product with Megatron's f,
  identity forward and all-reduce backward, before it), `row_parallel`
  (the row-parallel product with g, all-reduce forward and identity
  backward, after it) and `copy_to_model` (f alone, on the qk-LN's
  parameters) for the op-by-op sub-layers (qk_norm, dropout) in
  `models/st_transformer.py`; they round where `_util.dense` rounds in one
  process.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import torch
from torch import nn

from tpu1x_torch import kernels
from tpu1x_torch.ops import _train_kernels as tk
from tpu1x_torch.ops import mlp_train_block as mtb
from tpu1x_torch.ops import spatial_train_block as stb
from tpu1x_torch.ops import temporal_attention as ta
from tpu1x_torch.ops import temporal_train_block as ttb
from tpu1x_torch.ops._util import require
from tpu1x_torch.ops.attention import flash_mha_fwd
from tpu1x_torch.ops.remat import keep
from tpu1x_torch.ops.spatial_block import gemm_sm90
from tpu1x_torch.parallel.mesh import Mesh, model_all_reduce

# (name pattern, how the torch tensor splits over "model"): "heads" the
# rows of q, k and v by head, else the dimension cut into tp equal parts
_RULES = (
    (re.compile(r"(spatial_attn|temporal_attn)\.qkv\.(weight|bias)$"),
     "heads"),
    (re.compile(r"mlp\.fc1\.(weight|bias)$"), 0),
    (re.compile(r"(spatial_attn|temporal_attn)\.proj\.weight$"), 1),
    (re.compile(r"mlp\.fc2\.weight$"), 1),
)


def split_rule(name: str):
    """How parameter `name` splits over the model axis: "heads", a
    dimension, or None (replicated)."""
    for pattern, rule in _RULES:
        if pattern.search(name):
            return rule
    return None


def is_split(name: str) -> bool:
    return split_rule(name) is not None


def shard_tensor(name: str, t: torch.Tensor, rank: int, tp: int,
                 num_heads: int) -> torch.Tensor:
    """Rank `rank`'s share of the whole tensor `t` named `name`."""
    rule = split_rule(name)
    if rule is None or tp == 1:
        return t
    if rule == "heads":
        h = num_heads // tp
        per = t.reshape(3, num_heads, -1, *t.shape[1:])
        return per[:, rank * h:(rank + 1) * h].reshape(-1, *t.shape[1:])
    return t.chunk(tp, dim=rule)[rank]


def unshard_tensor(name: str, parts: List[torch.Tensor],
                   num_heads: int) -> torch.Tensor:
    """The whole tensor from the shards of ranks 0 .. tp - 1."""
    rule = split_rule(name)
    if rule is None or len(parts) == 1:
        return parts[0]
    if rule == "heads":
        h = num_heads // len(parts)
        per = [p.reshape(3, h, -1, *p.shape[1:]) for p in parts]
        return torch.cat(per, dim=1).reshape(-1, *parts[0].shape[1:])
    return torch.cat(parts, dim=rule)


def check_split(tp: int, num_heads: int, hidden: int) -> None:
    """Raise unless `tp` divides the heads and the MLP's hidden width."""
    if tp < 1 or num_heads % tp or hidden % tp:
        raise ValueError(f"tensor parallelism {tp} must divide the "
                         f"{num_heads} heads and the {hidden} hidden columns")


def shard_state_dict(sd: Dict[str, torch.Tensor], rank: int, tp: int,
                     num_heads: int) -> Dict[str, torch.Tensor]:
    """Rank `rank`'s shard of a whole state dict, under the same names (new
    contiguous tensors for the split ones)."""
    return {k: shard_tensor(k, v, rank, tp, num_heads).contiguous()
            if is_split(k) else v for k, v in sd.items()}


def gather_state_dict(shards: List[Dict[str, torch.Tensor]],
                      num_heads: int) -> Dict[str, torch.Tensor]:
    """The whole state dict from the shards of ranks 0 .. tp - 1."""
    return {k: unshard_tensor(k, [s[k] for s in shards], num_heads)
            for k in shards[0]}


def split_model(model: nn.Module, m: Mesh) -> nn.Module:
    """Shard an `STMaskGIT` (whole, as built and initialised or loaded) in
    place into this rank's share on mesh `m`: every split parameter becomes
    a new parameter holding the rank's shard, each attention and MLP learns
    its share (`mesh`, its first head or hidden column, the whole count),
    and `model.mesh` is `m`. Build the optimizer after this."""
    cfg = model.config
    H = cfg.num_heads
    check_split(m.tp, H, model.decoder.layers[0].mlp.fc1.weight.shape[0])
    for name, p in list(model.named_parameters()):
        if not is_split(name):
            continue
        owner, leaf = name.rsplit(".", 1)
        shard = shard_tensor(name, p.detach(), m.model_index, m.tp, H)
        setattr(model.get_submodule(owner), leaf, nn.Parameter(
            shard.clone().contiguous(), requires_grad=p.requires_grad))
    for layer in model.decoder.layers:
        for attn in (layer.spatial_attn, layer.temporal_attn):
            attn.num_heads = H // m.tp
            attn.head0 = m.model_index * attn.num_heads
            attn.mesh = m
        mlp = layer.mlp
        mlp.col0 = m.model_index * mlp.fc1.weight.shape[0]
        mlp.mesh = m
    model.mesh = m
    return model


# ---------------------------------------------------------------------------
# the sub-layers
# ---------------------------------------------------------------------------
# Each forward is its train block's launch sequence on the rank's share up to
# the row-parallel product, whose fp32 store (`tk.gemm90` nt, the weight in
# the torch layout (C, C')) the sequence yields and takes back summed over
# the model group; then `tk.epilogue` (the bias in fp32, one rounding, the
# residual), the order of the one-process epilogue. The fused one-process
# forwards (K1, and the residual epilogues) add the residual before any sum
# could happen. The backwards are the train blocks' own sequences
# (`*_train_block_steps`) at the rank's shapes.

def spatial_fwd(x, wqkv, wproj_nt, bqkv, bproj, ln_scale, ln_bias, *,
                num_heads: int, scale: float):
    """x (N, S, C) -> x + proj(mha(qkv(LN1(x)))) on this rank's heads:
    LN1 as a row pass (`tk.ln_fwd`), the qkv product for the rank's columns
    (wqkv (C, 3C/tp), the serving GEMM `gemm_sm90`), K9's forward on
    num_heads = H / tp heads, the proj partial."""
    N, S, C = x.shape
    x2 = x.reshape(-1, C)
    xn, _ = tk.ln_fwd(x2, ln_scale, ln_bias)
    qkv = gemm_sm90(xn, wqkv, bqkv).view(N, S, 3, num_heads, -1)
    o, _ = flash_mha_fwd(*qkv.unbind(2), scale=scale, causal=False)
    part = yield tk.gemm90(o.reshape(N * S, -1), wproj_nt, form="nt",
                           fp32_out=True)
    return tk.epilogue(part, bproj, x2).view(x.shape)


def temporal_fwd(x, wqkv, wproj_nt, bqkv, bproj, *, num_heads: int,
                 scale: float):
    """x (B, T, S, C) -> x + proj(causal temporal MHA(qkv(x))) on this
    rank's heads: the qkv product with bias (`tk.gemm90`), K4 on the
    C/tp-wide column views, the proj partial."""
    C = x.shape[-1]
    ao = ta.launch_forward(*ttb._qkv(x, wqkv, bqkv), scale=scale,
                           num_heads=num_heads, causal=True)
    part = yield tk.gemm90(ao.reshape(-1, wproj_nt.shape[1]), wproj_nt,
                           form="nt", fp32_out=True)
    return tk.epilogue(part, bproj, x.reshape(-1, C)).view(x.shape)


def mlp_fwd(x, wfc1, wfc2_nt, bfc1, bfc2, ln_scale, ln_bias, *,
            gelu_approx: bool):
    """x (N, S, C) -> x + fc2(GELU(fc1(LN2(x)))) on this rank's hidden
    columns: LN2 where there is one, fc1 with bias and GELU on the rank's
    columns (wfc1 (C, hidden/tp)), the fc2 partial."""
    C = x.shape[-1]
    x2 = x.reshape(-1, C)
    xn = x2 if ln_scale is None else tk.ln_fwd(x2, ln_scale, ln_bias)[0]
    h = tk.gemm90(xn, wfc1, bias=bfc1, act=mtb._act(gelu_approx))
    part = yield tk.gemm90(h, wfc2_nt, form="nt", fp32_out=True)
    return tk.epilogue(part, bfc2, x2).view(x.shape)


def _cast(t, dtype):
    """A contiguous copy of a weight or bias in the compute dtype."""
    return None if t is None else t.detach().to(dtype).contiguous()


def _reducer(m: Mesh):
    return lambda t: model_all_reduce(t, m)


def _counted(name: str, x: torch.Tensor, out):
    if x.is_cuda:
        kernels.count(name)
    return out


class _TpSpatial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, wproj, bqkv, bproj, ln_scale, ln_bias,
                num_heads, scale, m):
        dt = x.dtype
        w = (_cast(wqkv, dt), _cast(wproj, dt), _cast(bqkv, dt),
             tk.as_f32(ln_scale), tk.as_f32(ln_bias))
        ctx.save_for_backward(x, *w)
        ctx.dtypes = tk.dtypes_of(wqkv, wproj, bqkv, bproj, ln_scale,
                                  ln_bias)
        ctx.args, ctx.mesh = dict(num_heads=num_heads, scale=scale), m
        return keep(frozenset({"attn_out"}), lambda: _counted(
            "tp_spatial_train_block", x, tk.through(spatial_fwd(
                x, w[0], _cast(wproj.t(), dt), w[2], _cast(bproj, dt),
                *w[3:], **ctx.args), _reducer(m))))

    @staticmethod
    def backward(ctx, dout):
        x, *w = ctx.saved_tensors
        grads = _counted("tp_spatial_train_block_bwd", x, tk.through(
            stb.spatial_train_block_steps(
                x, dout.contiguous(), *w,
                proj_bias=ctx.dtypes[3] is not None, **ctx.args),
            _reducer(ctx.mesh)))
        return (grads[0], *tk.like(grads[1:], ctx.dtypes), None, None, None)


class _TpTemporal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, wproj, bqkv, bproj, num_heads, scale, m):
        dt = x.dtype
        w = (_cast(wqkv, dt), _cast(wproj, dt), _cast(bqkv, dt))
        ctx.save_for_backward(x, *w)
        ctx.dtypes = tk.dtypes_of(wqkv, wproj, bqkv, bproj)
        ctx.args, ctx.mesh = dict(num_heads=num_heads, scale=scale), m
        return keep(frozenset({"attn_out"}), lambda: _counted(
            "tp_temporal_train_block", x, tk.through(temporal_fwd(
                x, w[0], _cast(wproj.t(), dt), w[2], _cast(bproj, dt),
                **ctx.args), _reducer(m))))

    @staticmethod
    def backward(ctx, dout):
        x, *w = ctx.saved_tensors
        grads = _counted("tp_temporal_train_block_bwd", x, tk.through(
            ttb.temporal_train_block_steps(
                x, dout.contiguous(), *w,
                proj_bias=ctx.dtypes[3] is not None, split=True,
                **ctx.args), _reducer(ctx.mesh)))
        return (grads[0], *tk.like(grads[1:], ctx.dtypes), None, None, None)


class _TpMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wfc1, wfc2, bfc1, bfc2, ln_scale, ln_bias,
                gelu_approx, m):
        dt = x.dtype
        w = (_cast(wfc1, dt), _cast(wfc2, dt), _cast(bfc1, dt),
             tk.as_f32(ln_scale), tk.as_f32(ln_bias))
        ctx.save_for_backward(x, *w)
        ctx.dtypes = tk.dtypes_of(wfc1, wfc2, bfc1, bfc2, ln_scale, ln_bias)
        ctx.gelu_approx, ctx.mesh = gelu_approx, m
        return _counted("tp_mlp_train_block", x, tk.through(mlp_fwd(
            x, w[0], _cast(wfc2.t(), dt), w[2], _cast(bfc2, dt), *w[3:],
            gelu_approx=gelu_approx), _reducer(m)))

    @staticmethod
    def backward(ctx, dout):
        x, *w = ctx.saved_tensors
        grads = _counted("tp_mlp_train_block_bwd", x, tk.through(
            mtb.mlp_train_block_steps(
                x, dout.contiguous(), *w, gelu_approx=ctx.gelu_approx,
                bias=ctx.dtypes[2] is not None, split=True),
            _reducer(ctx.mesh)))
        return (grads[0], *tk.like(grads[1:], ctx.dtypes), None, None)


def tp_spatial_train_block(x: torch.Tensor, wqkv: torch.Tensor,
                           wproj: torch.Tensor, *, num_heads: int,
                           scale: float, mesh: Mesh,
                           bqkv: Optional[torch.Tensor] = None,
                           bproj: Optional[torch.Tensor] = None,
                           ln_scale: Optional[torch.Tensor] = None,
                           ln_bias: Optional[torch.Tensor] = None):
    """Differentiable x (N, S, C) -> x + proj(mha(qkv(LN1(x)))) with this
    rank's share, the weights in `spatial_train_block`'s (in, out) layout:
    wqkv the (C, 3C/tp) qkv shard (its columns the rank's heads of q, of k
    and of v), wproj the (C/tp, C) proj shard, num_heads the rank's H / tp;
    bproj and the LN params whole. The
    forward's and the backward's one all-reduce each are over `mesh`'s
    model group. CUDA tensors launch LN1's row pass, `gemm_sm90`, K9 and
    the nt fp32 form of csrc/gemm_sm90.cuh forward, and K9, K10 and the
    training forms backward (head_dim 32, 64 or 128, S a multiple of 64 up
    to 4096, any number of heads a rank, C/tp a multiple of 8; each launcher
    raises at a shape its kernel does not take); CPU tensors the same
    launchers' plain versions."""
    require(ln_scale is not None and ln_bias is not None,
            "the TP spatial sub-layer needs the LN1 parameters")
    return _TpSpatial.apply(x.contiguous(), wqkv, wproj, bqkv, bproj,
                            ln_scale, ln_bias, num_heads, scale, mesh)


def tp_temporal_train_block(x: torch.Tensor, wqkv: torch.Tensor,
                            wproj: torch.Tensor, *, num_heads: int,
                            scale: float, mesh: Mesh,
                            bqkv: Optional[torch.Tensor] = None,
                            bproj: Optional[torch.Tensor] = None):
    """Differentiable x (B, T, S, C) -> x + proj(causal MHA over T of
    qkv(x)) with this rank's share (the shards as in
    `tp_spatial_train_block`). CUDA tensors launch the training forms of
    csrc/gemm_sm90.cuh and K4 forward, K6 and the training forms backward
    (T <= 32, head_dim 32, 64 or 128, any number of heads a rank: one, as
    GENIE_35M at tp = 8, included); CPU tensors the plain versions."""
    return _TpTemporal.apply(x.contiguous(), wqkv, wproj, bqkv, bproj,
                             num_heads, scale, mesh)


def tp_mlp_train_block(x: torch.Tensor, wfc1: torch.Tensor,
                       wfc2: torch.Tensor, *, mesh: Mesh,
                       bfc1: Optional[torch.Tensor] = None,
                       bfc2: Optional[torch.Tensor] = None,
                       ln_scale: Optional[torch.Tensor] = None,
                       ln_bias: Optional[torch.Tensor] = None,
                       gelu_approx: bool = False):
    """Differentiable x (N, S, C) -> x + fc2(GELU(fc1(LN2(x)))) with this
    rank's hidden columns, the weights in `mlp_train_block`'s (in, out)
    layout: wfc1 the (C, hidden/tp) shard and bfc1 its (hidden/tp,) bias,
    wfc2 the (hidden/tp, C) shard; bfc2 and the LN params (both or neither)
    whole. CUDA tensors launch the training
    forms of csrc/gemm_sm90.cuh and the LN row passes (hidden/tp a multiple
    of 8); CPU tensors the plain versions."""
    require((bfc1 is None) == (bfc2 is None), "pass both MLP biases or neither")
    require((ln_scale is None) == (ln_bias is None),
            "pass both LN params or neither")
    return _TpMlp.apply(x.contiguous(), wfc1, wfc2, bfc1, bfc2, ln_scale,
                        ln_bias, gelu_approx, mesh)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m):
        ctx.mesh = m
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = model_all_reduce(g.float().contiguous().clone(), ctx.mesh)
        return total.to(g.dtype), None


def copy_to_model(x: torch.Tensor, m: Mesh) -> torch.Tensor:
    """Megatron's f on a replicated tensor that each rank uses for its own
    heads (the qk-LN's parameters): x as it is; its gradient summed over
    the model group (in fp32)."""
    return _CopyToModel.apply(x, m)


class _ColumnParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, m):
        wc = _cast(w, x.dtype)
        ctx.save_for_backward(x, wc)
        ctx.wdtype, ctx.mesh = w.dtype, m
        return torch.matmul(x, wc.t())

    @staticmethod
    def backward(ctx, dy):
        x, wc = ctx.saved_tensors
        dy = dy.contiguous()
        part = tk.gemm90(dy, wc.t().contiguous(), form="nt", fp32_out=True)
        dx = model_all_reduce(part, ctx.mesh).to(x.dtype)
        dw = _counted("tp_column_parallel_bwd", x, tk.gemm90(dy, x,
                                                             form="tn"))
        return dx, dw.to(ctx.wdtype), None


def column_parallel(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor], m: Mesh) -> torch.Tensor:
    """The op-by-op column-parallel product (with Megatron's f before it):
    x (..., in), whole on every rank, times the torch-layout (out/tp, in)
    shard w in x's dtype, rounded once, + the bias shard in x's dtype, as
    `_util.dense` computes its columns in one process. Backward: the
    rank's part of dx = dy w as a product's fp32 store (`tk.gemm90` nt),
    summed over the model group and rounded once, as one process's product
    rounds the whole sum; dw = dy^T x (`tk.gemm90` tn). CUDA tensors take
    cuBLAS forward, as the one-process path does, and the training forms of
    csrc/gemm_sm90.cuh backward (in and out/tp multiples of 8); CPU tensors
    their plain versions."""
    lead = x.shape[:-1]
    y = _ColumnParallel.apply(x.reshape(-1, x.shape[-1]).contiguous(), w, m)
    if b is not None:
        y = y + b.to(x.dtype)
    return y.view(*lead, -1)


class _RowParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, m):
        wc = _cast(w, h.dtype)
        ctx.save_for_backward(h, wc)
        ctx.wdtype = w.dtype
        part = _counted("tp_row_parallel", h, tk.gemm90(
            h, wc, form="nt", fp32_out=True))
        return model_all_reduce(part, m).to(h.dtype)

    @staticmethod
    def backward(ctx, g):
        h, wc = ctx.saved_tensors
        g = g.contiguous()
        dh = tk.gemm90(g, wc)
        dw = _counted("tp_row_parallel_bwd", h, tk.gemm90(g, h, form="tn"))
        return dh, dw.to(ctx.wdtype), None


def row_parallel(h: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor], m: Mesh) -> torch.Tensor:
    """The op-by-op row-parallel product (with Megatron's g after it): h
    (..., in/tp) times the torch-layout (out, in/tp) shard w in h's dtype,
    the product's fp32 store (`tk.gemm90` nt) summed over the model group
    and rounded once, + the whole bias in h's dtype, as `_util.dense`
    computes the whole product in one process. Backward: dh = dy w, dw =
    dy^T h, the gradient of the sum taken as it is. CUDA tensors launch the
    training forms of csrc/gemm_sm90.cuh (out and in/tp multiples of 8),
    CPU tensors their plain versions."""
    lead = h.shape[:-1]
    y = _RowParallel.apply(h.reshape(-1, h.shape[-1]).contiguous(), w, m)
    if b is not None:
        y = y + b.to(h.dtype)
    return y.view(*lead, -1)
