"""Spatio-temporal transformer blocks with the reference's torch state-dict
names:

    decoder.layers.{i}.{spatial,temporal}_attn.qkv.{weight,bias}  (3C, C)
    decoder.layers.{i}.{spatial,temporal}_attn.proj.{weight,bias} (C, C)
    decoder.layers.{i}.{spatial,temporal}_attn.norm.{weight,bias} (head_dim,)
    decoder.layers.{i}.norm{1,2}.{weight,bias}                     (C,)
    decoder.layers.{i}.mlp.fc{1,2}.{weight,bias}

`norm1`/`norm2` exist only when qk_norm is off (the reference's Identity
otherwise), and the temporal attention has no pre-norm. The serving path
(tpu1x_torch/serving.py) reads these parameters; `forward` is the training
forward over (B, T, S, C).

With qk_norm off, `STBlock.forward` is the three train blocks (spatial,
temporal, MLP): on the card each launches its kernels forward and backward,
on the CPU each takes its plain version under ordinary autograd. With
qk_norm on none of the fused spatial and temporal blocks applies, as in the
JAX package: each attention is the qkv product, the fp32 qk-LayerNorm, `mha`
and the proj product under ordinary autograd, where `mha` is the fused
attention kernel pair (forward and backward) for the S = 256 spatial axis on
the card and the plain attention for the T = 16 frame axis; the MLP is the
MLP train block without its LayerNorm.

Dropout, in training only, follows the JAX package's formula and routing
(tpu1x/models/st_transformer.py, tpu1x/ops/attention.py): on each
attention's output before its proj (`attn_drop`), and after fc1's GELU and
after fc2 (`mlp_drop`). With `attn_drop` above 0 both attention sub-layers
run op by op as under qk_norm (LN1 in fp32 before the spatial one on the
pre-LN models); with `mlp_drop` above 0 the MLP is plain torch. The masks
keep each value with probability 1 - p and scale it by 1 / (1 - p), drawn
from the `generator` passed to `forward`. In eval mode dropout is the
identity. (The JAX package's STMaskGIT leaves its blocks deterministic, so
its trainer never draws a mask; these are its blocks' training formula.)

Under tensor parallelism (`parallel/tensor.py` `split_model`) each block
holds its rank's share of the heads and MLP columns: the three fused
sub-layers become the TP sub-layers (the same kernels at the rank's shapes,
one all-reduce over the model group forward and one backward), and the
op-by-op ones run their products column- and row-parallel with Megatron's
f and g (`tensor.column_parallel`, `tensor.row_parallel`), rounding where
one process rounds. A dropout mask over heads or hidden columns
is drawn whole and sliced to the rank's share, so that the ranks of a model
group draw alike and keep equal replicated activations.

With `remat` (the JAX package's default) each block is recomputed in the
backward under `remat_policy` (tpu1x_torch/ops/remat.py), except where the
policy keeps all the block keeps without it: "attn_outs" on the fused path,
whose train blocks already keep only their inputs (the block input and the
two attention sub-layers' outputs), runs as without remat and launches
nothing more.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Optional

import torch
from torch import nn

from tpu1x_torch.ops import remat
from tpu1x_torch.ops._util import gelu
from tpu1x_torch.ops.attention import mha
from tpu1x_torch.ops.layernorm import layer_norm_plain
from tpu1x_torch.ops.mlp_train_block import mlp_train_block
from tpu1x_torch.ops.spatial_train_block import spatial_train_block
from tpu1x_torch.ops.temporal_train_block import temporal_train_block
from tpu1x_torch.parallel import tensor as tensor_parallel


class SelfAttention(nn.Module):
    def __init__(self, num_heads: int, d_model: int, qkv_bias: bool = False,
                 proj_bias: bool = True, qk_norm: bool = True,
                 use_mup: bool = False, device=None):
        super().__init__()
        self.num_heads = num_heads  # this rank's, under tensor parallelism
        self.heads, self.head0, self.mesh = num_heads, 0, None
        head_dim = d_model // num_heads
        self.scale = 8.0 / head_dim if use_mup else head_dim ** -0.5
        self.qkv = nn.Linear(d_model, 3 * d_model, bias=qkv_bias,
                             device=device)
        self.proj = nn.Linear(d_model, d_model, bias=proj_bias, device=device)
        if qk_norm:
            self.norm = nn.LayerNorm(head_dim, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, causal: bool, mha=mha,
                drop: float = 0.0, generator=None) -> torch.Tensor:
        """Attention over axis -2 of x (..., N, C) by `mha`, between the
        qkv and proj products, with the fp32 qk-LayerNorm shared by q and k
        when the module has one, and dropout at rate `drop` on the
        attention's output. Split over a model axis, x is whole and the
        heads the rank's."""
        H, m = self.num_heads, self.mesh
        lead = x.shape[:-1]
        if m is None:
            qkv = remat.dense(x, self.qkv.weight.t(), self.qkv.bias)
        else:
            qkv = tensor_parallel.column_parallel(x, self.qkv.weight,
                                                  self.qkv.bias, m)
        q, k, v = qkv.reshape(*lead, 3, H, -1).unbind(-3)
        if hasattr(self, "norm"):
            ln_w, ln_b = self.norm.weight, self.norm.bias
            if m is not None:  # shared by every head: its gradient sums
                # the heads of all ranks
                ln_w, ln_b = (tensor_parallel.copy_to_model(t, m)
                              for t in (ln_w, ln_b))
            q = layer_norm_plain(q.float(), ln_w, ln_b).to(v.dtype)
            k = layer_norm_plain(k.float(), ln_w, ln_b).to(v.dtype)
        out = mha(q, k, v, scale=self.scale, causal=causal)
        if m is None:
            out = dropout(out, drop, generator)
        else:  # the rank's heads of a whole mask
            out = dropout(out, drop, generator,
                          share=(-2, self.head0, self.heads))
        out = out.reshape(*lead, -1)
        if m is not None:
            return tensor_parallel.row_parallel(out, self.proj.weight,
                                                self.proj.bias, m)
        return remat.dense(out, self.proj.weight.t(), self.proj.bias)


def dropout(x: torch.Tensor, p: float, generator: torch.Generator = None,
            share=None) -> torch.Tensor:
    """flax's `nn.Dropout` in training: keep with probability 1 - p, scale
    the kept values by 1 / (1 - p) in x's dtype, mask from `generator`.
    `share` (dim, start, whole) says that x is the slice [start, start +
    x.shape[dim]) of a tensor `whole` long along dim: the mask is drawn for
    the whole tensor and sliced alike."""
    if p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training draws its masks from a "
                         "torch.Generator: pass generator=")
    shape = list(x.shape)
    if share is not None:
        dim, start, whole = share
        shape[dim] = whole
    keep = torch.rand(shape, generator=generator, device=x.device) < 1 - p
    if share is not None:
        keep = keep.narrow(dim, start, x.shape[dim])
    return torch.where(keep, x / (1 - p), torch.zeros((), dtype=x.dtype,
                                                      device=x.device))


class Mlp(nn.Module):
    def __init__(self, d_model: int, mlp_ratio: float = 4.0,
                 mlp_bias: bool = True, device=None):
        super().__init__()
        hidden = int(d_model * mlp_ratio)
        # the whole hidden width, this rank's first column, the mesh it is
        # split over (tensor parallelism)
        self.hidden, self.col0, self.mesh = hidden, 0, None
        self.fc1 = nn.Linear(d_model, hidden, bias=mlp_bias, device=device)
        self.fc2 = nn.Linear(hidden, d_model, bias=mlp_bias, device=device)


class STBlock(nn.Module):
    # The three train blocks, and the attention of the op-by-op sub-layers.
    # Each takes its kernels for a CUDA tensor and its plain version for a
    # CPU tensor; a measuring script that needs the plain path on the card
    # as its oracle swaps this namespace.
    ops = SimpleNamespace(spatial=spatial_train_block,
                          temporal=temporal_train_block,
                          mlp=mlp_train_block, mha=mha)

    def __init__(self, num_heads: int, d_model: int, qkv_bias: bool = False,
                 proj_bias: bool = True, qk_norm: bool = True,
                 mlp_ratio: float = 4.0, mlp_bias: bool = True,
                 use_mup: bool = False, attn_drop: float = 0.0,
                 mlp_drop: float = 0.0, gelu_approx: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 remat_policy: Optional[str] = None, device=None):
        super().__init__()
        attn = dict(num_heads=num_heads, d_model=d_model, qkv_bias=qkv_bias,
                    proj_bias=proj_bias, qk_norm=qk_norm, use_mup=use_mup,
                    device=device)
        self.spatial_attn = SelfAttention(**attn)
        self.temporal_attn = SelfAttention(**attn)
        self.mlp = Mlp(d_model, mlp_ratio, mlp_bias, device=device)
        self.qk_norm = qk_norm
        self.attn_drop, self.mlp_drop = attn_drop, mlp_drop
        self.gelu_approx = gelu_approx
        self.dtype = dtype
        if remat_policy is not None and remat_policy not in remat.KEEPS:
            raise ValueError(f"remat_policy must be one of "
                             f"{sorted(remat.KEEPS)}, got {remat_policy!r}")
        self.remat_policy = remat_policy  # None: no recompute
        if not qk_norm:
            self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
            self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def _rates(self):
        return ((self.attn_drop, self.mlp_drop) if self.training
                else (0.0, 0.0))

    def _recomputes(self) -> bool:
        """Whether the backward reruns the block: under remat, unless the
        policy is "attn_outs" and all three sub-layers are train blocks."""
        if (self.remat_policy is None or not self.training
                or not torch.is_grad_enabled()):
            return False
        fused = not self.qk_norm and self._rates() == (0.0, 0.0)
        return not (fused and self.remat_policy == "attn_outs")

    def forward(self, x_BTSC: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The block over (B, T, S, C) in the compute dtype. `generator`
        draws the dropout masks (needed in training with a rate above 0)."""
        x = x_BTSC.to(self.dtype)
        if not self._recomputes():
            return self._forward(x, generator)
        return remat.recompute(lambda h: self._forward(h, generator), x,
                               tuple(self.parameters()), self.remat_policy,
                               generator)

    def _train_blocks(self):
        """The three fused sub-layers: the ops' train blocks, or on a model
        split over a model axis the TP sub-layers on this rank's share."""
        m = self.mlp.mesh
        if m is None:
            return self.ops.spatial, self.ops.temporal, self.ops.mlp
        return (functools.partial(tensor_parallel.tp_spatial_train_block,
                                  mesh=m),
                functools.partial(tensor_parallel.tp_temporal_train_block,
                                  mesh=m),
                functools.partial(tensor_parallel.tp_mlp_train_block, mesh=m))

    def _forward(self, x, generator):
        B, T, S, C = x.shape
        sa, ta = self.spatial_attn, self.temporal_attn
        spatial, temporal, mlp = self._train_blocks()
        attn_drop, mlp_drop = self._rates()
        if self.qk_norm or attn_drop > 0.0:
            # op by op: the fused attention pair for the S axis, the plain
            # attention for the T axis, the products in plain torch
            h = x if self.qk_norm else layer_norm_plain(
                x, self.norm1.weight, self.norm1.bias)
            x = x + sa(h, causal=False, mha=self.ops.mha, drop=attn_drop,
                       generator=generator)
            x = x.transpose(1, 2)
            x = (x + ta(x, causal=True, mha=self.ops.mha, drop=attn_drop,
                        generator=generator)).transpose(1, 2)
        else:
            x = spatial(
                x.reshape(B * T, S, C), sa.qkv.weight.t(), sa.proj.weight.t(),
                num_heads=sa.num_heads, scale=sa.scale, bqkv=sa.qkv.bias,
                bproj=sa.proj.bias, ln_scale=self.norm1.weight,
                ln_bias=self.norm1.bias).reshape(B, T, S, C)
            x = temporal(
                x, ta.qkv.weight.t(), ta.proj.weight.t(),
                num_heads=ta.num_heads, scale=ta.scale, bqkv=ta.qkv.bias,
                bproj=ta.proj.bias)
        norm = None if self.qk_norm else self.norm2
        m = self.mlp
        ln = {} if norm is None else dict(ln_scale=norm.weight,
                                          ln_bias=norm.bias)
        if mlp_drop > 0.0:
            h = x if norm is None else layer_norm_plain(x, norm.weight,
                                                        norm.bias)
            if m.mesh is None:
                h = remat.dense(h, m.fc1.weight.t(), m.fc1.bias)
            else:
                h = tensor_parallel.column_parallel(h, m.fc1.weight,
                                                    m.fc1.bias, m.mesh)
            h = gelu(h, self.gelu_approx)
            if m.mesh is None:
                h = remat.dense(dropout(h, mlp_drop, generator),
                                m.fc2.weight.t(), m.fc2.bias)
            else:  # the rank's columns of a whole mask
                h = dropout(h, mlp_drop, generator,
                            share=(-1, m.col0, m.hidden))
                h = tensor_parallel.row_parallel(h, m.fc2.weight, m.fc2.bias,
                                                 m.mesh)
            return x + dropout(h, mlp_drop, generator)
        return mlp(
            x.reshape(B * T, S, C), m.fc1.weight.t(), m.fc2.weight.t(),
            bfc1=m.fc1.bias, bfc2=m.fc2.bias, gelu_approx=self.gelu_approx,
            **ln).reshape(B, T, S, C)


class STTransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, **block_kwargs):
        super().__init__()
        self.layers = nn.ModuleList(STBlock(**block_kwargs)
                                    for _ in range(num_layers))

    def forward(self, x_BTSC: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A plain loop over the layers; `generator` draws the dropout
        masks."""
        for layer in self.layers:
            x_BTSC = layer(x_BTSC, generator=generator)
        return x_BTSC
