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
MLP train block without its LayerNorm. Dropout is not ported: a rate above 0
raises in training mode.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
from torch import nn

from tpu1x_torch.ops._util import dense
from tpu1x_torch.ops.attention import mha
from tpu1x_torch.ops.layernorm import layer_norm_plain
from tpu1x_torch.ops.mlp_train_block import mlp_train_block
from tpu1x_torch.ops.spatial_train_block import spatial_train_block
from tpu1x_torch.ops.temporal_train_block import temporal_train_block


class SelfAttention(nn.Module):
    def __init__(self, num_heads: int, d_model: int, qkv_bias: bool = False,
                 proj_bias: bool = True, qk_norm: bool = True,
                 use_mup: bool = False, device=None):
        super().__init__()
        self.num_heads = num_heads
        head_dim = d_model // num_heads
        self.scale = 8.0 / head_dim if use_mup else head_dim ** -0.5
        self.qkv = nn.Linear(d_model, 3 * d_model, bias=qkv_bias,
                             device=device)
        self.proj = nn.Linear(d_model, d_model, bias=proj_bias, device=device)
        if qk_norm:
            self.norm = nn.LayerNorm(head_dim, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, causal: bool, mha=mha) -> torch.Tensor:
        """Attention over axis -2 of x (..., N, C) by `mha`, between the
        qkv and proj products, with the fp32 qk-LayerNorm shared by q and k
        when the module has one."""
        H = self.num_heads
        qkv = dense(x, self.qkv.weight.t(), self.qkv.bias)
        q, k, v = qkv.reshape(*x.shape[:-1], 3, H, -1).unbind(-3)
        if hasattr(self, "norm"):
            q = layer_norm_plain(q.float(), self.norm.weight,
                                 self.norm.bias).to(v.dtype)
            k = layer_norm_plain(k.float(), self.norm.weight,
                                 self.norm.bias).to(v.dtype)
        out = mha(q, k, v, scale=self.scale, causal=causal)
        return dense(out.reshape(x.shape), self.proj.weight.t(),
                     self.proj.bias)


class Mlp(nn.Module):
    def __init__(self, d_model: int, mlp_ratio: float = 4.0,
                 mlp_bias: bool = True, device=None):
        super().__init__()
        hidden = int(d_model * mlp_ratio)
        self.fc1 = nn.Linear(d_model, hidden, bias=mlp_bias, device=device)
        self.fc2 = nn.Linear(hidden, d_model, bias=mlp_bias, device=device)


class STBlock(nn.Module):
    # The three train blocks, and the attention of the qk_norm models. Each
    # takes its kernels for a CUDA tensor and its plain version for a CPU
    # tensor; a measuring script that needs the plain path on the card as
    # its oracle swaps this namespace.
    ops = SimpleNamespace(spatial=spatial_train_block,
                          temporal=temporal_train_block,
                          mlp=mlp_train_block, mha=mha)

    def __init__(self, num_heads: int, d_model: int, qkv_bias: bool = False,
                 proj_bias: bool = True, qk_norm: bool = True,
                 mlp_ratio: float = 4.0, mlp_bias: bool = True,
                 use_mup: bool = False, attn_drop: float = 0.0,
                 mlp_drop: float = 0.0, gelu_approx: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        attn = dict(num_heads=num_heads, d_model=d_model, qkv_bias=qkv_bias,
                    proj_bias=proj_bias, qk_norm=qk_norm, use_mup=use_mup,
                    device=device)
        self.spatial_attn = SelfAttention(**attn)
        self.temporal_attn = SelfAttention(**attn)
        self.mlp = Mlp(d_model, mlp_ratio, mlp_bias, device=device)
        self.qk_norm = qk_norm
        self.dropout = max(attn_drop, mlp_drop)
        self.gelu_approx = gelu_approx
        self.dtype = dtype
        if not qk_norm:
            self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
            self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def _mlp(self, x_NSC, norm):
        m = self.mlp
        return self.ops.mlp(
            x_NSC, m.fc1.weight.t(), m.fc2.weight.t(), bfc1=m.fc1.bias,
            bfc2=m.fc2.bias, ln_scale=None if norm is None else norm.weight,
            ln_bias=None if norm is None else norm.bias,
            gelu_approx=self.gelu_approx)

    def forward(self, x_BTSC: torch.Tensor) -> torch.Tensor:
        if self.training and self.dropout > 0.0:
            raise NotImplementedError("dropout is not ported: train with "
                                      "attn_drop = mlp_drop = 0")
        B, T, S, C = x_BTSC.shape
        x = x_BTSC.to(self.dtype)
        sa, ta = self.spatial_attn, self.temporal_attn
        if self.qk_norm:
            x = x + sa(x, causal=False, mha=self.ops.mha)
            x = x.transpose(1, 2)
            x = (x + ta(x, causal=True, mha=self.ops.mha)).transpose(1, 2)
            return self._mlp(x.reshape(B * T, S, C), None).reshape(B, T, S, C)
        x = self.ops.spatial(
            x.reshape(B * T, S, C), sa.qkv.weight.t(), sa.proj.weight.t(),
            num_heads=sa.num_heads, scale=sa.scale, bqkv=sa.qkv.bias,
            bproj=sa.proj.bias, ln_scale=self.norm1.weight,
            ln_bias=self.norm1.bias).reshape(B, T, S, C)
        x = self.ops.temporal(
            x, ta.qkv.weight.t(), ta.proj.weight.t(), num_heads=ta.num_heads,
            scale=ta.scale, bqkv=ta.qkv.bias, bproj=ta.proj.bias)
        return self._mlp(x.reshape(B * T, S, C), self.norm2).reshape(
            B, T, S, C)


class STTransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, **block_kwargs):
        super().__init__()
        self.layers = nn.ModuleList(STBlock(**block_kwargs)
                                    for _ in range(num_layers))

    def forward(self, x_BTSC: torch.Tensor) -> torch.Tensor:
        """A plain loop over the layers; every sub-layer keeps its input for
        the backward, which recomputes the rest inside the kernels."""
        for layer in self.layers:
            x_BTSC = layer(x_BTSC)
        return x_BTSC
