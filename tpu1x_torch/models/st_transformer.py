"""Spatio-temporal transformer blocks, as parameter containers with the
reference's torch state-dict names:

    decoder.layers.{i}.{spatial,temporal}_attn.qkv.{weight,bias}  (3C, C)
    decoder.layers.{i}.{spatial,temporal}_attn.proj.{weight,bias} (C, C)
    decoder.layers.{i}.{spatial,temporal}_attn.norm.{weight,bias} (head_dim,)
    decoder.layers.{i}.norm{1,2}.{weight,bias}                     (C,)
    decoder.layers.{i}.mlp.fc{1,2}.{weight,bias}

`norm1`/`norm2` exist only when qk_norm is off (the reference's Identity
otherwise), and the temporal attention has no pre-norm. The serving path
(tpu1x_torch/serving.py) reads these parameters; the training forward
(`compute_logits`) waits for the training slice.
"""

from __future__ import annotations

from torch import nn


class SelfAttention(nn.Module):
    def __init__(self, num_heads: int, d_model: int, qkv_bias: bool = False,
                 proj_bias: bool = True, qk_norm: bool = True, device=None):
        super().__init__()
        self.qkv = nn.Linear(d_model, 3 * d_model, bias=qkv_bias,
                             device=device)
        self.proj = nn.Linear(d_model, d_model, bias=proj_bias, device=device)
        if qk_norm:
            self.norm = nn.LayerNorm(d_model // num_heads, eps=1e-5,
                                     device=device)


class Mlp(nn.Module):
    def __init__(self, d_model: int, mlp_ratio: float = 4.0,
                 mlp_bias: bool = True, device=None):
        super().__init__()
        hidden = int(d_model * mlp_ratio)
        self.fc1 = nn.Linear(d_model, hidden, bias=mlp_bias, device=device)
        self.fc2 = nn.Linear(hidden, d_model, bias=mlp_bias, device=device)


class STBlock(nn.Module):
    def __init__(self, num_heads: int, d_model: int, qkv_bias: bool = False,
                 proj_bias: bool = True, qk_norm: bool = True,
                 mlp_ratio: float = 4.0, mlp_bias: bool = True, device=None):
        super().__init__()
        attn = dict(num_heads=num_heads, d_model=d_model, qkv_bias=qkv_bias,
                    proj_bias=proj_bias, qk_norm=qk_norm, device=device)
        self.spatial_attn = SelfAttention(**attn)
        self.temporal_attn = SelfAttention(**attn)
        self.mlp = Mlp(d_model, mlp_ratio, mlp_bias, device=device)
        if not qk_norm:
            self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
            self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)


class STTransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, **block_kwargs):
        super().__init__()
        self.layers = nn.ModuleList(STBlock(**block_kwargs)
                                    for _ in range(num_layers))
