"""The MAGVIT2 CNN encoder and decoder, the JAX package's
`tpu1x/tokenizer/cnn.py` in PyTorch.

The modules carry the reference's torch parameter names
(`magvit2/modules/diffusionmodules/improved_model.py`: `encoder.conv_in`,
`encoder.down.{i}.block.{j}.{norm1,conv1,norm2,conv2,nin_shortcut}`,
`encoder.down.{i}.downsample`, `encoder.mid_block.{j}`, `encoder.norm_out`,
`encoder.conv_out`; the decoder's `conv_in`, `mid_block.{j}`,
`up.{i}.block.{j}`, `up.{i}.upsample.conv1`, `norm_out`, `conv_out`), so a
reference Lightning state dict loads with `load_state_dict(strict=True)`.

Shapes are NCHW inside, in channels_last memory: the NHWC tensors that the
public functions of `vqmodel.py` take (the JAX package's layout) are
permuted, not copied, and cuDNN's convolutions, the norms and
`depth_to_space` keep that layout.
The arithmetic follows the JAX modules' order of
roundings at `dtype` (the config's compute type, bf16 by default):
- each conv rounds its input and its fp32 weight to `dtype` and runs with
  fp32 accumulation (cuDNN on the card, as XLA on the TPU), no bias;
  a bias, where the layer has one, is added in `dtype` after the rounding
  of the conv's output, as flax adds it;
- GroupNorm (32 groups, eps 1e-6) in fp32 with fp32 parameters, the
  variance as E[x^2] - E[x]^2 clipped at 0 and the output as
  (x - mean) * (rsqrt(var + eps) * scale) + bias, as flax computes it;
  then swish in fp32, then the cast to `dtype`;
- the residual add in `dtype`; the encoder's and decoder's outputs fp32.
Biases: the encoder's conv_in, the ResBlock convs and nin_shortcut have
none; the decoder's conv_in, the downsample, the upsample conv and conv_out
have one. The downsample is 3x3, stride 2, padding (1, 1) (torch's floor
semantics, not XLA's 'SAME', which pads (0, 1) there).

No kernel of the port runs here: the JAX package leaves the convolutions,
norms and pools to XLA, and the port leaves them to cuDNN and torch.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

GROUPS, EPS = 32, 1e-6


def conv(x: torch.Tensor, m: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """`m` applied at `dtype`: input and weight rounded to it, the bias
    added after the product's rounding."""
    y = F.conv2d(x.to(dtype), m.weight.to(dtype), None, m.stride, m.padding)
    if m.bias is not None:
        y = y + m.bias.to(dtype)[:, None, None]
    return y


def group_norm_swish(x: torch.Tensor, norm: nn.GroupNorm,
                     dtype: torch.dtype) -> torch.Tensor:
    """flax's fp32 GroupNorm of NCHW `x`, then swish, then the cast to
    `dtype`."""
    B, C, H, W = x.shape
    xf = x.float()
    # a view in either memory format
    grouped = xf.reshape(B, GROUPS, C // GROUPS, H, W)
    mean = grouped.mean((2, 3, 4))
    var = (grouped.square().mean((2, 3, 4)) - mean.square()).clamp_min(0.0)
    per_c = C // GROUPS
    mean = mean.repeat_interleave(per_c, 1)[:, :, None, None]
    mul = (torch.rsqrt(var + EPS).repeat_interleave(per_c, 1)
           * norm.weight.float())[:, :, None, None]
    y = (xf - mean) * mul + norm.bias.float()[:, None, None]
    return (y * torch.sigmoid(y)).to(dtype)


def depth_to_space(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Depth-to-space of an NCHW-shaped tensor in DCR order, the
    reference's: channel c of output pixel (h bs + i, w bs + j) is input
    channel (i bs + j) C' + c, the spatial block the *leading* factor.
    `F.pixel_shuffle` reads the channels as (c, i, j) (CRD) and would
    scramble the image. Written on the NHWC view, as the JAX package does;
    the result is NCHW-shaped in channels_last memory."""
    B, C, H, W = x.shape
    s = block_size
    if C % (s * s):
        raise ValueError(f"{C} channels do not split into {s}x{s} blocks")
    x = x.permute(0, 2, 3, 1).reshape(B, H, W, s, s, C // (s * s))
    x = x.transpose(2, 3)  # B, H, i, W, j, c
    return x.reshape(B, H * s, W * s, C // (s * s)).permute(0, 3, 1, 2)


class ResBlock(nn.Module):
    def __init__(self, in_filters: int, out_filters: int, device=None):
        super().__init__()
        self.norm1 = nn.GroupNorm(GROUPS, in_filters, eps=EPS, device=device)
        self.conv1 = nn.Conv2d(in_filters, out_filters, 3, padding=1,
                               bias=False, device=device)
        self.norm2 = nn.GroupNorm(GROUPS, out_filters, eps=EPS, device=device)
        self.conv2 = nn.Conv2d(out_filters, out_filters, 3, padding=1,
                               bias=False, device=device)
        if in_filters != out_filters:
            self.nin_shortcut = nn.Conv2d(in_filters, out_filters, 1,
                                          bias=False, device=device)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = conv(group_norm_swish(x, self.norm1, dtype), self.conv1, dtype)
        h = conv(group_norm_swish(h, self.norm2, dtype), self.conv2, dtype)
        if hasattr(self, "nin_shortcut"):
            x = conv(x, self.nin_shortcut, dtype)
        return h + x


def _res_blocks(channels, out, n, device):
    """`n` ResBlocks to `out` channels from `channels`; the first maps."""
    return nn.ModuleList([ResBlock(channels if j == 0 else out, out, device)
                          for j in range(n)])


class Encoder(nn.Module):
    """(B, 3, H, W) in [-1, 1] -> (B, z_channels, H/2^(L-1), W/2^(L-1))
    fp32, L = len(ch_mult); 256 -> 16 at the default config."""

    def __init__(self, config, device=None):
        super().__init__()
        cfg = config
        self.dtype = getattr(torch, cfg.dtype)
        ch = cfg.base_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, ch, 3, padding=1,
                                 bias=False, device=device)
        self.down = nn.ModuleList()
        for i, mult in enumerate(cfg.ch_mult):
            level = nn.Module()
            out = cfg.base_channels * mult
            level.block = _res_blocks(ch, out, cfg.num_res_blocks, device)
            ch = out
            if i < len(cfg.ch_mult) - 1:
                level.downsample = nn.Conv2d(ch, ch, 3, stride=2, padding=1,
                                             device=device)
            self.down.append(level)
        self.mid_block = _res_blocks(ch, ch, cfg.num_res_blocks, device)
        self.norm_out = nn.GroupNorm(GROUPS, ch, eps=EPS, device=device)
        self.conv_out = nn.Conv2d(ch, cfg.z_channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = conv(x, self.conv_in, dt)
        for level in self.down:
            for block in level.block:
                h = block(h, dt)
            if hasattr(level, "downsample"):
                h = conv(h, level.downsample, dt)
        for block in self.mid_block:
            h = block(h, dt)
        h = group_norm_swish(h, self.norm_out, dt)
        return conv(h, self.conv_out, dt).float()


class Decoder(nn.Module):
    """(B, z_channels, h, w) ±1 codes -> (B, 3, 2^(L-1) h, 2^(L-1) w) fp32
    in about [-1, 1]."""

    def __init__(self, config, device=None):
        super().__init__()
        cfg = config
        self.dtype = getattr(torch, cfg.dtype)
        ch = cfg.base_channels * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, ch, 3, padding=1,
                                 device=device)
        self.mid_block = _res_blocks(ch, ch, cfg.num_res_blocks, device)
        up = {}
        for i in reversed(range(len(cfg.ch_mult))):
            level = nn.Module()
            out = cfg.base_channels * cfg.ch_mult[i]
            level.block = _res_blocks(ch, out, cfg.num_res_blocks, device)
            ch = out
            if i > 0:
                level.upsample = nn.Module()
                level.upsample.conv1 = nn.Conv2d(ch, 4 * ch, 3, padding=1,
                                                 device=device)
            up[i] = level
        self.up = nn.ModuleList([up[i] for i in range(len(cfg.ch_mult))])
        self.norm_out = nn.GroupNorm(GROUPS, ch, eps=EPS, device=device)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1,
                                  device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = conv(z, self.conv_in, dt)
        for block in self.mid_block:
            h = block(h, dt)
        for level in reversed(self.up):
            for block in level.block:
                h = block(h, dt)
            if hasattr(level, "upsample"):
                h = depth_to_space(conv(h, level.upsample.conv1, dt), 2)
        h = group_norm_swish(h, self.norm_out, dt)
        return conv(h, self.conv_out, dt).float()
