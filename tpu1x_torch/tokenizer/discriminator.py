"""The PatchGAN discriminator (pix2pix's NLayerDiscriminator), the JAX
package's `tpu1x/tokenizer/discriminator.py` in PyTorch (the reference's
`magvit2/modules/discriminator/model.py:17-67`).

An `nn.Sequential` named `main`, so that the reference's state dict loads
with `strict=True`: conv 0 (4x4, stride 2) and its LeakyReLU(0.2); for
n = 1..N conv 3n-1 (4x4, stride 2, the last stride 1), norm 3n and
LeakyReLU 3n+1; conv_out 3N+2 (1 channel). The norm is BatchNorm, or
ActNorm with `use_actnorm`, when every conv has a bias; else only conv 0
and conv_out have one.

Arithmetic at `dtype`, as the tokenizer's convs (`cnn.conv`): each conv
rounds its input and weight, the bias added after the product's rounding;
each norm in fp32 with fp32 parameters, cast back to `dtype` before the
LeakyReLU; the output fp32. The public `forward` takes and returns the JAX
package's layout: images (B, H, W, C) -> patch logits (B, H', W', 1).

The BatchNorm is flax's, not `nn.BatchNorm2d`'s: momentum 0.99 (0.01 in
torch's convention), eps 1e-5, statistics in fp32 with the variance as
E[x^2] - E[x]^2 clipped at 0, and the running variance updated with that
*biased* batch variance (torch's stores the unbiased one). It keeps torch's
parameter and buffer names, `num_batches_tracked` included.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu1x_torch.tokenizer.cnn import conv


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """flax's BatchNorm over (B, H, W) of NCHW `x`, fp32 output."""

    def __init__(self, num_features: int, device=None):
        super().__init__(num_features, eps=1e-5, momentum=0.01, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = (xf.square().mean((0, 2, 3)) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(
                    mean, alpha=self.momentum)
                self.running_var.mul_(1 - self.momentum).add_(
                    var, alpha=self.momentum)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


class ActNorm(nn.Module):
    """h = scale (x + loc) per channel, in fp32 (the reference's
    `magvit2/modules/util.py:10-92`, its (1, C, 1, 1) `loc` and `scale` and
    its `initialized` buffer). `initialize` sets loc = -mean and scale =
    1 / (std + 1e-6), the std at ddof 1, over (B, H, W) of a batch."""

    def __init__(self, num_features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.loc = nn.Parameter(torch.zeros(1, num_features, 1, 1,
                                            device=device))
        self.scale = nn.Parameter(torch.ones(1, num_features, 1, 1,
                                             device=device))
        self.register_buffer("initialized", torch.tensor(
            0, dtype=torch.uint8, device=device))

    @torch.no_grad()
    def initialize(self, x: torch.Tensor) -> None:
        xf = x.float().transpose(0, 1).reshape(x.shape[1], -1)
        self.loc.copy_(-xf.mean(1).reshape(self.loc.shape))
        self.scale.copy_((1.0 / (xf.std(1) + self.eps)).reshape(
            self.scale.shape))
        self.initialized.fill_(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * (x.float() + self.loc)


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        bias = use_actnorm  # BatchNorm subsumes the bias; ActNorm does not

        def norm(c):
            return (ActNorm(c, device=device) if use_actnorm
                    else FlaxBatchNorm2d(c, device=device))

        layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1, device=device),
                  nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4,
                                 2 if n < n_layers else 1, 1, bias=bias,
                                 device=device),
                       norm(ndf * mult), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * mult, 1, 4, 1, 1, device=device))
        self.main = nn.Sequential(*layers)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator
                     ) -> "NLayerDiscriminator":
        """flax's initialisation, drawn from `generator`: conv kernels
        normal with variance 1 / fan_in (flax truncates the normal at two
        deviations, this does not), biases zero, norms at identity."""
        for m in self.main:
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, FlaxBatchNorm2d):
                m.reset_parameters()
        return self

    def _layers(self, x: torch.Tensor, init_actnorm: bool = False):
        dt = self.dtype
        h = x.permute(0, 3, 1, 2).to(dt)
        for m in self.main:
            if isinstance(m, nn.Conv2d):
                h = conv(h, m, dt)
            elif isinstance(m, nn.LeakyReLU):
                h = F.leaky_relu(h, 0.2)
            else:
                if init_actnorm and isinstance(m, ActNorm):
                    m.initialize(h)
                h = m(h).to(dt)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images -> (B, H', W', 1) fp32 patch logits."""
        return self._layers(x).float().permute(0, 2, 3, 1)

    @torch.no_grad()
    def init_actnorm(self, x: torch.Tensor) -> None:
        """ActNorm's data-dependent initialization on the (B, H, W, C)
        batch `x`, layer by layer, each layer's statistics taken after the
        earlier ones were set (as flax's `init` runs the forward pass)."""
        self._layers(x, init_actnorm=True)
