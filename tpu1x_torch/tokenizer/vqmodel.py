"""VQModel: the Open-MAGVIT2 LFQ tokenizer's inference path, the JAX
package's `tpu1x/tokenizer/vqmodel.py` in PyTorch.

- encode: Encoder -> LFQ -> (quantized, indices, and with training=True the
  auxiliary losses);
- decode: ±1 codes -> Decoder -> images in [-1, 1];
- decode_tokens: ids (dataset bit order) -> codebook entries -> decode.

The public methods take and return the JAX package's layout: images
(B, H, W, 3), ids (B, h, w), codes (B, h, w, D); NCHW inside.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from tpu1x_torch.config import VQConfig
from tpu1x_torch.tokenizer.cnn import Decoder, Encoder
from tpu1x_torch.tokenizer.lfq import LFQ, LFQResult, codebook_entry


class VQModel(nn.Module):
    """Encoder and decoder; the LFQ quantizer has no parameters."""

    def __init__(self, config: VQConfig, device=None):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config, device=device)
        self.decoder = Decoder(config, device=device)
        self.quantizer = LFQ(config)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VQModel":
        """flax's initialisation, drawn from `generator`: conv kernels
        normal with variance 1 / fan_in (LeCun; flax truncates the normal
        at two deviations, this does not), biases zero, GroupNorms at
        identity."""
        for name, p in self.named_parameters():
            if p.dim() == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            elif ".norm" in name and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
        return self

    def encode(self, x: torch.Tensor, training: bool = False) -> LFQResult:
        """x: (B, H, W, 3) in [-1, 1] -> LFQResult with quantized
        (B, h, w, D) and indices (B, h, w)."""
        z = self.encoder(x.permute(0, 3, 1, 2))
        return self.quantizer(z.permute(0, 2, 3, 1), training=training)

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        """quant: (B, h, w, D) ±1 codes -> (B, H, W, 3) fp32."""
        return self.decoder(quant.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def decode_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """ids: (B, h, w) -> images (B, H, W, 3) fp32."""
        return self.decode(codebook_entry(ids, self.config.z_channels))

    def forward(self, x: torch.Tensor, training: bool = False):
        """The full autoencode: (reconstruction, LFQResult)."""
        result = self.encode(x, training=training)
        return self.decode(result.quantized), result


def rescale_magvit_output(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> uint8: (x + 1) 127.5 clipped to [0, 255], then
    truncated (not rounded), as the reference's visualizer does."""
    return ((x + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
