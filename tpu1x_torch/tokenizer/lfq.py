"""Lookup-Free Quantization (Open-MAGVIT2 / "Language Model Beats
Diffusion"), the JAX package's `tpu1x/tokenizer/lfq.py` in PyTorch.

- Quantize: the sign of each of the D latent channels -> ±1, with the
  straight-through gradient `z + (q - z).detach()`.
- Token ids: the D bits packed into [0, 2^D) in the *dataset* convention,
  decoder channel k carrying bit (id >> k) & 1 (the reference's
  `get_codebook_entry(...).flip(1)` on its decode path); `bit_order=
  "reference"` gives the reference encoder's descending order.
- With `training=True`, the entropy terms at temperature T over the full
  2^D codebook: the per-sample entropy exactly, as the sum of D Bernoulli
  entropies (the codes are every ±1 combination, so the softmax over them
  factorizes per bit), and the codebook entropy of the batch-mean
  distribution in chunks of the codebook; and the commit loss MSE(z, sg(q)).

Every function takes channel-last tensors (..., D), as the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class LFQResult(NamedTuple):
    quantized: torch.Tensor       # same shape as the input, ±1, STE gradient
    indices: torch.Tensor         # (...,) int32 token ids
    entropy_loss: torch.Tensor    # scalar
    commit_loss: torch.Tensor     # scalar
    per_sample_entropy: torch.Tensor
    codebook_entropy: torch.Tensor


def _bit_weights(num_bits: int, bit_order: str, device) -> torch.Tensor:
    if bit_order not in ("dataset", "reference"):
        raise ValueError(f"bit_order {bit_order!r}")
    w = 2 ** torch.arange(num_bits, dtype=torch.int32, device=device)
    return w if bit_order == "dataset" else w.flip(0)


def bits_to_indices(bits: torch.Tensor,
                    bit_order: str = "dataset") -> torch.Tensor:
    """bool (..., D) -> int32 ids. "dataset": channel k has weight 2^k;
    "reference": channel 0 is the most significant bit."""
    w = _bit_weights(bits.shape[-1], bit_order, bits.device)
    return (bits.to(torch.int32) * w).sum(-1, dtype=torch.int32)


def indices_to_bits(ids: torch.Tensor, num_bits: int,
                    bit_order: str = "dataset") -> torch.Tensor:
    """int (...,) -> bool (..., num_bits); the inverse of
    `bits_to_indices`."""
    w = _bit_weights(num_bits, bit_order, ids.device)
    return (ids.to(torch.int32)[..., None] & w) != 0


def codebook_entry(ids: torch.Tensor, num_bits: int = 18) -> torch.Tensor:
    """Token ids -> ±1 fp32 latent vectors (..., num_bits), dataset bit
    order."""
    return indices_to_bits(ids, num_bits).float() * 2.0 - 1.0


def bernoulli_entropy_sum(z: torch.Tensor,
                          temperature: float) -> torch.Tensor:
    """Exact per-sample entropy (nats) of the softmax of 2 z.c / T over all
    codes c in {±1}^D: the sum over channels of the binary entropy of a
    Bernoulli with logit gap 2a, a = 2 z / T, computed stably as
    log(e^a + e^-a) - a tanh(a)."""
    a = 2.0 * z / temperature
    absa = a.abs()
    log_z = absa + torch.log1p(torch.exp(-2 * absa))
    return (log_z - a * torch.tanh(a)).sum(-1)


def codebook_entropy_chunked(z_flat: torch.Tensor, temperature: float,
                             num_bits: int, chunk: int = 1 << 14,
                             eps: float = 1e-5) -> torch.Tensor:
    """Entropy of the batch-averaged code distribution over all 2^num_bits
    codes, `chunk` codes at a time: log p(code) is a product of the
    per-bit log-probabilities with the code's bits, accumulated in fp32.
    z_flat: (N, D)."""
    num_codes = 1 << num_bits
    # a chunk past the codebook would repeat codes through the dropped
    # high bits of their ids
    chunk = min(chunk, num_codes)
    a = 2.0 * z_flat.float() / temperature
    logp1 = F.logsigmoid(2 * a)   # bit = 1
    logp0 = F.logsigmoid(-2 * a)  # bit = 0
    avg = []
    for start in range(0, num_codes, chunk):
        ids = start + torch.arange(chunk, dtype=torch.int32,
                                   device=z_flat.device)
        bits = indices_to_bits(ids, num_bits).float()  # (chunk, D)
        lp = logp1 @ bits.T + logp0 @ (1.0 - bits).T
        avg.append(torch.exp(lp).mean(0))
    avg_probs = torch.cat(avg)
    return -(avg_probs * torch.log(avg_probs + eps)).sum()


class LFQ:
    """The parameter-free quantizer."""

    def __init__(self, config, entropy_chunk: int = 1 << 14):
        self.num_bits = config.z_channels
        self.codebook_size = config.codebook_size
        self.temperature = config.entropy_temperature
        self.token_factorization = config.token_factorization
        self.entropy_chunk = entropy_chunk

    def __call__(self, z: torch.Tensor, training: bool = True,
                 compute_codebook_entropy: bool = True) -> LFQResult:
        """z: (..., D) latents before quantization, channel-last."""
        hard = torch.where(z > 0, 1.0, -1.0).to(z.dtype)
        quantized = z + (hard - z).detach()
        indices = bits_to_indices(z > 0)
        zero = torch.zeros((), dtype=torch.float32, device=z.device)
        if not training:
            return LFQResult(quantized, indices, zero, zero, zero, zero)
        zf = z.float()
        sample_entropy = bernoulli_entropy_sum(zf, self.temperature).mean()
        codebook_entropy = (codebook_entropy_chunked(
            zf.reshape(-1, self.num_bits), self.temperature, self.num_bits,
            self.entropy_chunk) if compute_codebook_entropy else zero)
        commit_loss = ((zf - hard.float().detach()) ** 2).mean()
        return LFQResult(quantized, indices,
                         sample_entropy - codebook_entropy, commit_loss,
                         sample_entropy, codebook_entropy)

    def factorized_indices(self, indices: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Split ids into their low and high num_bits // 2 bit halves."""
        k = self.num_bits // 2
        return indices % (1 << k), indices // (1 << k)
