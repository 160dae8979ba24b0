"""MaskGIT training corruption on the tokens' device.

`maskgit_corrupt` is a pure function of the clean tokens and ten random
draws, the JAX package's `tpu1x.data.corruption.maskgit_corrupt` with its
`jax.random` calls taken out, so that both packages give identical
`input_ids` from the same draws. `draw_noise` makes the draws from a
`torch.Generator`. Nothing here reads a value back to the host.

1. Every factored digit is replaced by a random digit at rate
   U(0, max_corrupt_rate).
2. With probability `non_mlm_ratio`, frames before a first masked frame
   drawn from {num_prompt_frames..T-1} stay clean and later frames are
   corrupted at a compounding rate: the correct rate starts at U(0.25, 1)
   and is multiplied by U(0.9, 1) per further frame. Otherwise masking
   starts at frame 1.
3. Each (example, frame) masks its tokens with probability
   cos(U(0, 1) pi / 2); masked positions become `mask_token_id`.
If a draw masks nothing, the one position closest to its masking threshold
is masked, so the loss always has a token to average over (the reference
redraws instead).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from tpu1x_torch.config import GenieConfig
from tpu1x_torch.models.factorization import factorize_token_ids

NOISE_KEYS = ("u_rate", "r_corrupt", "random_values", "u_non_mlm",
              "first_masked_frame", "c0", "m", "r_non_mlm", "u_mask",
              "r_mask")


def draw_noise(shape, config: GenieConfig, generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """The ten draws of one corruption of a (B, T, H, W) batch, in the order
    the JAX package splits its key."""
    B, T, H, W = shape
    F, V = config.num_factored_vocabs, config.factored_vocab_size

    def u(*s):
        return torch.rand(*s, generator=generator, device=device)

    def ints(lo, hi, *s):
        return torch.randint(lo, hi, s, generator=generator, device=device)

    return {
        "u_rate": u(()),
        "r_corrupt": u(B, T, H, W, F),
        "random_values": ints(0, V, B, T, H, W, F),
        "u_non_mlm": u(()),
        "first_masked_frame": ints(config.num_prompt_frames, T),
        "c0": 0.25 + 0.75 * u(()),
        "m": 0.9 + 0.1 * u(T),
        "r_non_mlm": u(B, T, H, W, F),
        "u_mask": u(B, T),
        "r_mask": u(B, T, H, W),
    }


def maskgit_corrupt(tokens_BTHW: torch.Tensor, noise: Dict[str, torch.Tensor],
                    config: GenieConfig) -> Dict[str, torch.Tensor]:
    """Clean tokens (B, T, H, W) and the draws of `draw_noise` ->
    {"input_ids", "labels"}, both (B, T H W) int64."""
    B, T, H, W = tokens_BTHW.shape
    F, V = config.num_factored_vocabs, config.factored_vocab_size
    dev = tokens_BTHW.device
    tokens = tokens_BTHW.long()
    n = {k: torch.as_tensor(v, device=dev) for k, v in noise.items()}
    random_values = n["random_values"].long()

    x = factorize_token_ids(tokens, F, V)
    x = torch.where(n["r_corrupt"] < config.max_corrupt_rate * n["u_rate"],
                    random_values, x)

    is_non_mlm = n["u_non_mlm"] < config.non_mlm_ratio
    first_masked = torch.where(is_non_mlm, n["first_masked_frame"].long(), 1)
    frame = torch.arange(T, device=dev)
    after = frame >= first_masked  # (T,)
    offset = (frame - first_masked).clamp(0, T - 1)
    correct_rate = n["c0"] * torch.cumprod(n["m"], 0)[offset]  # (T,)
    corrupt = ((n["r_non_mlm"] > correct_rate[None, :, None, None, None])
               & after[None, :, None, None, None] & is_non_mlm)
    x = torch.where(corrupt, random_values, x)

    mask_prob = torch.cos(n["u_mask"] * (math.pi / 2))[:, :, None, None]
    valid = after[None, :, None, None]
    mask = (n["r_mask"] < mask_prob) & valid
    margin = torch.where(valid, mask_prob - n["r_mask"],
                         torch.full_like(n["r_mask"], -math.inf))
    fallback = torch.zeros(B * T * H * W, dtype=torch.bool, device=dev)
    fallback[margin.reshape(-1).argmax()] = True
    mask = torch.where(mask.any(), mask, fallback.reshape(B, T, H, W))

    powers = V ** torch.arange(F, device=dev)
    ids = (x * powers).sum(-1)
    ids = torch.where(mask, config.mask_token_id, ids)
    return {"input_ids": ids.reshape(B, T * H * W),
            "labels": tokens.reshape(B, T * H * W)}
