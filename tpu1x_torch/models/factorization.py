"""Factored-vocabulary token ids and the factored embedding.

The 2**18 tokenizer vocabulary is split into `num_factored_vocabs` digits of
base `factored_vocab_size`: id = sum_f digit_f * V**f, least significant
digit first. The embedding of a token is the sum of its digits' embeddings,
and a learned mask embedding replaces it wherever the id is the mask id.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def factorize_token_ids(token_ids: torch.Tensor, num_factored_vocabs: int = 2,
                        factored_vocab_size: int = 512) -> torch.Tensor:
    """(...) integer ids -> (..., num_factored_vocabs) digits, least
    significant first."""
    powers = factored_vocab_size ** torch.arange(
        num_factored_vocabs, dtype=token_ids.dtype, device=token_ids.device)
    return (token_ids[..., None] // powers) % factored_vocab_size


def factored_embed(tables, mask_embed: torch.Tensor, token_ids: torch.Tensor,
                   mask_token_id: int) -> torch.Tensor:
    """Sum of the per-digit embeddings, with `mask_embed` (C,) where the id
    is the mask id. The sum runs in the tables' dtype, one digit at a time,
    as the JAX package does. `F.embedding` and not `table[digits]`: the
    values are the same, but the backward of plain indexing sorts all
    B T S indices into V rows and took a tenth of a GENIE_138M train step
    on the H100."""
    is_mask = token_ids == mask_token_id
    safe = torch.where(is_mask, torch.zeros_like(token_ids), token_ids)
    digits = factorize_token_ids(safe, len(tables), tables[0].shape[0])
    x = None
    for k, table in enumerate(tables):
        e = F.embedding(digits[..., k], table)
        x = e if x is None else x + e
    return torch.where(is_mask[..., None], mask_embed.to(x.dtype), x)


class FactorizedEmbedding(nn.Module):
    """Parameter container with the reference's names:
    `factored_embeds.{k}.weight` (V, C) and `mask_token_embed` (1, C);
    `factored_embed` computes with them."""

    def __init__(self, factored_vocab_size: int, num_factored_vocabs: int,
                 d_model: int, device=None):
        super().__init__()
        self.factored_embeds = nn.ModuleList(
            nn.Embedding(factored_vocab_size, d_model, device=device)
            for _ in range(num_factored_vocabs))
        self.mask_token_embed = nn.Parameter(
            torch.zeros(1, d_model, device=device))
