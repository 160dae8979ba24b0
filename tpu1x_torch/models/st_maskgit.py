"""ST-MaskGIT world model: the parameter container (reference names), the
MaskGIT mask-rate schedule and the KV-cache commit.

State-dict names beside the decoder's:
    pos_embed_TSC                          (1, T, S, C)
    token_embed.factored_embeds.{k}.weight (V, C)
    token_embed.mask_token_embed           (1, C)
    out_x_proj.{weight,bias}               (F V, C), factor-major rows
    action_embed.weight                    (A, C), only with actions
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from tpu1x_torch.config import GenieConfig
from tpu1x_torch.models.factorization import FactorizedEmbedding
from tpu1x_torch.models.st_transformer import STTransformerDecoder


def cosine_schedule(u: float) -> float:
    """Mask rate cos(u pi / 2) for u in [0, 1]."""
    return math.cos(u * math.pi / 2)


class STMaskGIT(nn.Module):
    def __init__(self, config: GenieConfig, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.decoder = STTransformerDecoder(
            cfg.num_layers, num_heads=cfg.num_heads, d_model=cfg.d_model,
            qkv_bias=cfg.qkv_bias, proj_bias=cfg.proj_bias,
            qk_norm=cfg.qk_norm, mlp_ratio=cfg.mlp_ratio,
            mlp_bias=cfg.mlp_bias, device=device)
        self.pos_embed_TSC = nn.Parameter(
            torch.zeros(1, cfg.T, cfg.S, cfg.d_model, device=device))
        self.token_embed = FactorizedEmbedding(
            cfg.factored_vocab_size, cfg.num_factored_vocabs, cfg.d_model,
            device=device)
        self.out_x_proj = nn.Linear(
            cfg.d_model, cfg.factored_vocab_size * cfg.num_factored_vocabs,
            device=device)
        if cfg.action_vocab_size > 0:
            self.action_embed = nn.Embedding(cfg.action_vocab_size,
                                             cfg.d_model, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "STMaskGIT":
        """The JAX package's initialisation, drawn from `generator`: normal
        std 0.02 for linear and embedding weights; zeros for biases, the
        position embedding and the mask embedding; LayerNorms at identity."""
        for name, p in self.named_parameters():
            if name.endswith("weight") and p.dim() == 2:
                p.normal_(0.0, 0.02, generator=generator)
            elif ".norm" in name and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
        return self


def update_cache(cache: Dict[str, torch.Tensor],
                 kv_cur: Tuple[torch.Tensor, torch.Tensor],
                 t: int) -> Dict[str, torch.Tensor]:
    """Commit a frame's k/v, each (1, L, B, S, C), into slot `t` of the
    T-major (T, L, B, S, C) cache. Writes IN PLACE (the JAX version returns
    an updated copy) and returns the same dict."""
    k_cur, v_cur = kv_cur
    cache["k"][t].copy_(k_cur[0])
    cache["v"][t].copy_(v_cur[0])
    return cache

