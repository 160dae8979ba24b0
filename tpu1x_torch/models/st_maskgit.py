"""ST-MaskGIT world model with the reference's parameter names: the training
forward (`compute_logits`, `forward`), the masked factored cross-entropy, the
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
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpu1x_torch.config import GenieConfig
from tpu1x_torch.models.factorization import (FactorizedEmbedding,
                                              factored_embed,
                                              factorize_token_ids)
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
            mlp_bias=cfg.mlp_bias, use_mup=cfg.use_mup,
            attn_drop=cfg.attn_drop, mlp_drop=cfg.mlp_drop,
            gelu_approx=cfg.gelu_approx, dtype=getattr(torch, cfg.dtype),
            device=device)
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

    def compute_logits(self, x_BTHW: torch.Tensor,
                       actions_BT: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Token ids (B, T, H, W) -> logits (B, T, S, V, F) fp32: factored
        embedding in the compute dtype, + position (+ per-frame action)
        embedding, the decoder, the muP readout division, the fp32 head.
        The head's columns are factor-major: logits[..., v, f] is column
        f V + v."""
        cfg = self.config
        cd = getattr(torch, cfg.dtype)
        B, T, H, W = x_BTHW.shape
        te = self.token_embed
        x = factored_embed([e.weight.to(cd) for e in te.factored_embeds],
                           te.mask_token_embed[0].to(cd),
                           x_BTHW.reshape(B, T, H * W), cfg.mask_token_id)
        x = x + self.pos_embed_TSC.to(cd)
        if cfg.action_vocab_size > 0 and actions_BT is not None:
            x = x + self.action_embed.weight.to(cd)[actions_BT][:, :, None, :]
        x = self.decoder(x)
        if cfg.use_mup:
            x = x / cfg.width_mult
        logits = self.out_x_proj(x.float())
        return logits.reshape(B, T, H * W, cfg.num_factored_vocabs,
                              cfg.factored_vocab_size).transpose(-1, -2)

    def forward(self, input_ids: torch.Tensor, labels: torch.Tensor,
                actions: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """Training forward: input_ids (corrupted and masked) and labels
        (clean), both (B, T H W); optional actions (B, T). Returns loss,
        acc and logits; the loss covers the masked tokens of frames 1
        onward only."""
        cfg = self.config
        B = input_ids.shape[0]
        side = cfg.latent_side_len
        x_BTHW = input_ids.reshape(B, cfg.T, side, side)
        logits = self.compute_logits(x_BTHW, actions)
        relevant = (x_BTHW[:, 1:] == cfg.mask_token_id).reshape(
            B, cfg.T - 1, cfg.S)
        loss, acc = compute_loss_and_acc(
            logits, labels.reshape(B, cfg.T, side, side), relevant, cfg)
        return {"loss": loss, "acc": acc, "logits": logits}


def compute_loss_and_acc(logits_BTSVF: torch.Tensor,
                         targets_BTHW: torch.Tensor,
                         relevant_mask_BTS: torch.Tensor, cfg: GenieConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked factored cross-entropy and exact-token accuracy.

    logits (B, T, S, V, F) fp32 with frame 0 included (dropped here);
    targets (B, T, H, W) clean ids; relevant_mask (B, T-1, S) bool, the
    masked positions of frames 1 onward. The cross-entropy is summed over
    the factors and averaged over the masked positions; a token counts as
    correct only when every factor's argmax is."""
    B, T = targets_BTHW.shape[:2]
    logits = logits_BTSVF[:, 1:]
    targets = factorize_token_ids(
        targets_BTHW[:, 1:].reshape(B, T - 1, cfg.S),
        cfg.num_factored_vocabs, cfg.factored_vocab_size)  # (B, T-1, S, F)
    logp = F.log_softmax(logits, dim=-2)
    token_logp = logp.gather(-2, targets[:, :, :, None, :])[:, :, :, 0, :]
    loss_BTS = -token_logp.sum(-1)
    correct = (logits.argmax(-2) == targets).all(-1)
    mask = relevant_mask_BTS.float()
    num_masked = mask.sum()
    return ((loss_BTS * mask).sum() / num_masked,
            (correct.float() * mask).sum() / num_masked)


def logits_to_reference_layout(logits_BTSVF: torch.Tensor, h: int,
                               w: int) -> torch.Tensor:
    """(B, T, S, V, F) -> the reference's (B, F V, T, H, W), factor-major
    channels."""
    B, T, S, V, Fv = logits_BTSVF.shape
    x = logits_BTSVF.transpose(-1, -2).reshape(B, T, h, w, Fv * V)
    return x.movedim(-1, 1)


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

