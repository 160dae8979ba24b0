"""The tokenizer's GAN and reconstruction losses, the JAX package's
`tpu1x/tokenizer/losses.py` in PyTorch (the reference's
`magvit2/modules/losses/vqperceptual.py`).

- `adopt_weight`: the discriminator's terms are zeroed before `disc_start`;
- the discriminator losses: hinge (the default), vanilla, and the
  non-saturating one on per-sample patch-mean logits, with the JAX
  package's repair of the reference (whose real term reads the fake
  logits);
- the generator's non-saturating loss;
- LeCam regularization against EMAs of the real and fake logit means
  (decay 0.999, both starting at 0);
- the adaptive generator weight ||grad nll|| / (||grad g|| + 1e-4), clipped
  to [0, 1e4], times `disc_weight`;
- L1 and L2 reconstruction losses.

Plain functions of tensors: the logits are (B, ..., 1) patch maps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


def adopt_weight(weight, global_step: int, threshold: int = 0,
                 value: float = 0.0):
    """`value` until `global_step` reaches `threshold`, then `weight`. The
    port counts steps on the host, so this needs no device round trip."""
    return value if global_step < threshold else weight


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (F.relu(1.0 - logits_real).mean()
                  + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (F.softplus(-logits_real).mean()
                  + F.softplus(logits_fake).mean())


def _patch_mean(logits):
    return logits.reshape(logits.shape[0], -1).mean(-1)


def non_saturate_discriminator_loss(logits_real, logits_fake):
    """The sigmoid cross-entropy of each sample's patch-mean logit: the real
    term on the real logits (the reference's vqperceptual.py:65 scores the
    fake logits there; the JAX package repairs it, and so does this)."""
    return (F.softplus(-_patch_mean(logits_real)).mean()
            + F.softplus(_patch_mean(logits_fake)).mean())


def non_saturate_gen_loss(logits_fake):
    """-log sigmoid of each sample's patch-mean fake logit, averaged."""
    return F.softplus(-_patch_mean(logits_fake)).mean()


class LeCamState(NamedTuple):
    """EMAs of the real and fake logit means (0-d fp32 tensors)."""
    logits_real_ema: torch.Tensor
    logits_fake_ema: torch.Tensor

    @classmethod
    def init(cls, device=None) -> "LeCamState":
        return cls(torch.zeros((), device=device),
                   torch.zeros((), device=device))


def lecam_update(state: LeCamState, logits_real, logits_fake,
                 decay: float = 0.999) -> LeCamState:
    return LeCamState(
        state.logits_real_ema * decay + logits_real.mean() * (1 - decay),
        state.logits_fake_ema * decay + logits_fake.mean() * (1 - decay))


def lecam_reg(logits_real, logits_fake, state: LeCamState):
    return (F.relu(logits_real - state.logits_fake_ema).square().mean()
            + F.relu(state.logits_real_ema - logits_fake).square().mean())


def adaptive_gen_weight(nll_grad_norm, g_grad_norm, disc_weight: float,
                        eps: float = 1e-4, clip: float = 1e4):
    return (nll_grad_norm / (g_grad_norm + eps)).clamp(0.0, clip) * disc_weight


def l1_loss(x, y):
    return (x - y).abs().mean()


def l2_loss(x, y):
    return (x - y).square().mean()


D_LOSSES = {
    "hinge": hinge_d_loss,
    "vanilla": vanilla_d_loss,
    "non_saturate": non_saturate_discriminator_loss,
}
