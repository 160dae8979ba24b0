"""Evaluation metrics of the compression challenge: running means, the
factored cross-entropy and exact-token accuracy.

`compute_loss` is the challenge CE: over the two factored vocabularies of a
token, the CE of each summed, then the mean over everything else; logits in
the reference's (B, V, F, T-1, H, W) layout. The LPIPS metric waits for the
port of the tokenizer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpu1x_torch.models.factorization import factorize_labels


class AvgMetric:
    """Running mean of values weighted by their batch sizes."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, val, batch_size: int = 1):
        self.total += float(val) * batch_size
        self.count += batch_size

    def update_list(self, flat_vals):
        self.total += float(np.sum(flat_vals))
        self.count += len(flat_vals)

    def mean(self) -> float:
        return self.total / self.count


def factored_ce(labels_BTHW, factored_logits) -> torch.Tensor:
    """Per-token challenge CE, (B, T-1, H, W): labels (B, T, H, W) with
    frame 0 (dropped here), logits (B, V, F, T-1, H, W)."""
    V, Fv = factored_logits.shape[1:3]
    targets = factorize_labels(labels_BTHW[:, 1:].long(), Fv, V)
    logp = F.log_softmax(factored_logits.float(), dim=1)
    return -logp.gather(1, targets[:, None]).sum(2)[:, 0]


def compute_loss(labels_flat, factored_logits, num_factored_vocabs: int = 2,
                 factored_vocab_size: int = 512) -> float:
    """The challenge CE.

    labels_flat: (B, T*H*W) ids, frame 0 included (dropped here);
    factored_logits: (B, V, F, T-1, H, W). Numpy arrays or tensors.
    """
    logits = torch.as_tensor(factored_logits)
    B, V, Fv, Tm1, H, W = logits.shape
    if V != factored_vocab_size or Fv != num_factored_vocabs:
        raise ValueError(f"logits of {Fv} x {V} vocabularies, expected "
                         f"{num_factored_vocabs} x {factored_vocab_size}")
    labels = torch.as_tensor(labels_flat, device=logits.device)
    if labels.shape[1] != (Tm1 + 1) * H * W:
        raise ValueError("factored_logits do not match the flattened latent "
                         "frames of the labels")
    return float(factored_ce(labels.reshape(B, Tm1 + 1, H, W), logits).mean())


def token_accuracy(ground_truth_BTHW, samples_BTHW) -> float:
    """Exact-token accuracy of the predicted frames 1.. against the ground
    truth."""
    gt = torch.as_tensor(ground_truth_BTHW)[:, 1:]
    samples = torch.as_tensor(samples_BTHW, device=gt.device)
    return float((gt == samples).float().mean())
