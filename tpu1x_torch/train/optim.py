"""Learning-rate schedules and the optimizer of the train step.

The JAX package builds an optax chain: clip by global norm, AdamW with a
weight-decay mask (and, under muP, a second group whose learning rate is
divided by the width multiplier), optionally wrapped to accumulate
gradients. `TrainOptimizer` does the same on a model's `.grad`s:

- clip: every gradient is scaled by max_norm / max(norm, max_norm), optax's
  formula (torch's `clip_grad_norm_` adds 1e-6 to the norm);
- AdamW: `torch.optim.AdamW` carries the update; its decoupled decay
  p (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps) equals optax's
  p - lr (m_hat / (sqrt(v_hat) + eps) + wd p);
- the schedule sees the number of updates made so far, 0 at the first;
- accumulation averages k micro-batch gradients and updates on the k-th.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from tpu1x_torch.config import GenieConfig


def build_lr_schedule(name: str, learning_rate: float, num_warmup_steps: int,
                      num_training_steps: int) -> Callable[[int], float]:
    """step (updates made so far) -> learning rate. The names and shapes of
    the JAX package's schedules: constant, constant_with_warmup, linear,
    cosine (to 0) and custom_cosine (to 10% of the peak); the cosine pair
    ramps as (step + 1) / warmup, the others as step / warmup."""
    lr = learning_rate
    warmup = max(num_warmup_steps, 0)
    remaining = max(num_training_steps - warmup, 1)

    def ramp(step):
        return lr * min(max(step / warmup, 0.0), 1.0)

    if name == "constant":
        return lambda step: lr
    if name == "constant_with_warmup":
        return lambda step: ramp(step) if step < warmup else lr
    if name == "linear":
        def linear(step):
            if step < warmup:
                return ramp(step)
            return lr * (1.0 - min(max((step - warmup) / remaining, 0.0), 1.0))
        return linear
    if name in ("cosine", "custom_cosine"):
        end_ratio = 0.1 if name == "custom_cosine" else 0.0

        def cosine(step):
            if step < warmup:
                return lr * (step + 1) / max(warmup, 1)
            progress = min(max((step - warmup) / remaining, 0.0), 1.0)
            return lr * ((1 + math.cos(math.pi * progress)) / 2
                         * (1 - end_ratio) + end_ratio)
        return cosine
    raise NotImplementedError(f"lr_scheduler_type={name}")


def is_no_decay(name: str, p: torch.Tensor) -> bool:
    """No weight decay for biases, norm scales and other vectors (by the
    port's state-dict names); embeddings do decay."""
    if name.endswith("bias"):
        return True
    if "norm" in name.lower() and name.endswith("weight"):
        return True
    return p.dim() <= 1 and "embed" not in name.lower()


def is_mup_matrix(name: str, p: torch.Tensor) -> bool:
    """Hidden matrices whose fan-in grows with the width: every linear
    weight but the embeddings and the readout."""
    if "embed" in name.lower() or "out_x_proj" in name:
        return False
    return name.endswith("weight") and p.dim() >= 2


class TrainOptimizer:
    """Clip, AdamW and accumulation over `model`'s parameters: the JAX
    package's `build_optimizer`, with its arguments.

    `step()` consumes the `.grad`s of one micro-batch: it returns their
    global norm (before clipping, a 0-d tensor on the parameters' device),
    adds them to the running mean, and on every
    `gradient_accumulation_steps`-th call clips the mean, sets the learning
    rate from the schedule and updates the parameters. The gradients are
    cleared on return.
    """

    def __init__(self, model: nn.Module, config: GenieConfig,
                 learning_rate: float, weight_decay: float = 0.0,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 max_grad_norm: Optional[float] = 1.0,
                 lr_scheduler_type: str = "constant",
                 num_warmup_steps: int = 0, num_training_steps: int = 1,
                 gradient_accumulation_steps: int = 1,
                 mu_transfer: bool = False):
        self.schedule = build_lr_schedule(lr_scheduler_type, learning_rate,
                                          num_warmup_steps, num_training_steps)
        self.max_grad_norm = max_grad_norm
        self.accumulate = max(gradient_accumulation_steps, 1)
        self.updates = 0   # what the schedule sees
        self.micro = 0     # micro-batches since the last update
        matrix_scale = (1.0 / config.width_mult
                        if mu_transfer and config.width_mult != 1.0 else 1.0)
        groups = {}
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            wd = 0.0 if is_no_decay(name, p) else weight_decay
            scale = matrix_scale if is_mup_matrix(name, p) else 1.0
            groups.setdefault((wd, scale), []).append(p)
        self.params = [p for ps in groups.values() for p in ps]
        self.adamw = torch.optim.AdamW(
            [dict(params=ps, weight_decay=wd, lr_scale=scale)
             for (wd, scale), ps in groups.items()],
            lr=learning_rate, betas=(beta1, beta2), eps=eps)
        self._mean = None  # running mean of micro-batch gradients

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        self.micro += 1
        if self.accumulate > 1:
            if self._mean is None:
                self._mean = [g.clone() for g in grads]
            else:  # mean_k = mean_{k-1} + (g - mean_{k-1}) / k
                torch._foreach_sub_(grads, self._mean)
                torch._foreach_add_(self._mean, grads, alpha=1.0 / self.micro)
            grads = self._mean
        if self.micro == self.accumulate:
            if self.max_grad_norm is not None:
                norm = (grad_norm if self.accumulate == 1 else
                        torch.linalg.vector_norm(
                            torch.stack(torch._foreach_norm(grads))))
                scale = self.max_grad_norm / norm.clamp(min=self.max_grad_norm)
                torch._foreach_mul_(grads, scale)
            lr = self.schedule(self.updates)
            for group in self.adamw.param_groups:
                group["lr"] = lr * group["lr_scale"]
            for p, g in zip(self.params, grads):
                p.grad = g
            self.adamw.step()
            self.updates += 1
            self.micro = 0
            self._mean = None
        for p in self.params:
            p.grad = None
        return grad_norm

