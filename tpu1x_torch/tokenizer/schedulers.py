"""The tokenizer's learning-rate schedules and optimizer, the JAX package's
`tpu1x/tokenizer/schedulers.py` in PyTorch (the reference's
`magvit2/modules/scheduler/lr_scheduler.py` and `lfqgan.py:211-243`).

The schedules return learning-rate *multipliers* of the number of updates
already made. `build_tokenizer_optimizer` binds a list of parameters, as a
torch optimizer must, and keeps optax's semantics:

- Adam with b1 0.5, b2 0.9, eps 1e-8 and no weight decay (optax.adam);
- the learning rate of an update is `learning_rate x mult(k)`, k the
  updates already made: the first `linear-warmup` update is at 0;
- with `grad_accum_steps` k > 1, optax.MultiSteps: each call adds its
  gradients to a running mean, and only every k-th call updates the
  parameters (and advances the schedule) with that mean.

No gradient clipping and no norm: `train/optim.py:TrainOptimizer` is the
world model's (clip, AdamW, another set of schedules).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence

import torch


def linear_warmup(warmup_steps: int) -> Callable[[int], float]:
    def schedule(step):
        return min(max(step / max(warmup_steps, 1), 0.0), 1.0)
    return schedule


def linear_warmup_cosine_decay(warmup_steps: int, max_decay_steps: int,
                               multiplier_min: float = 0.0
                               ) -> Callable[[int], float]:
    def schedule(step):
        if step < warmup_steps:
            return step / max(warmup_steps, 1)
        progress = min(max((step - warmup_steps)
                           / max(max_decay_steps - warmup_steps, 1), 0.0), 1.0)
        return multiplier_min + 0.5 * (1 - multiplier_min) * (
            1 + math.cos(math.pi * progress))
    return schedule


class TokenizerOptimizer:
    """Adam over `params` with a learning-rate multiplier and MultiSteps
    accumulation. `step(grads)` takes one micro-batch's gradients (a
    sequence in the order of `params`) and updates the parameters on every
    `grad_accum_steps`-th call."""

    def __init__(self, params: Iterable[torch.Tensor], learning_rate: float,
                 mult: Optional[Callable[[int], float]] = None,
                 beta1: float = 0.5, beta2: float = 0.9,
                 grad_accum_steps: int = 1):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.mult = mult
        self.accumulate = max(grad_accum_steps, 1)
        self.updates = 0   # what the schedule sees
        self.micro = 0     # calls since the last update
        self._mean: Optional[list] = None
        self.adam = torch.optim.Adam(self.params, lr=learning_rate,
                                     betas=(beta1, beta2), eps=1e-8)

    def lr(self) -> float:
        """The learning rate of the next update."""
        if self.mult is None:
            return self.learning_rate
        return self.learning_rate * self.mult(self.updates)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        if self.accumulate > 1:
            # optax's running mean: mean += (g - mean) / (calls so far + 1)
            if self._mean is None:
                self._mean = [torch.zeros_like(g) for g in grads]
            diff = torch._foreach_sub(grads, self._mean)
            torch._foreach_add_(self._mean, diff, alpha=1.0 / (self.micro + 1))
            grads = self._mean
        self.micro += 1
        if self.micro < self.accumulate:
            return
        for group in self.adam.param_groups:
            group["lr"] = self.lr()
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adam.step()
        for p in self.params:
            p.grad = None
        self.updates += 1
        self.micro = 0
        self._mean = None


def build_tokenizer_optimizer(params: Iterable[torch.Tensor],
                              learning_rate: float,
                              beta1: float = 0.5, beta2: float = 0.9,
                              scheduler_type: str = "none",
                              warmup_steps: int = 0,
                              training_steps: int = 0,
                              min_learning_rate: float = 0.0,
                              grad_accum_steps: int = 1
                              ) -> TokenizerOptimizer:
    """scheduler_type: "none" | "linear-warmup" |
    "linear-warmup_cosine-decay" (the reference's names)."""
    if scheduler_type in ("none", "None"):
        mult = None
    elif scheduler_type == "linear-warmup":
        mult = linear_warmup(warmup_steps)
    elif scheduler_type == "linear-warmup_cosine-decay":
        mult = linear_warmup_cosine_decay(
            warmup_steps, training_steps,
            multiplier_min=min_learning_rate / learning_rate)
    else:
        raise ValueError(f"unknown scheduler_type {scheduler_type!r}")
    return TokenizerOptimizer(params, learning_rate, mult, beta1, beta2,
                              grad_accum_steps)
