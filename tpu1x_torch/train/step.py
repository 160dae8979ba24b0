"""The train and eval steps: corruption on the device, forward, masked
factored cross-entropy, backward, clip, AdamW.

On a CUDA device every STBlock runs its hand-written kernels forward and
backward; with `device="cpu"` the same code takes the plain versions under
ordinary autograd. Gradient checkpointing is not ported: every sub-layer
keeps its input and the kernels recompute the rest.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from tpu1x_torch.config import GenieConfig
from tpu1x_torch.data.corruption import draw_noise, maskgit_corrupt
from tpu1x_torch.models.st_maskgit import STMaskGIT
from tpu1x_torch.serving import resolve_device
from tpu1x_torch.train.optim import TrainOptimizer


@dataclass
class TrainState:
    """What a train step carries: the number of steps taken, the model and
    optimizer it updates in place, and the generator of the corruption."""
    step: int
    model: STMaskGIT
    optimizer: TrainOptimizer
    generator: torch.Generator


def _corrupt(tokens, noise, config, generator):
    if noise is None:
        noise = draw_noise(tokens.shape, config, generator, tokens.device)
    return maskgit_corrupt(tokens, noise, config)


def make_train_step(model: STMaskGIT, optimizer: TrainOptimizer,
                    config: GenieConfig, device="cuda",
                    generator: Optional[torch.Generator] = None) -> Callable:
    """Build `step(tokens_BTHW, actions_BT=None, noise=None) -> {"loss",
    "acc", "grad_norm"}` (0-d tensors on the device; nothing is read back).

    The model is moved to `device` (the card by default; raises without
    one) and updated in place. `noise` replaces the generator's draws with
    given ones (see `draw_noise`), so that two packages can corrupt alike.
    `step.state` is the `TrainState`.
    """
    dev = resolve_device(device)
    model.to(dev).train()
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    state = TrainState(0, model, optimizer, generator)

    def step(tokens_BTHW: torch.Tensor,
             actions_BT: Optional[torch.Tensor] = None,
             noise: Optional[Dict[str, torch.Tensor]] = None):
        tokens = tokens_BTHW.to(dev)
        if actions_BT is not None:
            actions_BT = actions_BT.to(dev)
        batch = _corrupt(tokens, noise, config, state.generator)
        out = model(batch["input_ids"], batch["labels"], actions_BT)
        out["loss"].backward()
        grad_norm = optimizer.step()
        state.step += 1
        return {"loss": out["loss"].detach(), "acc": out["acc"].detach(),
                "grad_norm": grad_norm}

    step.state = state
    return step


def make_eval_step(model: STMaskGIT, config: GenieConfig,
                   device="cuda") -> Callable:
    """Build `eval_step(tokens_BTHW, generator=None, noise=None) -> {"loss",
    "acc"}`: the training corruption, then a forward without gradients."""
    dev = resolve_device(device)
    model.to(dev)

    @torch.no_grad()
    def eval_step(tokens_BTHW: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Dict[str, torch.Tensor]] = None):
        batch = _corrupt(tokens_BTHW.to(dev), noise, config, generator)
        was_training = model.training
        out = model.eval()(batch["input_ids"], batch["labels"])
        model.train(was_training)
        return {"loss": out["loss"], "acc": out["acc"]}

    return eval_step
