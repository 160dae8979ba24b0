"""The train and eval steps: corruption on the device, forward, masked
factored cross-entropy, backward, clip, AdamW.

On a CUDA device every STBlock runs its hand-written kernels forward and
backward; with `device="cpu"` the same code takes the plain versions under
ordinary autograd. Remat follows the config (models/st_transformer.py).

Under data parallelism (`shard_train_state`: DDP or FSDP2 over the data
axis of the mesh, with the model split over its model axis where tp > 1)
each data rank takes its slice of the global batch, the ranks of a model
group the same slice, and the step gives what one process gives on the
global batch, as the JAX package's one SPMD program does: the corruption
draws are the global batch's, each data rank taking its rows
(`data_rows`); loss and accuracy are divided by the masked tokens of the
global batch (one all-reduce of the count over the data group per
micro-batch), and the rank's loss is scaled by the data ranks for the
backward, since DDP and FSDP2 average the data ranks' gradients; the
reported loss and accuracy are summed over the data ranks. Every backward
reduces the gradients (no `no_sync` under accumulation), so the reported
gradient norm is the global micro-batch gradient's, as in the JAX package.
Each data rank draws its dropout masks from a generator of its own, seeded
from the corruption generator's seed and the data rank, so data ranks drop
different values and the ranks of a model group the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from tpu1x_torch.config import GenieConfig
from tpu1x_torch.data.corruption import draw_noise, maskgit_corrupt
from tpu1x_torch.models.st_maskgit import STMaskGIT, relevant_mask
from tpu1x_torch.parallel import mesh, sharding
from tpu1x_torch.serving import resolve_device
from tpu1x_torch.train.optim import TrainOptimizer

# the draws with a batch axis; a rank takes its rows of each
PER_EXAMPLE_NOISE = ("r_corrupt", "random_values", "r_non_mlm", "u_mask",
                     "r_mask")


@dataclass
class TrainState:
    """What a train step carries: the number of steps taken, the model and
    optimizer it updates in place, the generator of the corruption (the
    same on every rank), and the generator of this rank's dropout masks
    (None: the corruption's, as in one process)."""
    step: int
    model: STMaskGIT
    optimizer: TrainOptimizer
    generator: torch.Generator
    dropout_generator: Optional[torch.Generator] = None


def _corrupt(tokens, noise, config, generator, m):
    """Corrupt this rank's rows with its data rank's rows of the global
    batch's draws (`noise` given, or drawn from `generator`)."""
    if noise is None:
        shape = (tokens.shape[0] * m.dp, *tokens.shape[1:])
        noise = draw_noise(shape, config, generator, tokens.device)
    if m.dp > 1:
        rows = mesh.data_rows(noise["u_mask"].shape[0], m)
        noise = {k: v[rows] if k in PER_EXAMPLE_NOISE else v
                 for k, v in noise.items()}
    return maskgit_corrupt(tokens, noise, config)


def _global_count(batch, config, m):
    """The masked tokens of the global batch (None with one data rank,
    where the model counts its own)."""
    if m.dp == 1:
        return None
    count = relevant_mask(batch["input_ids"], config).sum().float()
    dist.all_reduce(count, group=m.data_group)
    return count


def _summed(metrics, m):
    if m.dp > 1:
        for v in metrics.values():
            dist.all_reduce(v, group=m.data_group)
    return metrics


def shard_train_state(state: TrainState, device, fsdp: bool = False,
                      tp: int = 1) -> TrainState:
    """`state` for training across the process group: the model split over
    a model axis of `tp` ranks where tp > 1, then wrapped in DDP or sharded
    by FSDP2 over the data axis (`sharding.data_parallel`), and an optimizer
    with the same arguments over the wrapped parameters (the split and
    FSDP2 replace the parameters with their shards). Call before any
    update, with the model whole on every rank."""
    model = sharding.data_parallel(state.model, device, fsdp=fsdp, tp=tp)
    return TrainState(state.step, model, state.optimizer.rebuild(model),
                      state.generator)


def make_train_step(model: STMaskGIT, optimizer: TrainOptimizer,
                    config: GenieConfig, device="cuda",
                    generator: Optional[torch.Generator] = None) -> Callable:
    """Build `step(tokens_BTHW, actions_BT=None, noise=None) -> {"loss",
    "acc", "grad_norm"}` (0-d tensors on the device; nothing is read back).

    The model is moved to `device` (the card by default; raises without
    one) and updated in place; it may be the DDP or FSDP2 model of
    `shard_train_state`, with `optimizer` over its parameters, and
    `tokens_BTHW` this rank's rows. `noise` replaces the generator's draws
    with given ones for the global batch (see `draw_noise`), so that two
    packages can corrupt alike. In one process the generator also draws the
    dropout masks. `step.state` is the `TrainState`.
    """
    dev = resolve_device(device)
    model.to(dev).train()
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    state = TrainState(0, model, optimizer, generator)
    world = mesh.process_count()
    m = sharding.mesh_of(model)
    if world > 1:
        if not sharding.is_data_parallel(model):
            raise ValueError(f"{world} processes train one model only "
                             f"through shard_train_state (DDP or FSDP2)")
        state.dropout_generator = torch.Generator(device=dev).manual_seed(
            generator.initial_seed() + 1 + m.data_index)

    def step(tokens_BTHW: torch.Tensor,
             actions_BT: Optional[torch.Tensor] = None,
             noise: Optional[Dict[str, torch.Tensor]] = None):
        tokens = tokens_BTHW.to(dev)
        if actions_BT is not None:
            actions_BT = actions_BT.to(dev)
        batch = _corrupt(tokens, noise, config, state.generator, m)
        out = state.model(batch["input_ids"], batch["labels"], actions_BT,
                          generator=state.dropout_generator or state.generator,
                          num_masked=_global_count(batch, config, m))
        (out["loss"] * m.dp if m.dp > 1 else out["loss"]).backward()
        grad_norm = state.optimizer.step()
        state.step += 1
        return {**_summed({"loss": out["loss"].detach(),
                           "acc": out["acc"].detach()}, m),
                "grad_norm": grad_norm}

    step.state = state
    return step


def make_eval_step(model: STMaskGIT, config: GenieConfig,
                   device="cuda") -> Callable:
    """Build `eval_step(tokens_BTHW, generator=None, noise=None) -> {"loss",
    "acc"}`: the training corruption, then a forward without gradients;
    over the global batch under data parallelism, as `make_train_step`."""
    dev = resolve_device(device)
    model.to(dev)
    m = sharding.mesh_of(model)

    @torch.no_grad()
    def eval_step(tokens_BTHW: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Dict[str, torch.Tensor]] = None):
        batch = _corrupt(tokens_BTHW.to(dev), noise, config, generator, m)
        was_training = model.training
        out = model.eval()(batch["input_ids"], batch["labels"],
                           num_masked=_global_count(batch, config, m))
        model.train(was_training)
        return _summed({"loss": out["loss"], "acc": out["acc"]}, m)

    return eval_step
