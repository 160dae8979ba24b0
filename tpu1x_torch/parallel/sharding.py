"""Data parallelism over the process group (tpu1x/parallel/sharding.py's
counterpart): DDP, or FSDP2 (`fully_shard`, ZeRO-3: parameters, gradients
and AdamW moments sharded over the ranks and gathered for each STBlock's
forward and backward, one unit per block and one for the rest).

The JAX package's tensor parallelism (heads and MLP columns over a "model"
axis, with weights gathered around each Pallas call) is not ported: the
card kernels take whole heads of a whole layer (ROADMAP queue A).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel


def data_parallel(model: nn.Module, device, fsdp: bool = False,
                  tp: int = 1) -> nn.Module:
    """`model` (an `STMaskGIT` on `device`) for training across the ranks of
    the default process group: sharded in place by FSDP2 and returned, or
    wrapped in DDP. Under DDP every backward all-reduces the gradients into
    buckets that the parameters' `.grad`s view."""
    if tp != 1:
        raise NotImplementedError(
            f"tensor parallelism (--tp {tp}) is not ported: the card kernels "
            f"take whole heads (ROADMAP queue A)")
    if fsdp:
        from torch.distributed.fsdp import fully_shard
        for layer in model.decoder.layers:
            fully_shard(layer)
        fully_shard(model)
        return model
    device = torch.device(device)
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        gradient_as_bucket_view=True)


def unwrap(model: nn.Module) -> nn.Module:
    """The `STMaskGIT` inside a DDP wrapper (an FSDP2 model is its own)."""
    return model.module if isinstance(model, DistributedDataParallel) \
        else model


def is_sharded(model: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule
    return isinstance(model, FSDPModule)


def is_data_parallel(model: nn.Module) -> bool:
    return isinstance(model, DistributedDataParallel) or is_sharded(model)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer, whole, on every rank: under FSDP2 each
    sharded tensor is all-gathered (a collective: every rank calls this)."""
    sd = unwrap(model).state_dict()
    return {k: v.full_tensor() if hasattr(v, "full_tensor") else v
            for k, v in sd.items()}
