"""Data and tensor parallelism over the process group
(tpu1x/parallel/sharding.py's counterpart): the model split over the
mesh's "model" axis (`parallel/tensor.py`, heads and MLP columns), then
DDP over the "data" axis, or FSDP2 (`fully_shard`, ZeRO-3: parameters,
gradients and AdamW moments sharded over the data ranks and gathered for
each STBlock's forward and backward, one unit per block and one for the
rest). As JAX's `fsdp=True` with tp, FSDP2 shards the dimension that the
model axis leaves whole: the input dimension of the column-parallel qkv and
fc1 weights, the output dimension of the row-parallel ones.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from tpu1x_torch.parallel import mesh as mesh_lib
from tpu1x_torch.parallel import tensor as tensor_lib


def data_parallel(model: nn.Module, device, fsdp: bool = False,
                  tp: int = 1) -> nn.Module:
    """`model` (a whole `STMaskGIT` on `device`) for training across the
    ranks of the default process group on a (world / tp, tp) mesh: split
    over the model axis where tp > 1 (`tensor.split_model`), then sharded in
    place by FSDP2 over the data axis and returned, or wrapped in DDP over
    the data group. Under DDP every backward all-reduces the gradients into
    buckets that the parameters' `.grad`s view."""
    if tp != 1:
        m = mesh_lib.make_mesh(tp=tp, device=device)
        tensor_lib.split_model(model, m)
    else:
        m = mesh_lib.data_mesh()
    if fsdp:
        from torch.distributed.fsdp import fully_shard
        kw = {}
        if m.device_mesh is not None:
            kw = dict(mesh=m.device_mesh[mesh_lib.DATA_AXIS],
                      shard_placement_fn=_fsdp_dim(model))
        for layer in model.decoder.layers:
            fully_shard(layer, **kw)
        fully_shard(model, **kw)
        return model
    device = torch.device(device)
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        process_group=m.data_group, gradient_as_bucket_view=True)


def _fsdp_dim(model: nn.Module):
    """FSDP2's placement of each parameter: the input dimension of the
    column-parallel (split along dim 0) weights, else dim 0."""
    from torch.distributed.tensor import Shard
    dims = {id(p): 1 for n, p in model.named_parameters()
            if tensor_lib.split_rule(n) in ("heads", 0) and p.dim() == 2}
    return lambda p: Shard(dims.get(id(p), 0))


def unwrap(model: nn.Module) -> nn.Module:
    """The `STMaskGIT` inside a DDP wrapper (an FSDP2 model is its own)."""
    return model.module if isinstance(model, DistributedDataParallel) \
        else model


def mesh_of(model: nn.Module) -> mesh_lib.Mesh:
    """The mesh `model` trains on: its tensor-parallel mesh, else the data
    parallelism of the default group."""
    return getattr(unwrap(model), "mesh", None) or mesh_lib.data_mesh()


def is_sharded(model: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule
    return isinstance(model, FSDPModule)


def is_data_parallel(model: nn.Module) -> bool:
    return isinstance(model, DistributedDataParallel) or is_sharded(model)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer, whole, on every rank: under FSDP2 each
    sharded tensor is all-gathered over the data group, and each split one
    over the model group (collectives: every rank calls this)."""
    sd = unwrap(model).state_dict()
    sd = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
          for k, v in sd.items()}
    m = mesh_of(model)
    if m.tp == 1:
        return sd
    heads = unwrap(model).config.num_heads
    return {k: gather_split(k, v, m, heads) if tensor_lib.is_split(k) else v
            for k, v in sd.items()}


def gather_split(name: str, shard: torch.Tensor, m: mesh_lib.Mesh,
                 heads: int) -> torch.Tensor:
    """The whole of a split tensor from its shards on the model group, bit
    for bit: the shards side by side along a new leading axis, then put
    back in the tensor's own layout."""
    parts = mesh_lib.gather_rows(shard.detach()[None], slice(
        m.model_index, m.model_index + 1), m.tp, m.model_group)
    return tensor_lib.unshard_tensor(name, list(parts.unbind(0)), heads)

