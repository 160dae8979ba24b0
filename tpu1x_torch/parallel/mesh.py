"""Process groups and the ("data", "model") mesh: the port's counterpart of
the JAX package's device mesh (tpu1x/parallel/mesh.py).

One process drives one card (or, with the gloo backend, the CPU).
`make_mesh(dp, tp)` lays the ranks out data-major, as JAX's
`reshape(dp, tp)` does: a model group is `tp` consecutive ranks, which
split each layer's heads and MLP columns between them
(`parallel/tensor.py`); a data group is the ranks that hold the same share
of the weights. The rows of a training batch go by data rank, and the ranks
of a model group read the same rows (`data_rows`); the rows of a rollout
batch go over every rank (`local_rows`, JAX's `rollout_sharding`). The
model axis's collectives are here (`model_all_reduce`, `model_broadcast`,
`gather_rows`).

The environment that starts the processes: the JAX trainer's
`TPU1X_MULTIHOST=1` with `TPU1X_COORDINATOR` (host:port),
`TPU1X_NUM_PROCESSES` and `TPU1X_PROCESS_ID`, or torchrun's `RANK`,
`WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT` (`LOCAL_RANK` picks the card).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Join the process group that the arguments, or else the environment,
    describe: NCCL between cards (with gloo beside it for host tensors, which
    `torch.distributed.checkpoint.async_save` needs), gloo on the CPU.
    `backend` names another backend explicitly, such as "gloo" for ranks
    that share one card (NCCL refuses two ranks on one device).
    Returns whether a group was created here; False when one exists already
    or the environment describes a single process."""
    if dist.is_initialized():
        return False
    env = os.environ
    if init_method is None:
        coord = env.get("TPU1X_COORDINATOR")
        if int(env.get("TPU1X_MULTIHOST", "0")) and coord:
            init_method = f"tcp://{coord}"
            world_size = int(env["TPU1X_NUM_PROCESSES"])
            rank = int(env["TPU1X_PROCESS_ID"])
        elif int(env.get("WORLD_SIZE", "1")) > 1 or (
                int(env.get("TPU1X_MULTIHOST", "0")) and "RANK" in env):
            init_method = "env://"
            world_size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        else:
            return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_device(device, rank))
        backend = backend or "cpu:gloo,cuda:nccl"
    else:
        backend = backend or "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """This process's device: for CUDA the card `LOCAL_RANK` names, else the
    rank's modulo the cards of the host; the CPU as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if "LOCAL_RANK" in os.environ:
        index = int(os.environ["LOCAL_RANK"])
    else:
        rank = process_index() if rank is None else rank
        index = rank % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", index)


def put_global_batch(local_batch, device) -> torch.Tensor:
    """This rank's slice of a global batch (numpy or a tensor, as the
    loader yields it) onto this rank's device, as int64."""
    return torch.as_tensor(local_batch).to(device).long()


def _share(n: int, index: int, count: int, what: str) -> slice:
    if n % count:
        raise ValueError(f"{n} rows do not split evenly over {count} {what}")
    per = n // count
    return slice(index * per, (index + 1) * per)


def local_rows(n: int) -> slice:
    """This rank's contiguous share of `n` rows of a batch split over every
    rank, data x model in rank order: the split of a batch of rollouts or
    of scored policies (JAX's `rollout_sharding`). `n` must divide
    evenly."""
    return _share(n, process_index(), process_count(), "ranks")


@dataclass
class Mesh:
    """The ("data", "model") layout of the process group: `dp` x `tp`
    ranks, rank r at (r // tp, r % tp). The groups are None in one
    process; `device_mesh` is the 2-D `DeviceMesh` FSDP2 shards over."""
    dp: int
    tp: int
    data_index: int
    model_index: int
    data_group: Any = None
    model_group: Any = None
    device_mesh: Any = None

    @property
    def shape(self):
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}


def data_mesh() -> Mesh:
    """The mesh of data parallelism alone: every rank its own data index,
    the default group as the data group."""
    return Mesh(process_count(), 1, process_index(), 0,
                data_group=dist.group.WORLD if dist.is_initialized()
                else None)


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              device="cuda") -> Mesh:
    """The ("data", "model") mesh over the ranks of the default group (the
    counterpart of tpu1x/parallel/mesh.py:make_mesh): `dp` defaults to the
    ranks over `tp`, and dp x tp must be the world size. Every rank calls
    it (it creates the axis groups)."""
    world = process_count()
    if tp < 1 or world % tp:
        raise ValueError(f"tensor parallelism {tp} must divide the "
                         f"{world} processes")
    dp = world // tp if dp is None else dp
    if dp * tp != world:
        raise ValueError(f"mesh {dp} x {tp} != {world} processes")
    data_index, model_index = divmod(process_index(), tp)
    if world == 1:
        return Mesh(1, 1, 0, 0)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(torch.device(device).type, (dp, tp),
                          mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(dp, tp, data_index, model_index,
                data_group=dm.get_group(DATA_AXIS),
                model_group=dm.get_group(MODEL_AXIS), device_mesh=dm)


def data_rows(n: int, m: Mesh) -> slice:
    """This rank's share of `n` rows of a training batch: its data rank's
    contiguous slice, the same on every rank of a model group."""
    return _share(n, m.data_index, m.dp, "data ranks")


def model_all_reduce(t: torch.Tensor, m: Mesh) -> torch.Tensor:
    """Sum `t` over the model group in place (a no-op at tp = 1)."""
    if m.tp > 1:
        dist.all_reduce(t, group=m.model_group)
    return t


def model_broadcast(t: torch.Tensor, m: Mesh) -> torch.Tensor:
    """Overwrite `t` in place with the model group's first rank's (a no-op
    at tp = 1)."""
    if m.tp > 1:
        dist.broadcast(t, src=dist.get_global_rank(m.model_group, 0),
                       group=m.model_group)
    return t


def gather_rows(part: torch.Tensor, rows: slice, n: int,
                group=None) -> torch.Tensor:
    """The whole (n, ...) tensor whose rows `rows` this rank holds as
    `part`, the other rows from the other ranks of `group`, bit for bit:
    an all-reduce of a zeroed buffer into which each rank writes its rows,
    summed as integers of the rows' bytes (so that -0.0 and NaN travel as
    they are). gloo and NCCL both reduce CUDA tensors this way."""
    out = torch.zeros((n, *part.shape[1:]), dtype=part.dtype,
                      device=part.device)
    out[rows] = part
    raw = out.view(-1).view(torch.uint8)
    pad = -raw.numel() % 4
    words = torch.cat([raw, raw.new_zeros(pad)]) if pad else raw
    dist.all_reduce(words.view(torch.int32), group=group)
    return words[:raw.numel()].view(part.dtype).view(out.shape)
