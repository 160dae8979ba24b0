"""Process groups for data parallelism: the port's counterpart of the JAX
package's device mesh (tpu1x/parallel/mesh.py).

One process drives one card (or, with the gloo backend, the CPU). A rank's
share of a global batch is its contiguous slice of the batch axis, as a
batch-sharded `jax.Array` lays it out over the "data" axis; the per-host
`ShardedBatchLoader` already yields that slice. The JAX mesh's "model"
axis (tensor parallelism) is not ported (ROADMAP queue A).

The environment that starts the processes: the JAX trainer's
`TPU1X_MULTIHOST=1` with `TPU1X_COORDINATOR` (host:port),
`TPU1X_NUM_PROCESSES` and `TPU1X_PROCESS_ID`, or torchrun's `RANK`,
`WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT` (`LOCAL_RANK` picks the card).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> bool:
    """Join the process group that the arguments, or else the environment,
    describe: NCCL between cards (with gloo beside it for host tensors, which
    `torch.distributed.checkpoint.async_save` needs), gloo on the CPU.
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
        backend = "cpu:gloo,cuda:nccl"
    else:
        backend = "gloo"
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


def local_rows(n: int) -> slice:
    """This rank's contiguous share of `n` rows of a batch split over the
    ranks: the split of a batch of rollouts (and of the noise of a global
    batch). `n` must divide evenly."""
    world = process_count()
    if n % world:
        raise ValueError(f"{n} rows do not split evenly over {world} ranks")
    per = n // world
    return slice(process_index() * per, (process_index() + 1) * per)
