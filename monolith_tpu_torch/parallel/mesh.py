"""The ranks of a torch.distributed group, as the sharded trainer's mesh.

The JAX package's mesh is one process driving N devices along one axis
"d": embedding tables row-sharded over "d", the dense tower data-parallel
over the same axis. torch has no such mode, so the port runs one process a
rank, each on its own device: NCCL on the cards, gloo on the CPU (the
tests). The caller initialises the process group
(`torch.distributed.init_process_group`, with its address, world size and
rank); `make_mesh` joins it. One card runs a world of 1 with an in-process
store:

    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.HashStore())
    mesh = make_mesh()
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from monolith_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh: its index (= its table shard and its
    slice of every batch), the number of ranks, the process group the
    collectives run on, and the rank's device."""
    rank: int
    size: int
    group: object
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def make_mesh(num_devices: Optional[int] = None, device=None) -> Mesh:
    """This process's rank of the initialised default group. Raises when
    more ranks are asked for than exist (and, unlike the JAX package's
    mesh over the first devices, when fewer are: every rank of the group
    is a rank of the mesh).

    The device comes from the backend: `cuda:<local rank>` (LOCAL_RANK, or
    the rank, modulo the cards) unless the caller passes a device;
    `device="cpu"` only gloo can serve."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"need {num_devices} devices, have {world}")
    group = dist.group.WORLD
    backend = dist.get_backend(group)
    if device is not None and torch.device(device).type == "cpu":
        if backend != "gloo":
            raise ValueError(f"a {backend} group runs on the cards; only "
                             f"gloo runs on the CPU")
        return Mesh(rank, world, group, torch.device("cpu"))
    if device is None:
        resolve_device(None)    # raises where CUDA is missing
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = f"cuda:{local % torch.cuda.device_count()}"
    return Mesh(rank, world, group, resolve_device(device))
