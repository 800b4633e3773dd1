"""Process-group bring-up and device meshes over `torch.distributed`.

The port of `aloha_tpu/parallel/multihost.py`.  Every process calls
`initialize()`, which reads the environment `torchrun` sets (RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and
starts the default process group: NCCL for CUDA devices, gloo for the CPU
and for CUDA ranks that share a card (more ranks on a host than cards:
NCCL refuses two ranks on one device).  A single process needs no group,
and `initialize()` then does nothing.  `local_device` is the rank's
device: `cuda:(LOCAL_RANK mod cards)` or the CPU.  `pod_mesh` lays the
world out as a (dp, coeff) device mesh: batch-parallel groups across hosts,
the coefficient axis inside each host.
"""

from __future__ import annotations

import datetime
import os
from typing import Sequence

import torch
import torch.distributed as dist

#: Rendezvous and collective timeout: a rank that never arrives fails the
#: job instead of hanging it.
TIMEOUT = datetime.timedelta(seconds=60)


def backend_for(device_type: str, ranks_per_card: int = 1) -> str:
    """The process-group backend of a device type: nccl for cuda, gloo for
    cpu and for cuda ranks that share a card (ranks_per_card > 1)."""
    if device_type == "cuda":
        return "nccl" if ranks_per_card <= 1 else "gloo"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device type {device_type!r}")


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: cuda:(LOCAL_RANK mod the cards), or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                            % torch.cuda.device_count())
    return torch.device(device_type)


def initialize(device_type: str = "cuda", timeout: datetime.timedelta = TIMEOUT) -> None:
    """Start the default process group from torchrun's environment when
    WORLD_SIZE > 1; with a single process (or none set) do nothing.  A CUDA
    rank selects and initialises its `local_device` first (a device mesh
    leaves an initialised device as it is)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return
    ranks_per_card = 1
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        ranks_per_card = -(-int(os.environ.get("LOCAL_WORLD_SIZE", str(world))) // cards)
        torch.cuda.set_device(local_device("cuda"))
        torch.cuda.init()
    backend = backend_for(device_type, ranks_per_card)
    dist.init_process_group(
        backend, rank=int(os.environ["RANK"]), world_size=world, timeout=timeout
    )


def pod_mesh(axis_names: Sequence[str] = ("dp", "coeff"), dp: int = 0,
             device_type: str = "cuda"):
    """A (dp, world/dp) device mesh over every process of the job.

    dp = 0 takes one dp group per host (LOCAL_WORLD_SIZE processes per
    host), so the coefficient axis stays inside a host and only the
    batch-parallel axis crosses hosts."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp <= 0:
        dp = max(1, world // int(os.environ.get("LOCAL_WORLD_SIZE", str(world))))
    if world % dp:
        raise ValueError(f"{world} processes not divisible by dp={dp}")
    return init_device_mesh(device_type, (dp, world // dp), mesh_dim_names=tuple(axis_names))
