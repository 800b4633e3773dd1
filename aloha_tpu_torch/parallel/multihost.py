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

`collectives()` counts the collectives of the sharded paths at their call
sites (the port of the HLO census of tools/scaling_report.py:39-79, which
has no HLO to read here): each records its kind and the bytes of the
tensor this rank hands to it.  `staged_on_host` names the one case in
which those call sites copy through host memory: gloo has no CUDA form of
point-to-point sends or of all-to-all.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Sequence

import torch
import torch.distributed as dist

#: Rendezvous and collective timeout: a rank that never arrives fails the
#: job instead of hanging it.
TIMEOUT = datetime.timedelta(seconds=60)

#: the open `collectives()` counters, innermost last
_COUNTERS: list = []


@contextlib.contextmanager
def collectives():
    """Count the collectives this rank makes inside the block: yields a
    dict {kind: (calls, bytes)}, kind one of "exchange" (a block swapped
    with one peer, `ntt_sharded`), "all_reduce" (`keyswitch_sharded`) and
    "all_to_all" (`coeff_sharded`), bytes the size of the tensors this rank
    handed to them."""
    counts: dict = {}
    _COUNTERS.append(counts)
    try:
        yield counts
    finally:
        _COUNTERS.remove(counts)


def record(kind: str, tensor) -> None:
    """Add one collective of `kind` over `tensor` to every open counter."""
    nbytes = tensor.numel() * tensor.element_size()
    for counts in _COUNTERS:
        calls, total = counts.get(kind, (0, 0))
        counts[kind] = (calls + 1, total + nbytes)


def staged_on_host(tensor, group=None) -> bool:
    """Whether a point-to-point or all-to-all collective of `tensor` over
    `group` goes through host memory: CUDA tensors over a gloo group
    (ranks sharing a card), which gloo sends only from the CPU."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


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
