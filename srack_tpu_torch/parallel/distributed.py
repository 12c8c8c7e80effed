"""Multi-process initialization (counterpart:
``srack_tpu/parallel/distributed.py``).

Synthesis is data-parallel over voices, so the multi-process story is
thin: every process calls :func:`init_distributed` once, before it renders;
``make_mesh()`` then builds a mesh over the global slot list, each rank's
slots owned by that rank.  The only collectives are the mix bus's sum and
the training step's gradient sum, one ``all_reduce`` each; per-voice state
never crosses processes.

The backend is NCCL when the process renders on the card and gloo on the
CPU.  NCCL takes one rank per card: two ranks cannot share one card in a
communicator, so one card holds a world of one.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# this process's slots and every rank's, set by init_distributed
_WORLD: dict = {}


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     local_devices: Optional[Sequence] = None) -> dict:
    """Join the process group and report the topology.

    ``coordinator_address``: ``"host:port"`` of rank 0 (``MASTER_ADDR`` and
    ``MASTER_PORT`` by default); ``num_processes`` and ``process_id``: the
    world size and this rank (``WORLD_SIZE`` and ``RANK`` by default).
    ``backend``: ``"nccl"`` when a card is visible, else ``"gloo"``.
    ``local_devices``: the slots this process adds to the global list
    (under NCCL its card ``cuda:{LOCAL_RANK}`` by default, under gloo one
    ``cpu`` slot).  Returns ``{"process_id", "process_count",
    "global_devices", "local_devices"}``.
    """
    env = os.environ
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if local_devices is None:
        if backend == "nccl":
            local_rank = int(env.get("LOCAL_RANK",
                                     rank % torch.cuda.device_count()))
            local_devices = [f"cuda:{local_rank}"]
        else:
            local_devices = ["cpu"]
    local = [torch.device(d) for d in local_devices]
    if backend == "nccl":
        torch.cuda.set_device(local[0])
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    every = [None] * world
    dist.all_gather_object(every, [str(d) for d in local])
    _WORLD.update(backend=backend, rank=rank, world=world,
                  slots=[(r, torch.device(d))
                         for r, devs in enumerate(every) for d in devs])
    return {"process_id": rank, "process_count": world,
            "global_devices": len(_WORLD["slots"]),
            "local_devices": len(local)}


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_slots() -> Optional[list]:
    """``[(rank, device)]`` of every slot in the process group, in rank
    order; None without :func:`init_distributed`."""
    if dist.is_initialized() and _WORLD:
        return list(_WORLD["slots"])
    return None


def this_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the process group in place, one ``all_reduce``:
    under NCCL on this rank's card, under gloo on the CPU."""
    home = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))
    if t.device == home:
        dist.all_reduce(t)
        return t
    moved = t.to(home)
    dist.all_reduce(moved)
    return t.copy_(moved)
