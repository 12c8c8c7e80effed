"""Device meshes for render farms and training (counterpart:
``srack_tpu/parallel/mesh.py``).

A :class:`Mesh` is a grid of slots, each a ``torch.device`` owned by one
rank.  Voices are data-parallel, so the one layout is the voice axis split
into contiguous blocks over every slot in flat (row-major) order, the
flattening of JAX's ``P(("dp", "vp"))``.  Several slots may name one
device (a mesh of four slots on one card, or eight ``cpu`` slots for the
CPU tests).  ``torch.distributed.device_mesh.DeviceMesh`` takes one rank
per device, so it cannot hold a single process's many slots.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..compiler import tree_leaves, tree_map
from . import distributed


class Mesh:
    """``devices``: an object array of ``torch.device`` in the mesh's shape;
    ``axis_names``: one name per axis; ``ranks``: an int array of the same
    shape naming the rank that owns each slot, or None for a mesh of this
    process alone (no collective).  Devices may be given as strings."""

    def __init__(self, devices, axis_names: Sequence[str],
                 ranks: Optional[np.ndarray] = None):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.array([torch.device(d) for d in arr.flat],
                                dtype=object).reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{self.devices.ndim}-D devices, axis names "
                             f"{self.axis_names}")
        self.ranks = (None if ranks is None
                      else np.asarray(ranks, dtype=int).reshape(arr.shape))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def local_slots(self) -> list:
        """Flat indices of the slots this process owns."""
        if self.ranks is None:
            return list(range(self.size))
        me = distributed.this_rank()
        return [i for i, r in enumerate(self.ranks.flat) if r == me]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp", "vp"),
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the global slot list: after
    :func:`~.distributed.init_distributed` every rank's slots, owned by
    that rank; without it every visible card of this process (``devices``
    names the slots instead, e.g. ``["cuda:0"] * 4`` or ``["cpu"] * 8``).

    With two axis names the count is factored as evenly as possible (8 ->
    4 x 2): ``dp`` for independent patches, ``vp`` for the voices of an
    ensemble."""
    ranks = None
    if devices is None:
        slots = distributed.global_slots()
        if slots is None:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        else:
            ranks = [r for r, _ in slots]
            devices = [d for _, d in slots]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
        ranks = None if ranks is None else ranks[:n_devices]
    n = len(devices)
    if n == 0:
        raise RuntimeError("no device for the mesh: no CUDA card is "
                           "visible; pass devices=[...] (e.g. cpu slots)")
    if len(axis_names) == 1:
        shape = (n,)
    else:
        a = next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)
        shape = (n // a, a)
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid.reshape(shape), axis_names[:len(shape)],
                None if ranks is None else np.asarray(ranks).reshape(shape))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a leading batch axis lies on a mesh: split over ``axes`` (every
    mesh axis, flattened) or, with ``axes=()``, whole on every slot."""
    mesh: Mesh
    axes: tuple


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard a leading batch axis over every mesh axis (flattened)."""
    return Sharding(mesh, mesh.axis_names)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


@dataclasses.dataclass
class Shard:
    """One slot's block of a batch: voices ``start:stop`` of the whole
    batch, ``data`` the tree of those rows on ``device``."""
    slot: int
    device: torch.device
    start: int
    stop: int
    data: object


def shard_bounds(v: int, mesh: Mesh) -> list:
    """``[(start, stop)]`` of each slot's contiguous voice block, in flat
    slot order; raises unless the slot count divides ``v``."""
    if v % mesh.size:
        raise ValueError(f"{v} voices do not split evenly over a mesh of "
                         f"{mesh.size} slots")
    per = v // mesh.size
    return [(i * per, (i + 1) * per) for i in range(mesh.size)]


def shard_batch(tree, mesh: Mesh) -> list:
    """This process's shards of a tree whose leaves share a leading batch
    axis: a :class:`Shard` per slot it owns, in slot order, its rows on the
    slot's device, contiguous.  Every process holds the whole tree and
    keeps its own rows."""
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("shard_batch needs at least one leaf")
    bounds = shard_bounds(leaves[0].shape[0], mesh)
    out = []
    for i in mesh.local_slots():
        start, stop = bounds[i]
        dev = mesh.devices.flat[i]
        out.append(Shard(i, dev, start, stop, tree_map(
            lambda a: torch.as_tensor(a)[start:stop].to(dev).contiguous(),
            tree)))
    return out
