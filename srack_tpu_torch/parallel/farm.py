"""Batch render farm: many voices over a mesh of slots (counterpart:
``srack_tpu/parallel/farm.py``).

Independent randomized voices of one topology, rendered in parallel for
dataset generation.  Each slot renders its block of voices through the
port's batched path on its device (the fused kernel or the block engine on
a card), so the hot path has no traffic between slots; audio is summed
(the mix bus) only at collection.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..compiler import compile_patch
from ..patch import ModuleHandle, Patch
from . import distributed
from .mesh import make_mesh, shard_batch


class FarmResult(tuple):
    """``(audio, probes, state)`` of a farm render, with ``voices``: the
    range of voices of the whole batch that they hold (all of them in a
    single process; this rank's own across processes)."""

    def __new__(cls, audio, probes, state, voices: range):
        self = super().__new__(cls, (audio, probes, state))
        self.voices = voices
        return self


def _cat(trees: list, device):
    """The slots' trees joined along the voice axis on ``device`` (one
    slot's as it is: no copy)."""
    if isinstance(trees[0], dict):
        return {k: _cat([t[k] for t in trees], device) for k in trees[0]}
    if len(trees) == 1:
        return trees[0].to(device)
    return torch.cat([t.to(device) for t in trees])


def render_farm(patch: Patch, n_samples: int, *, params: dict, mesh=None,
                state: Optional[dict] = None, key: Optional[int] = None,
                drivers=None, mixdown: bool = False,
                probes: Sequence = ()) -> FarmResult:
    """Render a batch of voices split over ``mesh`` (``make_mesh()`` by
    default).

    ``params`` carries a leading voice axis on every leaf, split into
    contiguous blocks over the mesh's slots in flat order; ``state`` and
    per-voice ``drivers`` (``[V, n]``) the same way, a shared ``[n]`` driver
    going to every slot.  Each slot of this process renders its block with
    ``compile_patch(...).render(batched=True, device=slot)``, voice ``j``
    of the block drawing the Noise row of its index in the whole batch, so
    the audio is the local batched render's.  Every block is launched
    before any is read.

    Returns :class:`FarmResult`: the per-voice audio ``[V, C, n]``, probes
    and final state of this process's voices, on its first slot's device.
    With ``mixdown=True`` the audio is the mix bus ``[C, n]``: each block
    summed over its voices, the blocks summed in slot order and, on a mesh
    built over the process group, one ``all_reduce`` across ranks, so
    every rank gets the whole batch's sum.
    """
    if mesh is None:
        mesh = make_mesh()
    compiled = compile_patch(patch, probes=probes)
    key = 0 if key is None else int(key)
    drv = {(m.id if isinstance(m, ModuleHandle) else m): torch.as_tensor(a)
           for m, a in (drivers or {}).items()}
    shared = {k: a for k, a in drv.items() if a.dim() == 1}
    # with state=None each shard's render makes its initial state on the
    # shard's device
    tree = {"params": params, "drivers": {
        k: a for k, a in drv.items() if k not in shared}}
    if state is not None:
        tree["state"] = state
    shards = shard_batch(tree, mesh)
    if not shards:
        raise ValueError("this process owns no slot of the mesh")
    if any(a.stop != b.start for a, b in zip(shards, shards[1:])):
        raise ValueError("this process's slots hold voices that are not "
                         "contiguous in the batch")
    outs = [compiled.render(
        int(n_samples), params=sh.data["params"], state=sh.data.get("state"),
        key=key, drivers={**shared, **sh.data["drivers"]}, batched=True,
        device=sh.device, voice0=sh.start) for sh in shards]
    voices = range(shards[0].start, shards[-1].stop)
    home = shards[0].device
    probe_vals = _cat([o[1] for o in outs], home)
    final = _cat([o[2] for o in outs], home)
    if not mixdown:
        return FarmResult(_cat([o[0] for o in outs], home), probe_vals,
                          final, voices)
    mixed = None
    for audio, _, _ in outs:
        part = audio.sum(dim=0).to(home)
        mixed = part if mixed is None else mixed + part
    if mesh.ranks is not None:
        distributed.all_reduce_sum(mixed)
    return FarmResult(mixed, probe_vals, final, voices)
