"""Render entry points (counterpart: ``srack_tpu/engine.py``).

* :func:`render` -- offline render of a patch.
* :func:`render_batch` -- V voices of one topology in parallel, from params
  stacked along a leading voice axis; on a CUDA device this runs the fused
  kernel.
* :func:`render_long` -- arbitrarily long renders in segments with the
  state carried, assembled on the host.
* :func:`render_stream` -- a generator of ``block_size`` blocks with the
  state carried, following live edits of the patch.
* :func:`render_many` -- many patches of possibly different topologies,
  grouped by topology into batched renders, on one device or placed over
  the slots of a mesh.

Every entry point renders on the CUDA card unless it is given
``device="cpu"`` (or another device); without a card and without a device
it raises.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import torch

from .compiler import (compile_patch, migrate_state, resolve_device,
                       tree_leaves, tree_map)
from .ops.basic import fold_in
from .patch import Patch


def render(patch: Patch, n_samples: int, *, params: Optional[dict] = None,
           state: Optional[dict] = None, key: Optional[int] = None,
           drivers=None, automation: Optional[dict] = None,
           probes: Sequence = (), engine: str = "auto", device=None,
           segment: Optional[int] = None):
    """Render ``n_samples`` of a patch offline.

    Returns ``(audio, probes, final_state)``; ``audio`` is ``[channels, n]``
    float32.  ``automation``: ``{(module, "param"): [n] array}``, per-sample
    values for scalar float params.  ``segment``: render in
    ``segment``-sample pieces with the state carried (see
    :meth:`CompiledPatch.render`).
    """
    compiled = compile_patch(patch, probes=probes,
                             automation=tuple(automation or ()))
    return compiled.render(n_samples, params=params, state=state, key=key,
                           drivers=drivers, automation=automation,
                           engine=engine, device=device, segment=segment)


def render_batch(patch: Patch, n_samples: int, *, params: dict,
                 state: Optional[dict] = None, key: Optional[int] = None,
                 drivers=None, automation: Optional[dict] = None,
                 probes: Sequence = (), engine: str = "auto", device=None,
                 segment: Optional[int] = None):
    """Render a batch of voices of one topology in parallel.

    ``params`` carries a leading voice axis on every leaf (see
    :func:`stack_params` / :func:`replicate_params`).  Returns audio of
    shape ``[voices, channels, n]``.  Driver and automation lanes may be
    shared ``[n]`` (broadcast over voices) or per voice ``[V, n]``.
    """
    compiled = compile_patch(patch, probes=probes,
                             automation=tuple(automation or ()))
    return compiled.render(n_samples, params=params, state=state, key=key,
                           drivers=drivers, automation=automation,
                           batched=True, engine=engine, device=device,
                           segment=segment)


def render_long(patch: Patch, n_samples: int, *, segment: int = 48000 * 20,
                params: Optional[dict] = None, state: Optional[dict] = None,
                key: Optional[int] = None, batched: bool = False,
                automation: Optional[dict] = None, out=None,
                engine: str = "auto", device=None):
    """Render arbitrarily long audio in fixed segments with carried state.

    Loops ``render`` over ``segment``-sample pieces (the last may be
    shorter), carries the module state between them -- bit-identical to
    one long render for patches without Noise -- and assembles the audio
    into a CPU tensor (or a preallocated ``out``), so the device holds one
    segment at a time.  Segment ``i`` draws its noise from
    ``fold_in(key, i)``, as ``render(..., segment=)`` does.  Returns
    ``(audio, final_state)``.
    """
    compiled = compile_patch(patch, automation=tuple(automation or ()))
    if automation:
        for arr in automation.values():
            if torch.as_tensor(arr).shape[-1] != n_samples:
                raise ValueError(
                    "render_long automation lanes must cover the whole "
                    f"render: lane has {torch.as_tensor(arr).shape[-1]} "
                    f"samples, n_samples={n_samples}")
    device = resolve_device(device)
    key = 0 if key is None else int(key)
    done = 0
    seg_idx = 0
    while done < n_samples:
        m = min(segment, n_samples - done)
        autos_seg = ({k: torch.as_tensor(v)[..., done:done + m]
                      for k, v in automation.items()}
                     if automation else None)
        audio, _, state = compiled.render(
            m, params=params, state=state, key=fold_in(key, seg_idx),
            batched=batched, automation=autos_seg, engine=engine,
            device=device)
        seg_idx += 1
        if out is None:
            out = torch.zeros(tuple(audio.shape[:-1]) + (n_samples,),
                              dtype=audio.dtype)
        out[..., done:done + m] = audio.to(out.device)
        done += m
    return out, state


def render_stream(patch: Patch, *, params: Optional[dict] = None,
                  state: Optional[dict] = None, key: Optional[int] = None,
                  n_blocks: Optional[int] = None,
                  automation: Optional[dict] = None, probes: Sequence = (),
                  voices: Optional[int] = None, engine: str = "auto",
                  device=None) -> Iterator:
    """Yield ``(audio_block, probe_block, state)`` tuples of
    ``block_size`` samples forever (or for ``n_blocks``).

    ``automation`` lanes are consumed block by block; a stream that
    outlives its lanes holds each lane's last value.  ``voices=V`` streams
    V voices at once (audio blocks ``[V, channels, block]``), on the fused
    kernel on a CUDA device.  The stream re-reads ``patch`` every block:
    a topology edit re-plans and migrates the state (:func:`migrate_state`),
    and with the default ``params=None`` slider edits go live on the next
    block.  Block ``i`` draws its noise from ``fold_in(key, i)``.
    """
    compiled = compile_patch(patch, probes=probes,
                             automation=tuple(automation or ()))
    device = resolve_device(device)
    block = compiled.cfg.block_size
    batched = voices is not None
    pinned_params = params is not None
    if batched:
        if params is not None:
            v_have = tree_leaves(params)[0].shape[0]
            if v_have != voices:
                raise ValueError(
                    f"params carry {v_have} voices, stream asked for "
                    f"{voices}")
        else:
            params = replicate_params(compiled.default_params, voices)
    elif params is None:
        params = compiled.default_params
    if state is None:
        state = compiled.init_state(device)
        if batched:
            state = tree_map(lambda a: a.expand((voices,) + a.shape), state)
    state = tree_map(lambda a: a.to(device), state)
    key = 0 if key is None else int(key)

    def lane_block(arr, start, block):
        # ``start`` is the consumed-sample cursor, not i * block: a block
        # size change mid-stream continues the lanes where they left off
        arr = torch.as_tensor(arr)
        if start + block <= arr.shape[-1]:
            return arr[..., start:start + block]
        tail = arr[..., start:] if start < arr.shape[-1] else arr[..., -1:]
        pad = block - tail.shape[-1]
        hold = arr[..., -1:].expand(arr.shape[:-1] + (pad,))
        return torch.cat([tail, hold], dim=-1)

    i = 0
    consumed = 0
    while n_blocks is None or i < n_blocks:
        if patch.topology_key() != compiled.topology_key:
            new_compiled = compile_patch(patch, probes=probes,
                                         automation=tuple(automation or ()))
            state = migrate_state(compiled, new_compiled, state)
            compiled = new_compiled
            block = compiled.cfg.block_size
            defaults = (replicate_params(compiled.default_params, voices)
                        if batched else compiled.default_params)
            if not pinned_params:
                params = defaults
            else:
                # pinned params follow the edit: surviving modules keep
                # their values, added modules start from the defaults
                params = {mid: params.get(mid, defaults[mid])
                          for mid in defaults}
        elif not pinned_params:
            live = patch.params()
            params = replicate_params(live, voices) if batched else live
        autos_b = ({k: lane_block(v, consumed, block)
                    for k, v in automation.items()}
                   if automation else None)
        audio, probe_vals, state = compiled.render(
            block, params=params, state=state, key=fold_in(key, i),
            automation=autos_b, batched=batched, engine=engine,
            device=device)
        yield audio, probe_vals, state
        consumed += block
        i += 1


def place_groups(patches: Sequence[Patch], n_slots: Optional[int] = None):
    """Group ``patches`` by topology, in order of first appearance, and
    place the groups on ``n_slots`` slots by the longest-processing-time
    rule: groups taken by decreasing cost (voices x module count, the
    per-sample engines' dominant term), each to the least-loaded slot.
    Returns ``[(indices, slot)]``, the slot None without slots."""
    groups: dict = {}
    for i, p in enumerate(patches):
        groups.setdefault(p.topology_key(), []).append(i)
    idxs_of = list(groups.values())
    slots = [None] * len(idxs_of)
    if n_slots:
        load = [0] * n_slots
        cost = [len(idxs) * len(patches[idxs[0]]) for idxs in idxs_of]
        for g in sorted(range(len(idxs_of)), key=lambda g: -cost[g]):
            slots[g] = min(range(n_slots), key=load.__getitem__)
            load[slots[g]] += cost[g]
    return list(zip(idxs_of, slots))


def render_many(patches: Sequence[Patch], n_samples: int, *,
                key: Optional[int] = None, device=None, mesh=None) -> list:
    """Render many patches of possibly different topologies.

    Patches are grouped by topology; each group renders in one batched
    call (one patch alone renders unbatched), group ``g`` drawing its noise
    from ``fold_in(key, g)``.  Returns a list of ``[channels, n]`` tensors
    in input order.  With ``mesh`` (``parallel.Mesh``), the groups are
    placed on its slots by :func:`place_groups` and each renders on its
    slot's device; every group is launched before any result is read, so
    groups on different cards run at the same time.
    """
    results: list = [None] * len(patches)
    key = 0 if key is None else int(key)
    slots = list(mesh.devices.flat) if mesh is not None else None
    for gi, (idxs, slot) in enumerate(
            place_groups(patches, len(slots) if slots else None)):
        sub = fold_in(key, gi)
        dev = device if slot is None else slots[slot]
        if len(idxs) == 1:
            i = idxs[0]
            audio, _, _ = render(patches[i], n_samples, key=sub,
                                 params=patches[i].params(), device=dev)
            results[i] = audio
        else:
            stacked = stack_params([patches[i].params() for i in idxs])
            audio, _, _ = render_batch(patches[idxs[0]], n_samples,
                                       params=stacked, key=sub, device=dev)
            for j, i in enumerate(idxs):
                results[i] = audio[j]
    return results


def _stack(trees: Sequence):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack([torch.as_tensor(t) for t in trees])


def stack_params(param_list: Sequence[dict]) -> dict:
    """Stack per-voice param dicts (same topology) along a leading axis."""
    return _stack(list(param_list))


def replicate_params(params: dict, n: int) -> dict:
    """Broadcast one param dict to ``n`` identical voices."""
    return tree_map(lambda a: a.expand((n,) + a.shape).contiguous(), params)
