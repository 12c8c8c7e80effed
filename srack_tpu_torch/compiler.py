"""Patch compiler (counterpart: ``srack_tpu/compiler.py``).

Lowering puts the module chain inside one per-sample step: ``_sample_step``
walks the whole plan once per sample, and an engine runs that step over
the render.

* ``"scan"``: a Python loop over samples around ``_sample_step`` on
  whatever device the tensors are on.  It is the port's reference path and
  the plain version of the fused kernel.
* ``"fused"``: the hand-written CUDA kernel generated from the plan
  (``ops/fused.py``); batched renders of CUDA tensors only.

Feedback: the planner deletes back-edges, and an input whose source is
planned at or after its sink reads the carried value ``fb`` (the previous
sample of that wire) instead of this sample's value.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import torch

from .config import AudioConfig
from .modules.base import CV_DTYPE
from .patch import Patch
from .planner import plan_execution

_SLICE2 = "is not ported yet: slice 2 of the port (ROADMAP.md)"


class _LRU(OrderedDict):
    """Bounded insertion/access-ordered cache."""

    def __init__(self, cap: int):
        super().__init__()
        self.cap = cap

    def get(self, key, default=None):
        v = super().get(key, default)
        if key in self:
            self.move_to_end(key)
        return v

    def put(self, key, value) -> None:
        self[key] = value
        self.move_to_end(key)
        while len(self) > self.cap:
            self.popitem(last=False)


COMPILE_CACHE_CAP = 64


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a tree of dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


class CompiledPatch:
    """An executable patch: the plan and the static structure it needs."""

    def __init__(self, patch: Patch):
        if patch.config.buffer_feedback:
            raise NotImplementedError(f"buffer feedback {_SLICE2}")
        self.cfg: AudioConfig = patch.config
        self.plan, self.broken = plan_execution(patch)
        self.plan_pos = {mid: i for i, mid in enumerate(self.plan)}
        self.output_id = patch.output.id
        # Snapshot static structure (the Patch may mutate afterwards).
        self.instances = {
            inst.id: (inst.mdef, inst.statics, tuple(inst.inputs))
            for inst in patch
        }
        self.default_params = patch.params()
        self.topology_key = patch.topology_key()

        # feedback reads: inputs whose source runs at-or-after the sink
        fb_keys = set()
        for mid, (_, _, inputs) in self.instances.items():
            for conn in inputs:
                if conn is None:
                    continue
                src, sport = conn
                if self.plan_pos[src] >= self.plan_pos[mid]:
                    fb_keys.add((src, sport))
        self.fb_keys = tuple(sorted(fb_keys))
        self._fused = None

    # -- state --------------------------------------------------------------

    def init_state(self) -> dict:
        cfg = self.cfg
        states = {
            mid: mdef.init_state(cfg, statics)
            for mid, (mdef, statics, _) in self.instances.items()
        }
        fb = {k: torch.zeros((), dtype=CV_DTYPE) for k in self.fb_keys}
        return {"states": states, "fb": fb}

    def derived_params(self, params: dict) -> dict:
        """Merge each module's per-render derived params (ModuleDef.derive),
        computed once per render outside the per-sample loop."""
        out = {}
        for mid, (mdef, statics, inputs) in self.instances.items():
            pd = params[mid]
            if mdef.derive is not None:
                connected = tuple(c is not None for c in inputs)
                pd = {**pd, **mdef.derive(self.cfg, statics, pd, connected)}
            out[mid] = pd
        return out

    # -- the per-sample body -------------------------------------------------

    def _sample_step(self, params, states, fb_t, nograd: bool = False):
        """One sample through the whole plan.  ``fb_t`` maps fb key -> the
        feedback value for this sample.  ``nograd=True`` (engines that are
        never differentiated) uses ``ModuleDef.step_nograd``; primal outputs
        are bit-identical.  Returns ``(new_states, fb_out, channels)`` with
        ``channels`` the Output module's per-channel values."""
        cfg = self.cfg
        values = {}
        new_states = {}
        channels = ()
        for mid in self.plan:
            mdef, statics, inputs = self.instances[mid]
            ins = []
            for conn in inputs:
                if conn is None:
                    ins.append(None)
                else:
                    src, sport = conn
                    if self.plan_pos[src] >= self.plan_pos[mid]:
                        ins.append(fb_t[(src, sport)])
                    else:
                        ins.append(values[(src, sport)])
            step = (mdef.step_nograd
                    if nograd and mdef.step_nograd is not None else mdef.step)
            new_state, outs = step(cfg, statics, params[mid], states[mid], ins)
            new_states[mid] = new_state
            for p, v in enumerate(outs):
                values[(mid, p)] = v
            if mid == self.output_id:
                channels = outs
        fb_out = {k: values[k] for k in self.fb_keys}
        return new_states, fb_out, channels

    # -- engines --------------------------------------------------------------

    def render_scan(self, params: dict, state: dict, n: int,
                    batched: bool, nograd: bool = False):
        """The scan engine (counterpart: ``_render_sample_mode``):
        ``_sample_step`` in a Python loop over ``n`` samples, on the device
        the tensors are on.  With ``nograd=True`` it
        is the fused kernel's plain version.  Returns ``(audio, final_state)``
        with audio ``[V, C, n]`` (unbatched: ``[C, n]``)."""
        params = self.derived_params(params)
        states, fb = state["states"], state["fb"]
        like = tree_leaves(state)[0]
        batch = tuple(like.shape[:1]) if batched else ()
        audio = torch.zeros(batch + (self.cfg.channels, n), dtype=CV_DTYPE,
                            device=like.device)
        for t in range(n):
            states, fb, channels = self._sample_step(params, states, fb,
                                                     nograd=nograd)
            for c, v in enumerate(channels):
                audio[..., c, t] = v
        final = {"states": states, "fb": fb}
        # a leaf fed by a constant (an unconnected input) can collapse to a
        # scalar: broadcast every leaf back to its starting shape and device
        final = _like(final, state)
        return audio, final

    def fused(self):
        """The fused CUDA kernel for this plan (generated on first use)."""
        if self._fused is None:
            from .ops import fused
            self._fused = fused.FusedKernel(self)
        return self._fused

    def fused_eligible(self) -> bool:
        """True when the patch can run on the fused CUDA kernel."""
        from .ops import fused
        return fused.eligible(self)

    def auto_engine(self, batched: bool, device) -> str:
        """Pick the engine by device: the fused kernel for a batched render
        on a CUDA device of a kernel-eligible patch, else the scan engine."""
        if (batched and torch.device(device).type == "cuda"
                and self.fused_eligible()):
            return "fused"
        return "scan"

    def render(self, n_samples: int, *, params: Optional[dict] = None,
               state: Optional[dict] = None, batched: bool = False,
               engine: str = "auto", device=None,
               segment: Optional[int] = None):
        """Render ``n_samples``.

        Returns ``(audio, probes, final_state)`` where audio is
        ``[channels, n]`` (batched: ``[V, channels, n]``) and probes is
        ``{}``.  Pass the returned state back in to continue a render.

        ``device``: where to render; params and state are moved there.  By
        default, the device of the params.  ``engine``: ``"scan"``,
        ``"fused"`` (batched CUDA renders of kernel-eligible patches), or
        ``"auto"`` (fused on CUDA when eligible, else scan).  ``segment``
        (segmented renders) is not ported yet and raises.
        """
        if segment is not None:
            raise NotImplementedError(f"segmented renders {_SLICE2}")
        if params is None:
            params = self.default_params
        if device is None:
            leaves = tree_leaves(params)
            device = leaves[0].device if leaves else "cpu"
        device = torch.device(device)
        params = tree_map(lambda a: torch.as_tensor(a).to(device), params)
        if state is None:
            state = self.init_state()
            if batched:
                v = tree_leaves(params)[0].shape[0]
                state = tree_map(
                    lambda a: a.expand((v,) + a.shape).contiguous(), state)
        state = tree_map(lambda a: torch.as_tensor(a).to(device), state)
        if engine == "auto":
            engine = self.auto_engine(batched, device)
        n = int(n_samples)
        if engine == "fused":
            if not batched:
                raise ValueError("fused engine requires batched render")
            audio, final = self.fused().render(params, state, n)
        elif engine == "scan":
            audio, final = self.render_scan(params, state, n, batched)
        else:
            raise ValueError(f"unknown engine {engine!r}")
        return audio, {}, final


def _like(tree, ref):
    if isinstance(ref, dict):
        return {k: _like(tree[k], ref[k]) for k in ref}
    return torch.as_tensor(tree).to(device=ref.device).expand(
        ref.shape).to(ref.dtype).contiguous()


_COMPILE_CACHE = _LRU(COMPILE_CACHE_CAP)


def compile_patch(patch: Patch, probes: Sequence = (),
                  automation: Sequence = ()) -> CompiledPatch:
    """Compile a patch, cached by topology (module types, statics and
    wiring; param values excluded, so slider edits reuse the plan and its
    built kernel)."""
    if probes:
        raise NotImplementedError(f"probes {_SLICE2}")
    if automation:
        raise NotImplementedError(f"automation {_SLICE2}")
    key = patch.topology_key()
    cached = _COMPILE_CACHE.get(key)
    if cached is None:
        cached = CompiledPatch(patch)
        _COMPILE_CACHE.put(key, cached)
    else:
        # refresh default params (they may have changed without recompiling)
        cached.default_params = patch.params()
    return cached
