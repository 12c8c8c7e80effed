"""Patch compiler (counterpart: ``srack_tpu/compiler.py``).

Lowering puts the module chain inside one per-sample step: ``_sample_step``
walks the whole plan once per sample, and an engine runs that step over
the render.

* ``"scan"``: a Python loop over samples around ``_sample_step`` on
  whatever device the tensors are on.  It is the port's reference path and
  the plain version of the fused kernels.
* ``"fused"``: the hand-written CUDA kernel generated from the plan
  (``ops/fused.py``); CUDA tensors only, an unbatched render as a batch
  of one voice.
* ``"block"``: the stage-partition block engine (``block_engine.py``):
  whole-block module forms over ``[V, n]`` rows around a per-sample serial
  stage, which runs on kernel K3 for CUDA tensors; the Freeverb runs on
  kernel K8, the Sample on K7.  It takes the patches the fused kernel
  cannot (a Freeverb, a Sample).

Gradients: ``grad_render_fn`` is the differentiable render.  For batched
CUDA tensors of a patch the fused kernel takes in sample mode, with an
adjoint for every module, it runs kernel K10 (``ops/fused_vjp.py``: a
CUDA forward and a CUDA backward); otherwise autograd through the scan
engine.

Feedback: the planner deletes back-edges, and an input whose source is
planned at or after its sink reads the carried value ``fb`` instead of this
sample's value.

* default (``buffer_feedback=False``): ``fb`` holds the previous *sample*.
* compat (``buffer_feedback=True``): ``fb`` holds the previous *block* of
  ``block_size`` samples, the reference engine's previous-buffer feedback;
  the scan engine renders block by block, each block reading the previous
  block's fb lanes (the counterpart of ``_render_buffer_mode``), and the
  fused engine runs kernel K2's counterpart.

Precision: ``cfg.exact`` keeps the reference's f64 leaves (the Oscillator's
phase, the Freeverb's core) as ``torch.float64`` through every engine,
carried state and segment; torch needs no x64 switch.  An exact patch is
never fused-eligible (as in the JAX package), so on the card it renders on
the block engine, whose kernels have f64 builds.

Hoisted lanes: per-sample sources with no state (Noise draws, Input
drivers) and automation lanes (a scalar param promoted to a per-sample
array) are made once per render outside the sample loop and read sample by
sample.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import torch

from .config import AudioConfig
from .modules.base import CV_DTYPE
from .ops.basic import fold_in
from .patch import ModuleHandle, Patch
from .planner import plan_execution
from .utils.profiling import span


def _probe_key(mid: str, port: int) -> str:
    return f"{mid}:{port}"


def _mid(module) -> str:
    return module.id if isinstance(module, ModuleHandle) else module


class _LRU(OrderedDict):
    """Bounded insertion/access-ordered cache."""

    def __init__(self, cap: int):
        super().__init__()
        self.cap = cap
        self.misses = 0   # entries made (what recompile_guard watches)

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


def tree_items(tree, prefix=()) -> list:
    """``[(path, leaf)]`` of a tree of dicts, in its order; a path is the
    tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in tree_items(v, prefix + (k,))]
    return [(prefix, tree)]


def run_one_voice(run, params, state, xs, n: int):
    """A batched engine ``run(params, state, xs, n) -> (audio, probes,
    final_state)`` on one voice: a voice axis of 1 added to the params, the
    state and the lanes, and taken off the results again."""
    def add(tree):
        return tree_map(lambda t: t.unsqueeze(0), tree)

    def drop(tree):
        return tree_map(lambda t: t[0], tree)

    audio, probes, final = run(add(params), add(state), add(xs), n)
    return audio[0], drop(probes), drop(final)


def resolve_device(device) -> torch.device:
    """The render device: the card unless the caller names another."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: srack_tpu_torch renders on the card by "
                "default; pass device=\"cpu\" to render on the CPU")
        device = "cuda"
    return torch.device(device)


class CompiledPatch:
    """An executable patch: the plan and the static structure it needs."""

    def __init__(self, patch: Patch, probes: Sequence = (),
                 automation: Sequence = ()):
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

        # probes: (module, port) pairs resolved to (mid, port index)
        self.probes = []
        for module, port in probes:
            mid = _mid(module)
            mdef, statics, _ = self.instances[mid]
            pidx = mdef.port_index(self.cfg, statics, port, output=True)
            self.probes.append((mid, pidx))

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

        # modules with a hoisted lane: Noise draws and Input drivers
        self.xs_modules = tuple(
            mid for mid in self.plan
            if self.instances[mid][0].make_xs is not None
            or self.instances[mid][0].type_name == "Input")

        # automation: (module, param) pairs whose value streams per sample
        autos = []
        for module, pname in automation:
            mid = _mid(module)
            if mid not in self.instances:
                raise KeyError(f"automation target {mid!r} not in patch")
            leaf = self.default_params[mid].get(pname)
            if leaf is None:
                raise KeyError(
                    f"{mid!r} has no param {pname!r} "
                    f"(has: {sorted(self.default_params[mid])})")
            if leaf.dim() != 0 or leaf.dtype != CV_DTYPE:
                raise ValueError(
                    f"only scalar float32 params can be automated; "
                    f"{mid}.{pname} is {leaf.dtype} of shape "
                    f"{tuple(leaf.shape)}")
            autos.append((mid, pname))
        self.automation = tuple(sorted(set(autos)))
        self._auto_by_mid: dict = {}
        for mid, pname in self.automation:
            self._auto_by_mid.setdefault(mid, []).append(pname)
        self._fused: dict = {}
        self._fused_vjp: dict = {}
        self._block_prog = None

    @staticmethod
    def _auto_key(mid: str, pname: str) -> str:
        return f"{mid}~{pname}"

    # -- state --------------------------------------------------------------

    def init_state(self, device=None) -> dict:
        """One voice's initial state, every leaf made on ``device`` (the
        CPU by default; ``"meta"`` gives the layout alone)."""
        cfg = self.cfg
        states = {
            mid: mdef.init_state(cfg, statics, device)
            for mid, (mdef, statics, _) in self.instances.items()
        }
        shape = (cfg.block_size,) if cfg.buffer_feedback else ()
        fb = {k: torch.zeros(shape, dtype=CV_DTYPE, device=device)
              for k in self.fb_keys}
        return {"states": states, "fb": fb}

    def derived_params(self, params: dict) -> dict:
        """Merge each module's per-render derived params (ModuleDef.derive),
        computed once per render outside the per-sample loop.  Automated
        modules skip it: a value hoisted from the static param would be
        stale, and their steps take the per-sample path."""
        out = {}
        for mid, (mdef, statics, inputs) in self.instances.items():
            pd = params[mid]
            if mdef.derive is not None and mid not in self._auto_by_mid:
                connected = tuple(c is not None for c in inputs)
                pd = {**pd, **mdef.derive(self.cfg, statics, pd, connected)}
            out[mid] = pd
        return out

    # -- hoisted lanes ------------------------------------------------------

    def _make_xs(self, params: dict, key: int, n: int,
                 drivers: dict, voice0: int = 0) -> dict:
        """This render's lanes, ``{lane key: [..., n] f32}``: a bound
        driver (keyed by module id) replaces a module's own lane; Noise
        draws from ``fold_in(key, i)`` with ``i`` its index among the lane
        modules, voice ``j`` of the call drawing the row of voice
        ``voice0 + j`` of the whole batch; an Input without a driver and an
        automated param without an array get no lane (the step reads the
        param)."""
        xs = {}
        with span("srk.lanes"):
            for i, mid in enumerate(self.xs_modules):
                mdef, statics, _ = self.instances[mid]
                if mid in drivers:
                    xs[mid] = _lane(drivers[mid], n, f"driver for {mid}")
                elif mdef.make_xs is not None:
                    xs[mid] = mdef.make_xs(self.cfg, statics, params[mid],
                                           fold_in(key, i), n, voice0)
            for mid, pname in self.automation:
                k = self._auto_key(mid, pname)
                if k in drivers:
                    xs[k] = _lane(drivers[k], n,
                                  f"automation lane {mid}.{pname}")
        return xs

    # -- the per-sample body -------------------------------------------------

    def _sample_step(self, params, states, fb_t, x_t, nograd: bool = False):
        """One sample through the whole plan.  ``fb_t`` maps fb key -> the
        feedback value for this sample; ``x_t`` maps lane key -> this
        sample of the lane.  ``nograd=True`` (engines that are never
        differentiated) uses ``ModuleDef.step_nograd``; primal outputs are
        bit-identical.  Returns ``(new_states, fb_out, channels, probes)``
        with ``channels`` the Output module's per-channel values."""
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
            pd = params[mid]
            for pname in self._auto_by_mid.get(mid, ()):
                # the automation overlay: this sample's lane value where
                # the static param would be (no lane: the param holds)
                lane = x_t.get(self._auto_key(mid, pname))
                if lane is not None:
                    pd = {**pd, pname: lane}
            step = (mdef.step_nograd
                    if nograd and mdef.step_nograd is not None else mdef.step)
            new_state, outs = step(cfg, statics, pd, states[mid], ins,
                                   x_t.get(mid))
            new_states[mid] = new_state
            for p, v in enumerate(outs):
                values[(mid, p)] = v
            if mid == self.output_id:
                channels = outs
        fb_out = {k: values[k] for k in self.fb_keys}
        probe_vals = {_probe_key(mid, p): values[(mid, p)]
                      for mid, p in self.probes}
        return new_states, fb_out, channels, probe_vals

    # -- engines --------------------------------------------------------------

    def _buffers(self, params, state, n: int, batched: bool):
        ref = (tree_leaves(state["states"]) + tree_leaves(state["fb"])
               + tree_leaves(params))[0]
        batch = tuple(ref.shape[:1]) if batched else ()
        audio = torch.zeros(batch + (self.cfg.channels, n), dtype=CV_DTYPE,
                            device=ref.device)
        probes = {_probe_key(mid, p): torch.zeros(batch + (n,),
                                                  dtype=CV_DTYPE,
                                                  device=ref.device)
                  for mid, p in self.probes}
        return audio, probes

    def _run(self, params, state, xs, n: int, batched: bool,
             nograd: bool = False):
        """The scan engine (counterpart: ``_render_sample_mode`` and
        ``_render_buffer_mode``): ``_sample_step`` in a Python loop over
        ``n`` samples.  Returns ``(audio, probes, final_state)``."""
        params = self.derived_params(params)
        audio, probes = self._buffers(params, state, n, batched)
        states = state["states"]
        # sample mode: fb is the carry; buffer mode: the previous block's fb
        # lanes, while ``block_fb`` collects this block's, sample by sample
        fb, block_fb = state["fb"], None
        block = self.cfg.block_size if self.cfg.buffer_feedback else None
        # a module that writes its state in place (Freeverb's rings) works
        # on a copy, made once per render
        states = {mid: ({k: a.clone() for k, a in sd.items()}
                        if self.instances[mid][0].step_in_place else sd)
                  for mid, sd in states.items()}
        if block is not None and n % block:
            raise ValueError(
                f"buffer_feedback mode renders whole blocks: n={n} is not a "
                f"multiple of block_size={block}")
        for t in range(n):
            x_t = {k: lane[..., t] for k, lane in xs.items()}
            if block is None:
                fb_t = fb
            else:
                j = t % block
                if j == 0:
                    fb = block_fb if block_fb is not None else fb
                    block_fb = {k: audio.new_empty(audio.shape[:-2] + (block,))
                                for k in self.fb_keys}
                fb_t = {k: lane[..., j] for k, lane in fb.items()}
            states, fb_out, channels, probe_vals = self._sample_step(
                params, states, fb_t, x_t, nograd=nograd)
            if block is None:
                fb = fb_out
            else:
                for k, v in fb_out.items():
                    block_fb[k][..., j] = v
            for c, v in enumerate(channels):
                audio[..., c, t] = v
            for k, v in probe_vals.items():
                probes[k][..., t] = v
        final = {"states": states,
                 "fb": fb if block_fb is None else block_fb}
        # a leaf fed by a constant (an unconnected input) can collapse to a
        # scalar: broadcast every leaf back to its starting shape and device
        return audio, probes, _like(final, state)

    def render_scan(self, params: dict, state: dict, n: int,
                    batched: bool, nograd: bool = False,
                    xs: Optional[dict] = None):
        """The scan engine on the device the tensors are on; with
        ``nograd=True`` it is the fused kernels' plain version.  ``xs``:
        the render's lanes (``_make_xs``), none by default.  Returns
        ``(audio, final_state)`` with audio ``[V, C, n]`` (unbatched:
        ``[C, n]``)."""
        audio, _, final = self._run(params, state, xs or {}, n, batched,
                                    nograd=nograd)
        return audio, final

    def fused(self, lanes: Sequence = ()):
        """The fused CUDA kernel for this plan and lane set (generated on
        first use): K1, or K2's counterpart in buffer-feedback mode."""
        lanes = tuple(sorted(lanes))
        kernel = self._fused.get(lanes)
        if kernel is None:
            from .ops import fused
            kernel = self._fused[lanes] = fused.FusedKernel(self, lanes)
        return kernel

    def fused_eligible(self) -> bool:
        """True when the patch can run on the fused CUDA kernel."""
        from .ops import fused
        return fused.eligible(self)

    def fused_vjp(self, lanes: Sequence = (), t_chunk: int = 128):
        """Kernel K10, the fused VJP, for this plan, lane set and chunk
        length (generated on first use)."""
        key = (tuple(sorted(lanes)), int(t_chunk))
        kernel = self._fused_vjp.get(key)
        if kernel is None:
            from .ops import fused_vjp
            kernel = self._fused_vjp[key] = fused_vjp.FusedVJPKernel(
                self, key[0], key[1])
        return kernel

    def vjp_eligible(self) -> bool:
        """True when kernel K10 can differentiate the patch: the fused
        kernel takes it, in sample mode, and every module type has an
        adjoint."""
        from .ops import fused_vjp
        return fused_vjp.vjp_eligible(self)

    def grad_render_fn(self, n: int, batched: bool = True):
        """A differentiable render of ``n`` samples:
        ``(params, state, key, drivers) -> (audio, {}, final_state)``, with
        gradients flowing to the float params and the float initial-state
        leaves (int and bool leaves and the lanes get none).

        For batched CUDA tensors of a patch that :meth:`vjp_eligible`
        accepts it runs kernel K10 (a CUDA forward and a CUDA backward) and
        raises if K10 fails; otherwise (buffer mode, a patch the fused
        kernel cannot take, CPU tensors) autograd through the scan engine.
        ``key``: the int that seeds the Noise lanes; ``drivers``: ``{module
        id or "mid~param": [V, n] (batched) or [n] lane}``; ``voice0``: the
        index of the first voice in the whole batch (a shard's offset)."""
        n = int(n)

        def render(params, state, key=None, drivers=None, voice0=0):
            leaves = tree_leaves(params) + tree_leaves(state)
            device = leaves[0].device
            v = leaves[0].shape[0] if batched else None
            drv = {_mid(m): _to_lane(a, device, v)
                   for m, a in (drivers or {}).items()}
            xs = self._make_xs(params, 0 if key is None else int(key), n, drv,
                               voice0)
            if batched and device.type == "cuda" and self.vjp_eligible():
                audio, final = self.fused_vjp(xs).apply(params, state, n, xs)
                return audio, {}, final
            audio, _, final = self._run(params, state, xs, n, batched)
            return audio, {}, final

        return render

    def block_program(self):
        """The block engine's partition of this patch (made on first
        use)."""
        if self._block_prog is None:
            from .block_engine import BlockProgram
            self._block_prog = BlockProgram(self)
        return self._block_prog

    def block_eligible(self) -> bool:
        """True when the patch can run on the block engine's kernels."""
        from . import block_engine
        return block_engine.eligible(self)

    def auto_engine(self, batched: bool, device) -> str:
        """Pick the engine by device: on a CUDA device the fused kernel if
        the patch is eligible, else the block engine if it is eligible
        (every exact patch whose stage K3 can run); the scan engine
        otherwise.  A render of one unbatched voice takes the same engine
        as a batched render (it runs as a batch of one)."""
        if torch.device(device).type == "cuda":
            if self.fused_eligible():
                return "fused"
            if self.block_eligible():
                return "block"
        return "scan"

    def _fused_render(self, params, state, xs, n: int):
        audio, final = self.fused(xs).render(params, state, n, xs)
        return audio, {}, final

    def _render_once(self, n: int, params, state, key: int, drivers: dict,
                     batched: bool, engine: str, voice0: int = 0):
        # unbatched, the lanes are made in their unbatched form ([n]), so
        # the noise a render draws does not depend on the engine
        xs = self._make_xs(params, key, n, drivers, voice0)
        if engine == "scan":
            return self._run(params, state, xs, n, batched)
        if engine == "fused":
            run = self._fused_render
        elif engine == "block":
            run = self.block_program().run
        else:
            raise ValueError(f"unknown engine {engine!r}")
        if batched:
            return run(params, state, xs, n)
        return run_one_voice(run, params, state, xs, n)

    def render(self, n_samples: int, *, params: Optional[dict] = None,
               state: Optional[dict] = None, key: Optional[int] = None,
               drivers: Optional[dict] = None,
               automation: Optional[dict] = None, batched: bool = False,
               engine: str = "auto", device=None,
               segment: Optional[int] = None, voice0: int = 0):
        """Render ``n_samples``.

        Returns ``(audio, probes, final_state)`` where audio is
        ``[channels, n]`` (batched: ``[V, channels, n]``) and probes maps
        ``"mid:port"`` to ``[n]`` (``[V, n]``) values (scan and block
        engines).
        Pass the returned state back in to continue a render.

        ``device``: where to render, the CUDA card by default (it raises
        when there is none); params, state and lanes are moved there.
        ``engine``: ``"scan"``, ``"fused"`` (CUDA renders of
        kernel-eligible patches), ``"block"`` (the block engine; on the CPU
        its kernels' plain versions), or ``"auto"`` (on CUDA: fused when
        eligible, else block when eligible; else scan).  An unbatched
        render on the kernels runs as a batch of one voice.  ``key``: an
        int that seeds the Noise lanes (0 by default).  ``drivers``:
        ``{Input or Noise module: [n] or [V, n] array}``.
        ``automation``: ``{(module, "param"): [n] or [V, n] array}`` for
        pairs declared at compile time.  ``segment``:
        render in ``segment``-sample pieces with the state carried, one
        kernel launch each (must divide ``n_samples``); segment ``i`` draws
        its noise from ``fold_in(key, i)``.  ``voice0``: the index of the
        first voice in the whole batch, for a shard of one
        (``parallel.render_farm``): voice ``j`` draws the Noise row of voice
        ``voice0 + j``.
        """
        with span("srk.render"):
            device = resolve_device(device)
            with span("srk.state"):
                if params is None:
                    params = self.default_params
                params = tree_map(lambda a: torch.as_tensor(a).to(device),
                                  params)
                v = tree_leaves(params)[0].shape[0] if batched else None
                if state is None:
                    # made on the render's device and broadcast there; the
                    # kernel wrappers make contiguous what they read as rows
                    state = self.init_state(device)
                    if batched:
                        state = tree_map(
                            lambda a: a.expand((v,) + a.shape), state)
                state = tree_map(lambda a: torch.as_tensor(a).to(device),
                                 state)
            key = 0 if key is None else int(key)
            drv = {}
            for module, arr in (drivers or {}).items():
                drv[_mid(module)] = arr
            for (module, pname), arr in (automation or {}).items():
                mid = _mid(module)
                if (mid, pname) not in self.automation:
                    raise KeyError(
                        f"({mid!r}, {pname!r}) was not declared at compile "
                        f"time; pass it in compile_patch(automation=...)")
                drv[self._auto_key(mid, pname)] = arr
            drv = {k: _to_lane(a, device, v) for k, a in drv.items()}
            if engine == "auto":
                engine = self.auto_engine(batched, device)
            n = int(n_samples)
            if segment is None:
                return self._render_once(n, params, state, key, drv, batched,
                                         engine, voice0)
            segment = int(segment)
            if segment <= 0:
                raise ValueError(f"segment must be positive, got {segment}")
            if n % segment:
                raise ValueError(
                    f"segment={segment} must divide the render length n={n}")
            audio = probes = None
            for i in range(n // segment):
                cut = slice(i * segment, (i + 1) * segment)
                a, p, state = self._render_once(
                    segment, params, state, fold_in(key, i),
                    {k: x[..., cut] for k, x in drv.items()}, batched, engine,
                    voice0)
                if audio is None:
                    audio = a.new_empty(a.shape[:-1] + (n,))
                    probes = {k: x.new_empty(x.shape[:-1] + (n,))
                              for k, x in p.items()}
                audio[..., cut] = a
                for k, x in p.items():
                    probes[k][..., cut] = x
            if audio is None:  # n == 0
                return self._render_once(0, params, state, key, drv, batched,
                                         engine)
            return audio, probes, state


def _to_lane(arr, device, v: Optional[int]) -> torch.Tensor:
    """A driver or automation array as f32 on ``device``; a shared ``[n]``
    lane of a batched render is broadcast to ``[V, n]``."""
    t = torch.as_tensor(arr).to(device=device, dtype=CV_DTYPE)
    if v is not None and t.dim() == 1:
        t = t.expand(v, t.shape[0])
    return t.contiguous()


def _lane(arr: torch.Tensor, n: int, what: str) -> torch.Tensor:
    if arr.shape[-1] != n:
        raise ValueError(f"{what} has {arr.shape[-1]} samples, render "
                         f"needs {n}")
    return arr


def _like(tree, ref):
    if isinstance(ref, dict):
        return {k: _like(tree[k], ref[k]) for k in ref}
    return torch.as_tensor(tree).to(device=ref.device).expand(
        ref.shape).to(ref.dtype).contiguous()


def migrate_state(old: CompiledPatch, new: CompiledPatch,
                  state: dict) -> dict:
    """Carry a live render's state across a topology edit.

    Modules present in both programs (same id, same type, same statics and
    the same state layout) keep their state leaves; new modules start from
    ``init_state``; feedback wires present in both keep their carry and new
    ones start silent.  Works on unbatched and batched state (the batch
    prefix is read off a carried leaf).  A changed ``AudioConfig``
    re-initialises everything.
    """
    # both layouts (shapes and dtypes), nothing made
    old_init, new_init = old.init_state("meta"), new.init_state("meta")

    def _same_struct(mid: str) -> bool:
        a, b = old_init["states"].get(mid), new_init["states"].get(mid)
        if a is None or b is None or set(a) != set(b):
            return False
        return all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                   for k in a)

    if old.cfg != new.cfg:
        carried_ids: set = set()
    else:
        carried_ids = {
            mid for mid, (mdef, statics, _) in new.instances.items()
            if mid in old.instances
            and old.instances[mid][0].type_name == mdef.type_name
            and old.instances[mid][1] == statics
            and mid in state["states"]
            and _same_struct(mid)
        }

    prefix: tuple = ()
    device = None
    for mid in sorted(state["states"]):
        if mid not in old_init["states"]:
            continue
        live = tree_leaves(state["states"][mid])
        base = tree_leaves(old_init["states"][mid])
        if live and base and len(live) == len(base):
            live0 = torch.as_tensor(live[0])
            nd = live0.dim() - base[0].dim()
            prefix = tuple(live0.shape[:nd]) if nd > 0 else ()
            device = live0.device
            break

    # the new leaves made on the live state's device, broadcast there
    fresh = new.init_state(device)

    def bcast(tree):
        return tree_map(lambda a: a.expand(prefix + a.shape), tree)

    states = {
        mid: (state["states"][mid] if mid in carried_ids
              else bcast(fresh["states"][mid]))
        for mid in new.instances
    }
    fb = {}
    for k in new.fb_keys:
        live = state["fb"].get(k)
        init = fresh["fb"][k]
        if (live is not None and old.cfg == new.cfg
                and tuple(live.shape[live.dim() - init.dim():])
                == tuple(init.shape)):
            fb[k] = live
        else:
            fb[k] = bcast(init)
    return {"states": states, "fb": fb}


_COMPILE_CACHE = _LRU(COMPILE_CACHE_CAP)


def compile_patch(patch: Patch, probes: Sequence = (),
                  automation: Sequence = ()) -> CompiledPatch:
    """Compile a patch, cached by topology (module types, statics and
    wiring; param values excluded, so slider edits reuse the plan and its
    built kernel), probes and automated params.  ``probes``: (module, port)
    pairs whose values the render returns per sample (scan and block
    engines).
    ``automation``: (module, param) pairs whose values stream per sample;
    the arrays go to ``render``."""
    with span("srk.plan"):
        probes_key = tuple((_mid(m), p) for m, p in probes)
        autos_key = tuple(sorted((_mid(m), p) for m, p in automation))
        key = (patch.topology_key(), probes_key, autos_key)
        cached = _COMPILE_CACHE.get(key)
        if cached is None:
            with span("srk.plan.build"):
                cached = CompiledPatch(patch, probes=probes,
                                       automation=autos_key)
                _COMPILE_CACHE.put(key, cached)
                _COMPILE_CACHE.misses += 1
        else:
            # refresh default params (they may have changed without
            # recompiling)
            cached.default_params = patch.params()
        return cached
