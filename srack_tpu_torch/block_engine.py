"""Stage-partition block engine (counterpart: ``srack_tpu/block_engine.py``).

The scan engine and the fused kernels walk the whole plan once per sample.
This engine shrinks the per-sample region to what needs it:

1. **Classify.**  A module is *serial* if its recurrence has no parallel
   form here (``SERIAL_TYPES``: the Moog ladder, the ADSR), if an
   automated param of it is not one its block form takes as a lane, if it
   sits on a feedback cycle, or if it has state but no whole-block form.
   Everything else is block-capable: elementwise (VCA, Mixer, math,
   Output, ...), a prefix scan (the Oscillator's phase) or chunk-parallel
   (the Freeverb's delay lines).
2. **Partition.**  The serial *stage* is the serial set plus the modules
   sandwiched between serial ones; ``pre`` is what the stage depends on,
   ``post`` the rest.  A patch with no serial core seeds a stage from the
   kernel-safe ancestors of its other modules, and a stage of kernel-safe
   modules absorbs its kernel-safe neighbours (the same rules, in the same
   order, as the JAX package, so both partition a patch alike).
3. **Execute.**  ``pre`` and ``post`` run module by module over whole
   ``[V, n]`` rows (``ModuleDef.block``, or the step applied to whole
   rows); the stage runs sample by sample over its input wires: kernel K3
   (``ops/fused.py::StageKernel``) for CUDA tensors, its plain version, a
   torch loop over :meth:`BlockProgram._stage_step`, for CPU tensors.

Exact precision (``cfg.exact``) follows the JAX package's rules: no
synthesized stage seed and no absorption, so the stage holds only the
serial core (and what a feedback cycle forces into it); the Oscillators
outside it run their f64 block forms.  K3 runs an exact stage too, its f64
leaves (the Oscillator's phase) in a row array of doubles.  State leaves
keep their dtype through every phase, segment and carried state.

Buffer-feedback mode (``cfg.buffer_feedback``, the counterpart of
``_make_run_buffer``): a feedback edge reads the previous block's lane, so
one block's graph is acyclic; the three phases run block by block in a
Python loop, the stage reading its delayed wires as lanes keyed
``fb:src#port``, and the final state's ``fb`` holds the last block's lanes.

Wires are ``[V, n]`` tensors, one row per voice; there is no ``vmap``.
Per-voice params are ``[V]`` (``[V, *rest]`` for vectors) and an automated
param's lane ``[V, n]``; a module without a block form sees its params as
``[V, 1, *rest]`` columns so that its step broadcasts over the rows.
"""

from __future__ import annotations

import torch

from .compiler import _like, _probe_key, tree_leaves
from .config import AudioConfig
from .modules.base import CV_DTYPE
from .utils.profiling import span

# module types the block engine runs per sample in the serial stage
SERIAL_TYPES = frozenset({"Moog Filter", "ADSR"})


def kernel_safe(mdef) -> bool:
    """Can kernels K1 and K3 run this type?  (It names a device function;
    the counterpart of the JAX package's ``PALLAS_SAFE`` set and
    ``register_safe`` flag.)"""
    return mdef.cuda_fn is not None


def _sccs(nodes, deps):
    """Tarjan strongly-connected components (iterative)."""
    index, low, on_stack, stack, result = {}, {}, set(), [], []
    counter = 0
    for start in nodes:
        if start in index:
            continue
        work = [(start, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter
                counter += 1
                stack.append(node)
                on_stack.add(node)
            recurse = False
            succs = deps[node]
            for i in range(pi, len(succs)):
                s = succs[i]
                if s not in index:
                    work[-1] = (node, i + 1)
                    work.append((s, 0))
                    recurse = True
                    break
                if s in on_stack:
                    low[node] = min(low[node], index[s])
            if recurse:
                continue
            work.pop()
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                result.append(comp)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
    return result


def wire_key(w) -> str:
    """A stage lane's key for a wire ``(src, port)``, or for a block-delayed
    wire ``("fb", src, port)`` (buffer mode)."""
    if len(w) == 3:
        return f"fb:{w[1]}#{w[2]}"
    return f"{w[0]}#{w[1]}"


def _eval_key(key: str):
    """A stage lane key -> the ``_stage_step`` value key: a wire ``(src,
    port)``, a delayed wire ``("fb", src, port)``, ``("auto", mid,
    param)`` or ``("x", mid)``."""
    if "#" in key:
        mid, port = key.rsplit("#", 1)
        if mid.startswith("fb:"):
            return ("fb", mid[3:], int(port))
        return (mid, int(port))
    if "~" in key:
        mid, p = key.rsplit("~", 1)
        return ("auto", mid, p)
    return ("x", key)


class BlockProgram:
    """The partitioned execution plan of one compiled patch."""

    def __init__(self, compiled):
        self.compiled = compiled
        self.cfg: AudioConfig = compiled.cfg
        insts = compiled.instances
        plan = compiled.plan
        # buffer-feedback mode: a feedback edge carries a whole block-delayed
        # lane and is no dependency within a block
        self.buffer_mode = self.cfg.buffer_feedback
        is_fb = self._is_fb

        deps = {mid: [c[0] for c in insts[mid][2]
                      if c is not None
                      and not (self.buffer_mode and is_fb(c, mid))]
                for mid in insts}
        consumers = {mid: [] for mid in insts}
        for mid, ds in deps.items():
            for d in ds:
                consumers[d].append(mid)

        serial = {mid for mid, (mdef, _, _) in insts.items()
                  if mdef.type_name in SERIAL_TYPES}
        # an automated param that the module's block form cannot take as a
        # lane puts the module into the stage (the lane streams per sample)
        autos = dict(compiled._auto_by_mid)
        for mid, pnames in autos.items():
            if not set(pnames) <= insts[mid][0].auto_block_params:
                serial.add(mid)
        # feedback cycles run per sample, every member
        for comp in _sccs(list(insts), deps):
            if len(comp) > 1 or comp[0] in deps[comp[0]]:
                serial.update(comp)
        # block-capable only with a block form or no state (elementwise)
        for mid, (mdef, statics, _) in insts.items():
            if mid in serial:
                continue
            if mdef.block is None and mdef.init_state(self.cfg, statics,
                                                      "meta"):
                serial.add(mid)

        def reach(seed, adj):
            seen, frontier = set(seed), list(seed)
            while frontier:
                for s in adj[frontier.pop()]:
                    if s not in seen:
                        seen.add(s)
                        frontier.append(s)
            return seen

        def safe(mid):
            return kernel_safe(insts[mid][0])

        def has_carry(mids):
            return any(tree_leaves(insts[m][0].init_state(
                self.cfg, insts[m][1], "meta"))
                       for m in mids)

        # a patch with no serial core: seed a stage from the kernel-safe
        # ancestors of the other modules, if that stage is all safe and
        # carries state
        if not serial and not self.cfg.exact:
            unsafe = {m for m in insts if not safe(m)}
            safe_anc = {m for m in reach(unsafe, deps) - unsafe
                        if safe(m) and m != compiled.output_id}
            if safe_anc and has_carry(safe_anc):
                cand = safe_anc | ((reach(safe_anc, consumers)
                                    & reach(safe_anc, deps)) - safe_anc)
                if all(safe(m) for m in cand):
                    serial = safe_anc

        desc = reach(serial, consumers)
        anc = reach(serial, deps)
        self.stage_set = serial | ((desc & anc) - serial)
        pre_set = {m for m in plan if m in anc and m not in self.stage_set}
        post_set = {m for m in plan
                    if m not in self.stage_set and m not in pre_set}

        # stage absorption over kernel-safe neighbours: a pre module whose
        # consumers are all stage/post-side (reverse plan order), a post
        # module whose producers are all pre/stage-side (plan order); the
        # Output module never joins
        if (self.stage_set and not self.cfg.exact
                and all(safe(m) for m in self.stage_set)):
            for m in reversed(plan):
                if (m in pre_set and safe(m) and m != compiled.output_id
                        and all(c in self.stage_set or c in post_set
                                for c in consumers[m])):
                    pre_set.discard(m)
                    self.stage_set.add(m)
            for m in plan:
                if (m in post_set and safe(m) and m != compiled.output_id
                        and all(d in pre_set or d in self.stage_set
                                for d in deps[m])):
                    post_set.discard(m)
                    self.stage_set.add(m)

        self.pre_plan = [m for m in plan if m in pre_set]
        self.stage_plan = [m for m in plan if m in self.stage_set]
        self.post_plan = [m for m in plan if m in post_set]
        self.stage_in = sorted({
            c for mid in self.stage_plan for c in insts[mid][2]
            if c is not None and c[0] in pre_set
            and not (self.buffer_mode and is_fb(c, mid))})
        self.stage_fb_in = sorted({
            c for mid in self.stage_plan for c in insts[mid][2]
            if c is not None and is_fb(c, mid)}) if self.buffer_mode else []
        stage_out = {
            c for mid in self.post_plan for c in insts[mid][2]
            if c is not None and c[0] in self.stage_set
            and not (self.buffer_mode and is_fb(c, mid))}
        # probe taps on stage modules become extra stage outputs
        self.probe_wires = list(compiled.probes)
        stage_out.update(w for w in self.probe_wires
                         if w[0] in self.stage_set)
        if self.buffer_mode:
            stage_out.update(k for k in compiled.fb_keys
                             if k[0] in self.stage_set)
        self.stage_out = sorted(stage_out)

        # dead outputs of block_outs_hint modules: no wire, probe or audio
        # channel reads them
        used = set(self.probe_wires)
        for mid in plan:
            used.update(c for c in insts[mid][2] if c is not None)
        self._outs_used = {}
        for mid in plan:
            mdef, statics, _ = insts[mid]
            if mdef.block_outs_hint:
                self._outs_used[mid] = tuple(
                    mid == compiled.output_id or (mid, p) in used
                    for p in range(mdef.num_outputs(self.cfg, statics)))

        # the stage can run on kernel K3: every module has a device function
        # (in exact precision too: the generator takes f64 leaves, and
        # csrc/modules.cuh has the exact Oscillator's device function)
        self.kernel_ok = all(safe(m) for m in self.stage_plan)

        # automation: stage modules read their lanes per sample, block-phase
        # modules get [V, n] lanes in place of the params
        self.stage_autos = tuple(
            (mid, p) for mid in self.stage_plan for p in autos.get(mid, ()))
        self._stage_autos_by_mid = {mid: tuple(ps) for mid, ps in autos.items()
                                    if mid in self.stage_set}
        self._block_autos = {mid: tuple(ps) for mid, ps in autos.items()
                             if mid not in self.stage_set}
        self._stage_kernels: dict = {}

    def _is_fb(self, conn, mid) -> bool:
        """Is the wire ``conn`` into ``mid`` a feedback read (its source
        planned at or after its sink)?"""
        plan_pos = self.compiled.plan_pos
        return plan_pos[conn[0]] >= plan_pos[mid]

    # -- block phases --------------------------------------------------------

    def _run_block_phase(self, plan_subset, params, states, values, xs,
                         n: int, v: int, device, fb=None):
        """Run block-capable modules over whole ``[V, n]`` wires.  ``fb``
        (buffer mode): the previous block's lanes, which a feedback read
        takes.  Returns ``(new_states, channels)``; ``channels`` is the
        Output module's ``[V, n]`` rows if it is in ``plan_subset``."""
        cfg = self.cfg
        compiled = self.compiled
        new_states, channels = {}, None
        for mid in plan_subset:
            mdef, statics, inputs = compiled.instances[mid]
            ins = [None if c is None else
                   fb[c] if fb is not None and self._is_fb(c, mid)
                   else values[c] for c in inputs]
            lanes = {p: xs[compiled._auto_key(mid, p)]
                     for p in self._block_autos.get(mid, ())
                     if compiled._auto_key(mid, p) in xs}
            pd = {**params[mid], **lanes}
            with span(f"srk.block.{mdef.type_name}"):
                if mdef.block is not None:
                    kw = ({"outs_used": self._outs_used[mid]}
                          if mid in self._outs_used else {})
                    new_state, outs = mdef.block(cfg, statics, pd,
                                                 states[mid], ins,
                                                 xs.get(mid), n, **kw)
                else:
                    # stateless: the step over whole rows, params as columns
                    cols = {k: a if k in lanes else a.unsqueeze(1)
                            for k, a in pd.items()}
                    _, outs = mdef.step(cfg, statics, cols, {}, ins,
                                        xs.get(mid))
                    new_state = states[mid]
                outs = tuple(torch.as_tensor(o).to(
                    device=device, dtype=CV_DTYPE).expand(v, n)
                    for o in outs)
            new_states[mid] = new_state
            for p, o in enumerate(outs):
                values[(mid, p)] = o
            if mid == compiled.output_id:
                channels = outs
        return new_states, channels

    # -- serial stage --------------------------------------------------------

    def _stage_step(self, params, states, fb, ext):
        """One sample through the serial stage.  ``ext``: this sample's
        stage-in wires ``{(src, port): [V]}``, in buffer mode its delayed
        wires ``{("fb", src, port): [V]}``, automation values ``{("auto",
        mid, p): [V]}`` and lane values ``{("x", mid): [V]}``.  Returns
        ``(new_states, fb_out, outs)``."""
        cfg = self.cfg
        compiled = self.compiled
        values = dict(ext)
        new_states = {}
        for mid in self.stage_plan:
            mdef, statics, inputs = compiled.instances[mid]
            ins = []
            for c in inputs:
                if c is None:
                    ins.append(None)
                elif self.buffer_mode and self._is_fb(c, mid):
                    ins.append(values[("fb",) + c])
                elif c[0] in self.stage_set and self._is_fb(c, mid):
                    ins.append(fb[c])
                else:
                    ins.append(values[c])
            pd = params[mid]
            auto = [p for p in self._stage_autos_by_mid.get(mid, ())
                    if ("auto", mid, p) in values]
            if auto:
                pd = {**pd, **{p: values[("auto", mid, p)] for p in auto}}
            # the block engine is never differentiated: the nograd steps
            new_state, outs = (mdef.step_nograd or mdef.step)(
                cfg, statics, pd, states[mid], ins, values.get(("x", mid)))
            new_states[mid] = new_state
            for p, o in enumerate(outs):
                values[(mid, p)] = o
        fb_out = {k: values[k] for k in fb}
        outs = {w: values[w] for w in self.stage_out}
        return new_states, fb_out, outs

    def stage_plain(self, params: dict, state: dict, lanes: dict, n: int):
        """Kernel K3's plain version: :meth:`_stage_step` in a torch loop
        over ``n`` samples.  ``params``: the stage modules' derived params
        ``[V, ...]``; ``state``: ``{"states": {mid: ...}, "fb": ...}`` of
        the stage; ``lanes``: ``{stage lane key: [V, n]}``.  Returns
        ``({wire: [V, n]}, final stage state)``."""
        states = {mid: state["states"][mid] for mid in self.stage_plan}
        fb = state["fb"]
        v = tree_leaves(params)[0].shape[0] if tree_leaves(params) else \
            next(iter(lanes.values())).shape[0]
        device = (tree_leaves(state) + tree_leaves(params)
                  + list(lanes.values()))[0].device
        # a module that writes its state in place (Freeverb's rings) works
        # on a copy
        for mid in self.stage_plan:
            if self.compiled.instances[mid][0].step_in_place:
                states[mid] = {k: a.clone() for k, a in states[mid].items()}
        outs = {w: torch.empty((v, n), dtype=CV_DTYPE, device=device)
                for w in self.stage_out}
        keys = {k: _eval_key(k) for k in lanes}
        for t in range(n):
            ext = {keys[k]: lane[:, t] for k, lane in lanes.items()}
            states, fb, o = self._stage_step(params, states, fb, ext)
            for w, val in o.items():
                outs[w][:, t] = val
        final = _like({"states": states, "fb": fb},
                      {"states": {m: state["states"][m]
                                  for m in self.stage_plan},
                       "fb": state["fb"]})
        return outs, final

    def stage_kernel(self, lanes):
        """Kernel K3 for this stage and lane set (generated on first use)."""
        lanes = tuple(sorted(lanes))
        kernel = self._stage_kernels.get(lanes)
        if kernel is None:
            from .ops.fused import StageKernel
            kernel = self._stage_kernels[lanes] = StageKernel(self, lanes)
        return kernel

    def stage_lanes(self, values: dict, xs: dict, fb=None) -> dict:
        """The stage's input lanes: the stage-in wires, in buffer mode the
        delayed wires from ``fb``, the automation lanes of stage modules
        and the hoisted lanes of stage modules."""
        lanes = {wire_key(w): values[w] for w in self.stage_in}
        for k in self.stage_fb_in:
            lanes[wire_key(("fb",) + k)] = fb[k]
        for mid, p in self.stage_autos:
            key = self.compiled._auto_key(mid, p)
            if key in xs:
                lanes[key] = xs[key]
        for mid in self.stage_plan:
            if mid in xs:
                lanes[mid] = xs[mid]
        return lanes

    # -- full program --------------------------------------------------------

    def _run_stage(self, params, derived, states, values, xs, fb, n,
                   device):
        """The serial stage over ``n`` samples (K3 on CUDA tensors, its
        torch loop on CPU tensors); its output wires go into ``values``.
        ``fb``: the stage's carried feedback (sample mode), or in buffer
        mode the previous block's lanes, which it reads as lanes.  Returns
        the stage's final ``{"states", "fb"}``."""
        if not self.stage_plan:
            return {"states": {}, "fb": fb}
        lanes = self.stage_lanes(values, xs, fb)
        stage_state = {"states": {m: states[m] for m in self.stage_plan},
                       "fb": {} if self.buffer_mode else fb}
        if device.type == "cuda":
            outs, final = self.stage_kernel(lanes).run(params, stage_state,
                                                       lanes, n)
        else:
            outs, final = self.stage_plain(
                {m: derived[m] for m in self.stage_plan}, stage_state, lanes,
                n)
        values.update(outs)
        return final

    def _run_once(self, params, derived, states, fb, xs, n, v, device):
        """The pre phase, the stage and the post phase over ``n`` samples.
        Returns ``(channels, values, new_states, stage_fb)``."""
        values: dict = {}
        phase_fb = fb if self.buffer_mode else None
        with span("srk.block.pre"):
            pre_states, pre_channels = self._run_block_phase(
                self.pre_plan, derived, states, values, xs, n, v, device,
                phase_fb)
        with span("srk.block.stage"):
            stage_final = self._run_stage(params, derived, states, values,
                                          xs, fb, n, device)
        with span("srk.block.post"):
            post_states, channels = self._run_block_phase(
                self.post_plan, derived, states, values, xs, n, v, device,
                phase_fb)
        channels = channels if channels is not None else pre_channels
        new_states = {**states, **pre_states, **stage_final["states"],
                      **post_states}
        return channels, values, new_states, stage_final["fb"]

    def run(self, params: dict, state: dict, xs: dict, n: int):
        """Render ``n`` samples of V voices: ``params`` and ``state`` carry
        a leading voice axis, ``xs`` is the render's lanes (``[V, n]``).
        Returns ``(audio [V, C, n], probes {"mid:port": [V, n]},
        final_state)``.  In buffer mode ``n`` is a whole number of blocks,
        rendered one after another."""
        with span("srk.block.run"):
            compiled = self.compiled
            if compiled.output_id in self.stage_set:
                raise NotImplementedError(
                    "Output module inside a feedback cycle is not supported "
                    "by the block engine")
            leaves = tree_leaves(params) + tree_leaves(state)
            v, device = leaves[0].shape[0], leaves[0].device
            derived = compiled.derived_params(params)
            if not self.buffer_mode:
                channels, values, states, fb = self._run_once(
                    params, derived, state["states"], state["fb"], xs, n, v,
                    device)
                audio = torch.stack(channels, dim=1)
                probes = {_probe_key(mid, p): values[(mid, p)]
                          for mid, p in self.probe_wires}
                return audio, probes, _like({"states": states, "fb": fb},
                                            state)
            block = self.cfg.block_size
            if n % block:
                raise ValueError(
                    f"buffer_feedback mode renders whole blocks: n={n} is not "
                    f"a multiple of block_size={block}")
            states, fb = state["states"], state["fb"]
            audio = torch.empty((v, self.cfg.channels, n), dtype=CV_DTYPE,
                                device=device)
            probes = {_probe_key(mid, p): torch.empty((v, n), dtype=CV_DTYPE,
                                                      device=device)
                      for mid, p in self.probe_wires}
            for b in range(0, n, block):
                cut = slice(b, b + block)
                channels, values, states, _ = self._run_once(
                    params, derived, states, fb,
                    {k: a[..., cut] for k, a in xs.items()}, block, v, device)
                for c, ch in enumerate(channels):
                    audio[:, c, cut] = ch
                for mid, p in self.probe_wires:
                    probes[_probe_key(mid, p)][:, cut] = values[(mid, p)]
                # this block's feedback wires are the next block's delayed
                # lanes
                fb = {k: values[k] for k in compiled.fb_keys}
            return audio, probes, _like({"states": states, "fb": fb}, state)


def eligible(compiled) -> bool:
    """Can the port's block engine render this patch on the card?  Either
    precision and either feedback mode, no Output module in the stage, and
    a stage that kernel K3 can run (on the card the stage has no plain
    fallback)."""
    prog = compiled.block_program()
    return prog.kernel_ok and compiled.output_id not in prog.stage_set


__all__ = ["BlockProgram", "SERIAL_TYPES", "eligible",
           "kernel_safe", "wire_key"]
