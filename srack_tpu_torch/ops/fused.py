"""The fused voice kernels in CUDA C++: the whole patch's per-sample step
for V voices over n samples.

* **K1, ``fused_voice``**, replaces ``srack_tpu/ops/fused.py::
  make_fused_render`` (the Pallas kernel at ``pallas_call`` in that
  function).  Params, state, the plan and the render's hoisted lanes go in;
  audio ``[V, C, n]`` and the state after sample n-1 come out.
* **K2, ``fused_voice_buffer``**, replaces ``srack_tpu/ops/fused.py::
  make_fused_render_buffer`` (buffer-feedback compat mode): K1 with every
  feedback read delayed by one ``block_size`` block, the reference
  engine's previous-buffer feedback.
* **K3, ``serial_stage``** (:class:`StageKernel`), replaces
  ``srack_tpu/ops/serial_kernel.py::make_serial_kernel``: the block
  engine's serial stage, its input wires streamed in as lanes and its
  output wires streamed out.

All three are one source, generated per plan with a buffer-mode and a
stage-mode switch, each run as a pipeline of stage warps (K2 too;
``stages=1`` builds the one-thread twin).  The same generator emits
K10's forward, K1's pipeline with a checkpoint switch (each stage warp
stores its own state rows at every ``t_chunk`` boundary), and its
backward, a reverse pipeline of sweep stage warps fed by replay warps
(:func:`_generate_bwd_pipeline`, ``ops/fused_vjp.py``).  They carry none
of the TPU
layout over: no (8, 128) tiles, no 1,024-voice padding, no time chunks with
a scratch carry, no padded-tail snapshot, and for K2 no outer scan of one
kernel call per block.

Design:

* **A pipeline of stage warps, one launch per render (K1, K2, K3).**  Voices
  are independent and time is a recurrence, so a voice's samples are a
  serial chain, but most of a plan's modules do not depend on each other
  within a sample.  ``ops/partition.py`` cuts the plan into at most four
  stages, runs of consecutive modules of about equal cost (never through
  a feedback carry's cycle; K2's plan carries none, its feedback is
  a block late).  A CTA holds 32 voices and one warp per
  stage, so the stages issue from the SM's four schedulers at once; at
  chunk step ``k`` warp ``g`` runs chunk ``k - g`` of ``T`` samples (a
  power of two, at most 32) and a named barrier ends the step.  A wire
  from stage ``a`` to stage ``b`` is a shared-memory ring of ``b - a + 1``
  chunks ``[T][32]``; each warp keeps its own modules' params, state and
  carries in registers (the sequencer: 80 registers where one thread per
  voice took 254) and stores its part of the final state.  The one-thread
  form stays: ``stages=1`` builds it, and so does K10 where its twin rule
  sends a plan (:func:`pick_fwd_chunk`).
* **Sample groups.**  At 1,024 voices each SM scheduler holds one warp, so
  a stage's time is the latency of its dependent chain, not its issue: a
  sample loop that reads and writes the same shared array cannot start
  sample t+1 before sample t's stores.  Each stage warp runs its chunk in
  groups of ``U`` samples (``SRK_U``, :func:`pick_group`) of straight-line
  code: every read of the group (lane values, ring wires, K2's copied
  feedback slots) into locals, then the module calls, then every write
  (ring wires, the audio tile, K3's outputs, K2's ring, the carries), so
  the chains of neighbouring samples overlap; the render's last chunk
  ends in the one-sample loop.  The calls go module by module (a module's
  ``U`` calls adjacent) unless a carry runs from one module of the stage to
  another; a CV-driven Oscillator's pitch (``srk_osc_pitch``, no state in
  it) comes for all ``U`` samples before its first step, so the IEEE
  division's slow-path branch, which ends a block the scheduler cannot
  leave, parts no pitch chain from another.  The ADSR selects its mode's
  update with ``selp`` rather than branches.  Every module is called with
  the same arguments in the same order per sample, so the audio is the
  same bit for bit.  A sample then costs the stages' group chains over
  ``U``: on an H100 80GB HBM3 at 700 W the headline voice (stages of
  38/67/35/38 operations, U = 8) renders 1,024 x 480,000 in 52.5 ms
  where the same stages one sample at a time, with the ADSR's branches,
  took 128.3, and the 16,384-voice farm 192,000 samples in 34.4 ms
  against 60.4 (chip_smoke.py phase 15).
* **Occupancy.**  1,024 voices give 32 CTAs of 5 warps on 132 SMs, one
  CTA per SM; 16,384 voices give 512 CTAs, all resident at once at
  ``T = 32`` (33.0 KB of shared memory for the headline), about 20 warps
  per SM.  Longer chunks take more shared memory: at ``T = 128`` only two
  CTAs fit an SM, and the 16,384-voice farm took 96.4 ms against 60.5 at
  ``T = 32`` (and 78.1 with one thread per voice), while the 1,024-voice
  headline gained 9 % (118.2 against 129.4 ms).  So ``T`` is the largest
  power of two up to 32 whose rings, lane buffers and tile fit 200 KB; a
  plan whose stages need more even at ``T = 8`` (many cross-stage wires)
  runs one thread per voice.
* **Lanes** (Noise draws, bound Input drivers, automation arrays, K3's
  input wires) come in as one ``[L, n, V]`` f32 array, so a warp's 32
  voices read 128 contiguous bytes per lane and sample.  A stage warp
  copies the next chunk of each lane it reads into a shared double buffer
  with ``cp.async`` while it computes this one, so a lane read in the
  sample loop is one shared-memory load, not a device-memory wait: the
  kit check's stage (3 modules, 2 lanes) fell from 276.6 to 75.9 ms.
  The wrapper's transpose from the ``[V, n]`` lanes costs one extra read
  and write of every lane (``8 * L * V * n`` bytes, 3.9 GB for one lane
  at 1,024 x 480,000).
  Which lanes exist depends on the render call (an Input with or without
  a driver, an automated param with or without an array), so the lane set
  is part of the generated source and of its build hash.
* **Sequencer tables** stay in the packed int rows: a table param is an
  ``srk_rows`` view, and a lookup is one load of ``tbl[(row + j) * V + v]``
  (32 neighbouring ints per warp), not a select chain.
* **K2's delayed feedback** lives in a per-voice ring in device memory,
  ``[n_fb, block, V]`` f32, a warp's voices on 128 contiguous bytes.  At
  sample t every fb read of key k takes ``ring[k][t % block]``, the value
  that key's source wrote one block earlier.  The ring starts as
  ``state["fb"]`` (``[V, block]``, transposed in) and, since ``n % block
  == 0``, ends as the last block in time order: K2's final fb.  Split into
  stages, the warp of each stage that reads a key copies the chunk's
  ``T`` slots into shared memory at the top of the chunk (one wait per
  chunk, not one per sample), and the warp of the key's source stores
  each sample's value at the end of the sample.  The warps run skewed by
  whole chunks, stage g's chunk c at step ``c + g``: a key read in stage g
  and written in stage h (``g <= h``: a source comes later in plan order)
  needs ``block >= (h - g + 1) * T``, so that the copy of slot ``t``
  comes after the write of ``t - block`` and before the write of ``t``
  (:func:`ring_chunk_limit` caps :func:`pick_chunk`; no chunk of at least
  8: one thread per voice).  At 1,024 voices and block
  1,024 the ring is 4 MiB per key and stays in the 50 MB L2; at 16,384
  voices it is 64 MiB per key and does not.  ``feedback_patch`` in buffer
  mode splits into stages of 68/68/39 operations (175 in one thread) and
  renders 1,024 x 491,520 in 78.014 ms where the one-thread form takes
  159.218 (chip_smoke.py phase 15, NVIDIA H100 80GB HBM3 at 700.00 W),
  0.490 of it; its costliest stage holds 0.39 of the operations.
* **The audio writes.**  K1's Output stage writes each chunk into a
  shared tile ``[2][C][32][T + 1]`` (a padded row per voice, so neither
  the writes nor the reads meet a bank twice), and a store warp, one more
  warp of the CTA, stores it row by row at the next chunk step, 32
  consecutive samples of one voice per store: one 128-byte transaction
  where the one-thread form's per-sample store touched 32 sectors.  The
  Output stage writes the next chunk into the tile's other buffer
  meanwhile.  When the Output stage's warp stored the tile itself, its
  32 dependent rows of loads and stores cost ~66 cycles a sample of the
  headline voice on top of its ~126, and paced the kernel at ~196 (the
  VCO's stage takes ~141; clock64, H100 80GB HBM3 at 700 W).  A row by
  the bulk copy engine (``cp.async.bulk``), one a lane, cost ~62, and
  from the store warp it was no faster than these stores.  K2 does the
  same.  K3's output wires go to ``[O, n, V]`` per sample, coalesced
  across the warp's voices.  The one-thread form stores straight to
  ``[V, C, n]``, 32 separate sectors per warp store.
* **Generated per plan.**  The module steps are the inline functions of
  ``csrc/modules.cuh`` (the pipeline's copies and barrier are in
  ``csrc/pipeline.cuh``); this file emits a small ``.cu`` per compiled
  plan, partition, chunk and lane set that loads params and state, calls
  the steps in plan order with wires as locals (a feedback read uses the
  carried local, or K2's ring slot, in the pipeline its chunk's copy; a
  wire from an earlier stage its ring), writes the audio and stores the
  final state.  Its one
  ``extern "C"`` entry launches the kernel on the caller's stream and
  returns ``cudaGetLastError()``.
* **Numerics.**  Built with ``--fmad=false`` and without fast math, so the
  Horner polynomials, the ladder and the ADSR reciprocals round as the
  torch steps do; constants are f32 literals of the values the Python
  steps round to.

The plain version is the scan engine with ``nograd=True``
(``CompiledPatch.render_scan``; in buffer mode its block loop,
``_render_buffer_mode``'s counterpart).  The wrapper launches the kernel
for CUDA tensors or raises; it never falls back.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from ..compiler import tree_leaves
from ..modules.base import CV_DTYPE
from ..utils.profiling import span
from .cuda_lib import (BUILD_ROOT, CSRC, NVCC_FLAGS, CudaLib, I,  # noqa: F401
                       P, build, require_cuda)
from .partition import (MAX_STAGES, module_ops, one_stage, partition,
                        sweep_ops)

BLOCK_DIM = 32


def eligible(compiled) -> bool:
    """Can this compiled patch run on the fused kernels?  (Fast precision,
    no probes, every module type with a device function.)"""
    if compiled.cfg.exact or compiled.probes:
        return False
    return all(mdef.cuda_fn is not None
               for mdef, _, _ in compiled.instances.values())


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One param or state leaf in the packed rows: ``rows`` rows from
    ``row`` of the float (``kind="f"``), int (``kind="i"``) or double
    (``kind="d"``: exact precision's f64 leaves) array."""
    path: tuple        # ("states", mid, key) / ("fb", key) / (mid, key)
    rest: tuple        # per-voice shape
    dtype: torch.dtype
    kind: str
    row: int

    @property
    def rows(self) -> int:
        n = 1
        for d in self.rest:
            n *= d
        return n

    @property
    def ctype(self) -> str:
        return {"f": "float", "i": "int", "d": "double"}[self.kind]


def _layout(entries):
    """Assign rows to ``(path, tensor)`` entries: f32 in one array, int32
    and bool (as int32) in another, f64 in a third.  Returns ``(leaves,
    float rows, int rows, double rows)``."""
    leaves, nxt = [], {"f": 0, "i": 0, "d": 0}
    for path, t in entries:
        if t.dtype == torch.float32:
            kind = "f"
        elif t.dtype in (torch.int32, torch.bool):
            kind = "i"
        elif t.dtype == torch.float64:
            kind = "d"
        else:
            raise TypeError(f"{path}: unsupported leaf dtype {t.dtype}")
        leaf = Leaf(path, tuple(t.shape), t.dtype, kind, nxt[kind])
        nxt[kind] += leaf.rows
        leaves.append(leaf)
    return tuple(leaves), nxt["f"], nxt["i"], nxt["d"]


def _param_entries(compiled, params, mids):
    out = []
    for mid in mids:
        mdef = compiled.instances[mid][0]
        out += [((mid, key), params[mid][key]) for key in sorted(params[mid])
                if key not in mdef.host_params]
    return out


def _state_entries(compiled, state, mids):
    out = [(("states", mid, key), state["states"][mid][key])
           for mid in mids
           for key in sorted(state["states"][mid])]
    if not compiled.cfg.buffer_feedback:  # K2's fb is the ring instead
        out += [(("fb", k), state["fb"][k]) for k in compiled.fb_keys]
    return out


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where each param and state leaf of one plan sits in the packed rows,
    from the plan's unbatched defaults (derived params included).  Exact
    precision's f64 leaves take ``n_pd`` and ``n_sd`` rows of doubles; a
    layout with any (:attr:`doubles`) gives its kernel three more operands,
    ``pd``, ``sd`` and ``sd_out`` (:data:`ARGTYPES_F64`)."""
    params: tuple
    n_pf: int
    n_pi: int
    state: tuple
    n_sf: int
    n_si: int
    n_pd: int = 0
    n_sd: int = 0

    @classmethod
    def of(cls, compiled, mids=None) -> "Layout":
        """The layout of every module, or of the modules ``mids`` (a serial
        stage: its modules and the feedback carries)."""
        mids = list(compiled.instances if mids is None else mids)
        derived = compiled.derived_params(compiled.default_params)
        p, n_pf, n_pi, n_pd = _layout(_param_entries(compiled, derived,
                                                     mids))
        st, n_sf, n_si, n_sd = _layout(_state_entries(
            compiled, compiled.init_state("meta"), mids))
        return cls(p, n_pf, n_pi, st, n_sf, n_si, n_pd, n_sd)

    @property
    def doubles(self) -> bool:
        return bool(self.n_pd or self.n_sd)


def _ident(*parts) -> str:
    return re.sub(r"\W", "_", "_".join(str(q) for q in parts))


def _var(path) -> str:
    """The C local holding a leaf: p_<mid>_<key>, s_<mid>_<key> or
    fb_<src>_<port>."""
    if path[0] == "states":
        return "s_" + _ident(*path[1:])
    if path[0] == "fb":
        return "fb_" + _ident(*path[1])
    return "p_" + _ident(*path)


def _lane_var(lane) -> str:
    return "x_" + _ident(lane)


def _statics_args(statics) -> list:
    return [str(int(s)) for s in statics if isinstance(s, (bool, int))]


def _inputs_of(compiled, mid, stage, fb_lanes, sfx="", fb=None):
    """The C expressions of ``mid``'s input ports and its ``CONN`` bits: a
    wire local, a feedback carry (or, in a buffer-mode stage, its lane), a
    stage input lane, or ``0.0f`` unconnected.  ``sfx`` ends the name of
    each per-sample local (a wire or a lane; a sample group's ``_u<u>``);
    ``fb`` maps a feedback key to the C expression of its read, in place of
    the carry (or the lane)."""
    ins, conn = [], 0
    for i, c in enumerate(compiled.instances[mid][2]):
        if c is None:
            ins.append("0.0f")
            continue
        conn |= 1 << i
        src, sport = c
        if compiled.plan_pos[src] >= compiled.plan_pos[mid] and fb:
            ins.append(fb((src, sport)))
        elif compiled.plan_pos[src] >= compiled.plan_pos[mid]:
            ins.append(_lane_var(f"fb:{src}#{sport}") + sfx if fb_lanes
                       else _var(("fb", (src, sport))))
        elif stage is not None and src not in stage.stage_set:
            # a stage input wire, streamed in as a lane
            ins.append(_lane_var(f"{src}#{sport}") + sfx)
        else:
            ins.append(f"w_{_ident(src)}{sfx}[{sport}]")
    return ins, conn


def _param_args(compiled, mid, keys, lane_idx, sfx="") -> list:
    """The step's param arguments: an automated param with an array reads
    this sample's lane value."""
    out = []
    for key in keys:
        auto = compiled._auto_key(mid, key)
        out.append(_lane_var(auto) + sfx if auto in lane_idx
                   else _var((mid, key)))
    return out


def _emit_calls(compiled, plan, lane_idx, params_of, state_of, stage,
                fb_lanes, scoped=True, audio=True, t_expr="t", sfx="",
                fb=None, pitched=()) -> list:
    """One sample's module calls in plan order, wires as locals ``w_<mid>``.
    ``scoped``: each call's input array lives in a block of its own; else it
    is ``in_<mid>``, kept in the sample's scope for the adjoints.
    ``audio``: the Output module writes the audio rows (else it is
    skipped), at index ``t_expr``.  ``sfx`` and ``fb``: the sample's names,
    as :func:`_inputs_of` takes them.  ``pitched``: Oscillators whose pitch
    :func:`_pitch_call` has already computed; their step is the core's."""
    cfg = compiled.cfg
    L = []
    for mid in plan:
        mdef, statics, _ = compiled.instances[mid]
        ins, conn = _inputs_of(compiled, mid, stage, fb_lanes, sfx, fb)
        if mid == compiled.output_id:
            if audio:
                L += [f"    {mdef.cuda_fn}(a{c}, {t_expr}, {val});"
                      for c, val in enumerate(ins)]
            continue
        w = f"w_{_ident(mid)}{sfx}"
        n_out = mdef.num_outputs(cfg, statics)
        tmpl = ", ".join([str(conn)] + _statics_args(statics))
        fn = mdef.cuda_fn
        if mid in pitched:
            fn = "srk_osc_core"
            args = [f"{x}_{_ident(mid)}{sfx}" for x in ("d", "f")]
        else:
            args = _param_args(compiled, mid, params_of.get(mid, []),
                               lane_idx, sfx)
        args += state_of.get(mid, [])
        if mid in lane_idx:
            args.append(_lane_var(mid) + sfx)
        L.append(f"    float {w}[{max(n_out, 1)}];")
        if ins and scoped:
            L.append(f"    {{ const float in[{len(ins)}] = "
                     f"{{{', '.join(ins)}}};")
            L.append(f"      {fn}<{tmpl}>("
                     + ", ".join(args + ["in", w]) + "); }")
        elif ins:
            L.append(f"    const float in_{_ident(mid)}[{len(ins)}] = "
                     f"{{{', '.join(ins)}}};")
            L.append(f"    {fn}<{tmpl}>("
                     + ", ".join(args + [f"in_{_ident(mid)}", w]) + ");")
        else:
            L.append(f"    {fn}<{tmpl}>("
                     + ", ".join(args + ["nullptr", w]) + ");")
    return L


def _pitch_first(compiled, mid, mods, params_of, by_module,
                 carried) -> bool:
    """Can a sample group compute Oscillator ``mid``'s pitch
    (``srk_osc_pitch``) for all its samples before the first of its steps?
    A fast Oscillator whose pitch is not hoisted (its only param is
    ``val``), whose CV is unconnected, a delayed wire that is not a carry
    (``carried``: the stage's feedback is carried), or a wire of this
    sample from outside the stage's modules ``mods`` (a ring or a lane) or,
    emitted module by module (``by_module``), from any earlier module."""
    mdef, _, conns = compiled.instances[mid]
    if (mdef.cuda_fn != "srk_oscillator" or compiled.cfg.exact
            or params_of.get(mid) != ["val"]):
        return False
    if conns[0] is None:
        return True
    src = conns[0][0]
    if compiled.plan_pos[src] >= compiled.plan_pos[mid]:
        return not carried
    return by_module or src not in mods


def _pitch_call(compiled, mid, lane_idx, params_of, stage, fb_lanes, sfx,
                fb) -> list:
    """Oscillator ``mid``'s pitch for one sample into ``d_<mid><sfx>`` and
    ``f_<mid><sfx>`` (its increment and fixed-point increment)."""
    ins, conn = _inputs_of(compiled, mid, stage, fb_lanes, sfx, fb)
    val, = _param_args(compiled, mid, params_of[mid], lane_idx, sfx)
    d, f = (f"{x}_{_ident(mid)}{sfx}" for x in ("d", "f"))
    return [f"    float {d};",
            f"    int {f};",
            f"    srk_osc_pitch<{conn & 1}>({val}, {ins[0]}, {d}, {f});"]


def _state_row_stores(layout, ptr: str, leaves=None) -> list:
    """Store the state row to ``ptr`` (one voice's column of ``[S, V]``
    int32 words, S = n_sf + n_si): float leaves first, as their bits, then
    int and bool leaves; with ``leaves``, only those leaves' rows."""
    L = []
    for leaf in layout.state if leaves is None else leaves:
        var = _var(leaf.path)
        base = leaf.row if leaf.kind == "f" else layout.n_sf + leaf.row
        for j in range(leaf.rows):
            val = f"{var}[{j}]" if leaf.rest else var
            if leaf.kind == "f":
                val = f"srk_float_bits({val})"
            L.append(f"      {ptr}[{base + j} * (size_t)V] = {val};")
    return L


def _state_row_loads(layout, ptr: str, prefix: str = "", decl=False) -> list:
    """Load the state row from ``ptr`` (the layout of
    :func:`_state_row_stores`) into the state locals, or with ``decl``
    into new constants named ``prefix`` + the local's name."""
    L = []
    for leaf in layout.state:
        var = prefix + _var(leaf.path)
        base = leaf.row if leaf.kind == "f" else layout.n_sf + leaf.row
        vals = []
        for j in range(leaf.rows):
            word = f"{ptr}[{base + j} * (size_t)V]"
            vals.append(f"srk_int_as_float({word})" if leaf.kind == "f"
                        else word)
        if decl and leaf.rest:
            L.append(f"      const {leaf.ctype} {var}[{leaf.rows}] = "
                     f"{{{', '.join(vals)}}};")
        elif decl:
            L.append(f"      const {leaf.ctype} {var} = {vals[0]};")
        elif leaf.rest:
            L += [f"      {var}[{j}] = {val};" for j, val in enumerate(vals)]
        else:
            L.append(f"      {var} = {vals[0]};")
    return L


def generate_source(compiled, layout: Layout = None, lanes=(),
                    stage=None, mode=None, t_chunk: int = 128,
                    split=None, chunk: int = None, group: int = None) -> str:
    """The ``.cu`` source of the fused kernel for ``compiled``'s plan and
    the lane set ``lanes`` (sorted lane keys: module ids of Noise and of
    driven Inputs, ``mid~param`` of automation arrays).

    With ``stage`` (a ``block_engine.BlockProgram``) it is the serial-stage
    kernel K3 instead: the stage's plan only, its input wires read from
    lanes keyed ``src#port`` (in buffer mode its feedback reads from the
    previous block's lanes, keyed ``fb:src#port``) and its output wires
    stored to ``audio`` as ``[O, n, V]`` (O = ``len(stage.stage_out)``) in
    place of the audio.

    ``mode`` picks one of the two kernels of the fused VJP (K10, sample
    mode only): ``"ckpt"`` is K1 plus a store of the whole state row at
    every ``t_chunk`` boundary into ``ck`` (``[n_chunks, S, V]`` int32
    words, floats as their bits, S = ``n_sf + n_si``); ``"bwd"`` is the
    backward kernel (:func:`_generate_bwd`).

    ``split`` (an ``ops.partition.Partition`` of the plan) of more than
    one stage makes K1, K2, K3 or K10's forward a pipeline of stage warps
    (:func:`_generate_pipeline`) with chunks of ``chunk`` samples
    (:func:`pick_chunk` by default; for K10's forward one that divides
    ``t_chunk``), and K10's backward a reverse pipeline
    (:func:`_generate_bwd_pipeline`); without one, or with one stage, the
    kernel runs the whole plan in one thread per voice.

    Deterministic: the same plan and lanes give the same text.  In buffer
    mode (``cfg.buffer_feedback``) it is K2's counterpart.  The same file
    builds with g++ (``-x c++``) into a host loop over voices,
    ``srk_fused_host`` (``srk_vjp_fwd_host``, ``srk_vjp_bwd_host``), which
    the tests use to check the generated code on the CPU."""
    cfg = compiled.cfg
    if mode not in (None, "ckpt", "bwd"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode is not None and cfg.exact:
        raise ValueError("the fused VJP kernels take fast precision: exact "
                         "precision's f64 leaves have no K10 path")
    if mode == "bwd" and split is not None and split.n_stages > 1:
        if stage is not None or cfg.buffer_feedback:
            raise ValueError("the fused VJP kernels take a whole sample-mode "
                             "patch")
        layout = layout or Layout.of(compiled)
        lanes = tuple(lanes)
        chunk = chunk or pick_bwd_chunk(compiled, split, lanes, layout,
                                        t_chunk)
        if chunk is None:
            raise ValueError(f"no sub-chunk of the backward's "
                             f"{split.n_stages} stages fits {SMEM_BUDGET} "
                             f"bytes of shared memory and t_chunk {t_chunk}")
        return _generate_bwd_pipeline(compiled, layout, lanes, t_chunk,
                                      split, chunk)
    if mode is not None and (stage is not None or cfg.buffer_feedback):
        raise ValueError("the fused VJP kernels take a whole sample-mode "
                         "patch")
    if mode is not None and t_chunk < 1:
        raise ValueError(f"t_chunk must be >= 1, got {t_chunk}")
    if split is not None and split.n_stages > 1:
        plan = compiled.plan if stage is None else stage.stage_plan
        return _generate_pipeline(
            compiled, layout or Layout.of(
                compiled, None if stage is None else plan),
            tuple(lanes), stage, split, chunk,
            t_chunk=int(t_chunk) if mode == "ckpt" else None, group=group)
    if mode == "bwd":
        return _generate_bwd(compiled, layout or Layout.of(compiled),
                             tuple(lanes), t_chunk)
    ckpt = mode == "ckpt"
    plan = compiled.plan if stage is None else stage.stage_plan
    layout = layout or Layout.of(compiled, None if stage is None else plan)
    lanes = tuple(lanes)
    # K2's ring; a buffer-mode stage reads its delayed wires as lanes
    buffer = cfg.buffer_feedback and stage is None
    fb_lanes = cfg.buffer_feedback and stage is not None
    if stage is not None and compiled.output_id in plan:
        raise ValueError("the serial-stage kernel runs without the Output "
                         "module")
    n_ch = cfg.channels
    lane_idx = {k: i for i, k in enumerate(lanes)}
    params_of, state_of = _args_of(layout)

    def fb_slot(k):
        return (f"ring[((size_t){compiled.fb_keys.index(k)} * SRK_FB_BLOCK "
                "+ slot) * V + v]")

    if stage is not None:
        kind = "serial-stage kernel (K3)"
    elif ckpt:
        kind = "forward kernel of the fused VJP (K10)"
    else:
        kind = ("fused buffer-feedback kernel (K2)" if buffer
                else "fused voice kernel (K1)")
    L = _header(compiled, plan, lanes, kind)
    if buffer:
        L.append(f"#define SRK_FB_BLOCK {int(cfg.block_size)}")
    if ckpt:
        L += [f"#define SRK_T_CHUNK {int(t_chunk)}",
              f"#define SRK_S_ROWS {layout.n_sf + layout.n_si}",
              '#include "modules_adj.cuh"']
    else:
        L.append('#include "modules.cuh"')
    L += [
        "",
        "SRK_HD void srk_voice(int v, int V, int n, "
        "const float* __restrict__ pf, const int* __restrict__ pi, "
        "const float* __restrict__ sf, const int* __restrict__ si, "
        "const float* __restrict__ lanes, float* __restrict__ ring, "
        "float* __restrict__ audio, float* __restrict__ sf_out, "
        "int* __restrict__ si_out"
        + (_DOUBLE_PARAMS if layout.doubles else "")
        + (", int* __restrict__ ck) {" if ckpt else ") {"),
        "  // params, loaded once",
    ]
    L += [_load(leaf, "p" + leaf.kind, True) for leaf in layout.params]
    L.append("  // state" + ("" if cfg.buffer_feedback
                             else " and feedback carries")
             + ", in registers")
    L += [_load(leaf, "s" + leaf.kind, False) for leaf in layout.state]
    if stage is None:
        L += [f"  float* a{c} = audio + ((size_t)v * {n_ch} + {c}) * "
              "(size_t)n;" for c in range(n_ch)]
    if buffer:
        L.append("  int slot = 0;  // t % SRK_FB_BLOCK")
    L.append("  for (int t = 0; t < n; ++t) {")
    if ckpt:
        L += ["    if (t % SRK_T_CHUNK == 0) {  // this chunk's checkpoint",
              "      int* ckr = ck + (size_t)(t / SRK_T_CHUNK) * SRK_S_ROWS"
              " * V + v;"]
        L += _state_row_stores(layout, "ckr")
        L.append("    }")
    L += _lane_loads(lane_idx)
    if buffer:
        L += [f"    const float {_var(('fb', k))} = {fb_slot(k)};"
              for k in compiled.fb_keys]
    L += _emit_calls(compiled, plan, lane_idx, params_of, state_of, stage,
                     fb_lanes)
    if buffer:
        L += [f"    {fb_slot(k)} = w_{_ident(k[0])}[{k[1]}];"
              for k in compiled.fb_keys]
        L.append("    if (++slot == SRK_FB_BLOCK) slot = 0;")
    elif not fb_lanes:
        L += _fb_updates(compiled)
    if stage is not None:
        L += [f"    audio[((size_t){j} * n + t) * V + v] = "
              f"w_{_ident(src)}[{port}];"
              for j, (src, port) in enumerate(stage.stage_out)]
    L.append("  }")
    L.append("  // final state: after sample n-1")
    for leaf in layout.state:
        var = _var(leaf.path)
        for j in range(leaf.rows):
            val = f"{var}[{j}]" if leaf.rest else var
            L.append(f"  {_row('s' + leaf.kind + '_out', leaf, j)} = {val};")
    L.append("}")
    args = "pf, pi, sf, si, lanes, ring, audio, sf_out, si_out"
    decl = ("const float* pf, const int* pi, const float* sf, const int* si, "
            "const float* lanes, float* ring, float* audio, float* sf_out, "
            "int* si_out")
    if layout.doubles:
        args += _DOUBLE_ARGS
        decl += _DOUBLE_DECL
    if ckpt:
        args += ", ck"
        decl += ", int* ck"
    decl += ", int V, int n"
    entry = "srk_vjp_fwd" if ckpt else "srk_fused"
    L += _entries(entry, "srk_voice", args, decl)
    return "\n".join(L) + "\n"


# the double rows' operands of a layout with f64 leaves (exact precision),
# after the nine of every fused kernel
_DOUBLE_PARAMS = (", const double* __restrict__ pd, "
                  "const double* __restrict__ sd, double* __restrict__ sd_out")
_DOUBLE_DECL = ", const double* pd, const double* sd, double* sd_out"
_DOUBLE_ARGS = ", pd, sd, sd_out"


def _args_of(layout):
    """``{mid: [param keys]}`` and ``{mid: [state locals]}`` in the
    layout's (sorted) order."""
    params_of, state_of = {}, {}
    for leaf in layout.params:
        params_of.setdefault(leaf.path[0], []).append(leaf.path[1])
    for leaf in layout.state:
        if leaf.path[0] == "states":
            state_of.setdefault(leaf.path[1], []).append(_var(leaf.path))
    return params_of, state_of


def _row(arr, leaf, j):
    return f"{arr}[{leaf.row + j} * (size_t)V + v]"


def _load(leaf, arr, const):
    var, q = _var(leaf.path), "const " if const else ""
    if leaf.rest and leaf.kind == "i":
        # an int table: a view into the rows, read per sample
        return (f"  const srk_rows {var}{{{arr} + {leaf.row} * (size_t)V"
                " + v, (size_t)V};")
    if leaf.rest:
        vals = ", ".join(_row(arr, leaf, j) for j in range(leaf.rows))
        return f"  {q}{leaf.ctype} {var}[{leaf.rows}] = {{{vals}}};"
    return f"  {q}{leaf.ctype} {var} = {_row(arr, leaf, 0)};"


def _header(compiled, plan, lanes, kind) -> list:
    return [
        f"// Generated by srack_tpu_torch/ops/fused.py: the {kind}",
        "// for one plan, " + ", ".join(
            f"{mid} ({compiled.instances[mid][0].type_name})"
            for mid in plan) + ".",
        "// Lanes: " + (", ".join(lanes) if lanes else "none") + ".",
        f"#define SRK_SAMPLE_RATE {int(compiled.cfg.sample_rate)}",
        f"#define SRK_BLOCK {BLOCK_DIM}",
    ]


def _lane_loads(lane_idx) -> list:
    return [f"    const float {_lane_var(k)} = "
            f"lanes[((size_t){i} * n + t) * V + v];"
            for k, i in lane_idx.items()]


def _fb_updates(compiled) -> list:
    return [f"    {_var(('fb', k))} = w_{_ident(k[0])}[{k[1]}];"
            for k in compiled.fb_keys]


def _entries(entry, body, args, decl) -> list:
    """The CUDA kernel, its ``extern "C"`` launch (``<entry>_launch``, on
    the caller's stream, returning ``cudaGetLastError()``) and the host
    loop over voices (``<entry>_host``) for the g++ build."""
    return [
        "",
        "#ifdef __CUDACC__",
        f"__global__ void __launch_bounds__(SRK_BLOCK) "
        f"{entry}_kernel({decl}) {{",
        "  const int v = blockIdx.x * blockDim.x + threadIdx.x;",
        f"  if (v < V) {body}(v, V, n, {args});",
        "}",
        "",
        f'extern "C" int {entry}_launch({decl}, void* stream) {{',
        "  const int blocks = (V + SRK_BLOCK - 1) / SRK_BLOCK;",
        f"  {entry}_kernel<<<blocks, SRK_BLOCK, 0, (cudaStream_t)stream>>>("
        f"{args}, V, n);",
        "  return (int)cudaGetLastError();",
        "}",
        "#else",
        f'extern "C" int {entry}_host({decl}) {{',
        f"  for (int v = 0; v < V; ++v) {body}(v, V, n, {args});",
        "  return 0;",
        "}",
        "#endif",
    ]


# -- K1 and K3 as a pipeline of stage warps -----------------------------------

WARP = 32
SMEM_BUDGET = 200 * 1024  # bytes of dynamic shared memory a split CTA takes
# chunks of more than 32 samples keep fewer CTAs on an SM at once (the farm,
# 16,384 voices, ran slower at 64 and 128 than at 32; chip_smoke.py phase
# 15 times each)
CHUNK_MIN, CHUNK_MAX = 8, 32
# samples a stage warp runs as one group of straight-line code, at most;
# halved while a group of the costliest stage would hold more operations
# than GROUP_OPS (chip_smoke.py phase 15: the sequencer's stages of 142-167
# operations ran 425 ms a render at 4 samples a group and 199 at 2); at
# most TABLE_GROUP where a stage steps through a sequencer's table (an int
# table param read at the step each sample: on an H100 the drum machine's
# stage ran 55.8 ms at 4 and 67.7 at 8, the sampler kit's 28.1 and 30.7)
GROUP, GROUP_OPS, TABLE_GROUP = 8, 600, 4


def _leaf_mid(leaf):
    """The module a param or state leaf belongs to (a feedback carry: its
    source)."""
    if leaf.path[0] == "states":
        return leaf.path[1]
    if leaf.path[0] == "fb":
        return leaf.path[1][0]
    return leaf.path[0]


def _lanes_read(compiled, mid, stage, fb_lanes, lane_idx, keys) -> list:
    """The lane keys module ``mid`` reads: its hoisted lane, its automation
    lanes (``keys``: its param keys) and, in a serial stage, its input
    wires and (buffer mode) delayed wires."""
    out = [mid] if mid in lane_idx else []
    out += [compiled._auto_key(mid, k) for k in keys
            if compiled._auto_key(mid, k) in lane_idx]
    for c in compiled.instances[mid][2]:
        if c is None:
            continue
        src, sport = c
        if compiled.plan_pos[src] >= compiled.plan_pos[mid]:
            if fb_lanes:
                out.append(f"fb:{src}#{sport}")
        elif stage is not None and src not in stage.stage_set:
            out.append(f"{src}#{sport}")
    return out


def stage_lanes(compiled, part, lanes, stage, layout) -> tuple:
    """Per stage, the lane keys its modules read, in the kernel's lane
    order."""
    lane_idx = {k: i for i, k in enumerate(lanes)}
    params_of, _ = _args_of(layout)
    fb_lanes = compiled.cfg.buffer_feedback and stage is not None
    out = []
    for mods in part.stages:
        keys = {k for mid in mods for k in _lanes_read(
            compiled, mid, stage, fb_lanes, lane_idx,
            params_of.get(mid, []))}
        out.append(tuple(k for k in lanes if k in keys))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class SmemLayout:
    """Offsets (in floats) into a split CTA's dynamic shared memory:
    ``wires`` maps a cross-stage wire to ``(offset, slots)`` of its ring
    ``[slots][chunk][32]``; ``lanes`` maps ``(stage, lane key)`` to the
    offset of its double buffer ``[2][chunk][32]``; ``fb`` maps ``(stage,
    feedback key)`` to the offset of K2's chunk of ring reads
    ``[chunk][32]``; ``tile`` is the offset of K1's (K2's) audio tile
    ``[2][C][32][chunk + 1]``, a buffer for the chunk the Output stage
    writes and one for the chunk the store warp stores (None for K3)."""
    chunk: int
    wires: tuple
    lanes: tuple
    fb: tuple
    tile: object
    floats: int

    @property
    def nbytes(self) -> int:
        return 4 * self.floats


def smem_layout(part, lanes_of, channels: int, chunk: int,
                rings=()) -> SmemLayout:
    """The shared memory of a split CTA; ``channels``: K1's audio channels,
    0 for K3 (its outputs stream to device memory); ``rings``: K2's ring
    reads (:func:`ring_stages`)."""
    off, wires, lanes, fb = 0, [], [], []
    for w, a, b in part.wires:
        wires.append((w, off, b - a + 1))
        off += (b - a + 1) * chunk * WARP
    for g, keys in enumerate(lanes_of):
        for k in keys:
            lanes.append(((g, k), off))
            off += 2 * chunk * WARP
    for k, g, _ in rings:
        fb.append(((g, k), off))
        off += chunk * WARP
    tile = None
    if channels:
        tile = off
        off += 2 * channels * WARP * (chunk + 1)
    return SmemLayout(chunk, tuple(wires), tuple(lanes), tuple(fb), tile,
                      off)


def pick_chunk(part, lanes_of, channels: int, limit: int = CHUNK_MAX,
               rings=(), t_chunk: int = None):
    """The chunk length: the largest power of two from ``CHUNK_MIN`` to
    ``CHUNK_MAX`` and at most ``limit`` (K2's ring, :func:`ring_chunk_limit`)
    that divides ``t_chunk`` (K10's forward: every checkpoint falls on a
    chunk's first sample) and whose rings, lane buffers and tile fit
    ``SMEM_BUDGET``; None if none does (a plan with that many cross-stage
    wires and lanes, a block too short for its feedback ring, or a
    ``t_chunk`` no such chunk divides, runs one thread per voice)."""
    chunk = CHUNK_MAX
    while chunk > limit:
        chunk //= 2
    while chunk >= CHUNK_MIN:
        if ((t_chunk is None or t_chunk % chunk == 0)
                and smem_layout(part, lanes_of, channels, chunk,
                                rings).nbytes <= SMEM_BUDGET):
            return chunk
        chunk //= 2
    return None


def pick_group(chunk: int, part, layout) -> int:
    """The samples of a stage warp's group: the largest power of two up to
    ``GROUP`` and the chunk (``TABLE_GROUP`` where a module of the
    partition ``part`` reads an int table of ``layout``'s params) whose
    group of the costliest stage holds at most ``GROUP_OPS`` operations
    (at least one)."""
    group = min(GROUP, chunk)
    tables = {leaf.path[0] for leaf in layout.params
              if leaf.rest and leaf.kind == "i"}
    if tables & {mid for mods in part.stages for mid in mods}:
        group = min(group, TABLE_GROUP)
    while group > 1 and group * max(part.costs) > GROUP_OPS:
        group //= 2
    return group


def pick_fwd_chunk(compiled, part, lanes, layout, t_chunk: int):
    """The twin rule of K10's forward, in one place: the chunk of its
    stage-warp pipeline (:func:`pick_chunk` with ``t_chunk``), or None where
    the plan takes the one-thread twin (``fused_vjp_fwd_twin``): a
    partition of one stage, no chunk of 8 to 32 samples whose buffers fit
    ``SMEM_BUDGET``, or none that divides ``t_chunk``."""
    if part.n_stages < 2:
        return None
    lanes_of, channels, _, _ = split_needs(compiled, part, lanes, None,
                                           layout)
    return pick_chunk(part, lanes_of, channels, t_chunk=t_chunk)


def split_needs(compiled, part, lanes, stage, layout) -> tuple:
    """What a split kernel's chunk and shared memory depend on:
    ``(lanes_of, channels, rings, limit)``, each stage's lanes
    (:func:`stage_lanes`), the audio tile's channels (0 for K3), K2's ring
    reads (:func:`ring_stages`) and the longest chunk its ring allows
    (:func:`ring_chunk_limit`; ``CHUNK_MAX`` without a ring)."""
    buffer = compiled.cfg.buffer_feedback and stage is None
    lanes_of = stage_lanes(compiled, part, lanes, stage, layout)
    channels = 0 if stage is not None else compiled.cfg.channels
    if not buffer:
        return lanes_of, channels, (), CHUNK_MAX
    return (lanes_of, channels, ring_stages(compiled, part),
            ring_chunk_limit(compiled, part))


def ring_stages(compiled, part) -> tuple:
    """K2's feedback keys with the stage of each reader: ``((key, g, h),
    ...)``, ``g`` a stage that reads the key (one entry per reading stage),
    ``h`` the stage of its source.  A feedback source comes at or after its
    readers in plan order, and stages are runs of the plan, so ``g <=
    h``."""
    stage_of = part.stage_of()
    out = []
    for key in compiled.fb_keys:
        h = stage_of[key[0]]
        readers = {stage_of[mid] for mid in compiled.plan
                   for c in compiled.instances[mid][2]
                   if c == key and compiled.plan_pos[key[0]]
                   >= compiled.plan_pos[mid]}
        for g in sorted(readers):
            if g > h:
                raise ValueError(f"feedback {key} is read in stage {g}, "
                                 f"after its source's stage {h}")
            out.append((key, g, h))
    return tuple(out)


def ring_chunk_limit(compiled, part) -> int:
    """The longest chunk K2's feedback ring allows.  The warps run skewed
    by whole chunks: stage ``g`` copies the slots of its chunk's samples
    (slot ``t % block`` for sample ``t``) at the top of chunk step ``t // T
    + g``, stage ``h`` writes sample ``t`` during step ``t // T + h``.  The
    copy of ``t`` must come after the write of ``t - block``, a step after
    it where ``g < h`` and a chunk after it where ``g == h``, so ``block //
    T >= h - g + 1``: ``T <= block // (h - g + 1)`` for every key and
    reading stage."""
    block = compiled.cfg.block_size
    return min([block // (h - g + 1) for _, g, h in ring_stages(
        compiled, part)], default=CHUNK_MAX)


def _struct_leaf(leaf, arr) -> tuple:
    """A stage struct's member for a leaf and its load from ``arr``."""
    var = _var(leaf.path)
    if leaf.rest and leaf.kind == "i":
        return (f"  srk_rows {var};",
                [f"  S.{var} = srk_rows{{{arr} + {leaf.row} * (size_t)V + v,"
                 " (size_t)V};"])
    if leaf.rest:
        return (f"  {leaf.ctype} {var}[{leaf.rows}];",
                [f"  S.{var}[{j}] = {_row(arr, leaf, j)};"
                 for j in range(leaf.rows)])
    return f"  {leaf.ctype} {var};", [f"  S.{var} = {_row(arr, leaf, 0)};"]


def _generate_pipeline(compiled, layout: Layout, lanes: tuple, stage, part,
                       chunk, t_chunk: int = None, group: int = None) -> str:
    """K1, K2 or K3 for a plan cut into ``part.n_stages`` pipeline stages;
    with ``t_chunk``, K10's forward (K1 plus the checkpoints).

    One CTA holds 32 voices and one warp per stage.  Time goes in chunks of
    ``chunk`` samples, in lock step: at chunk step ``k`` warp ``g`` runs
    chunk ``k - g`` of its stage's modules, and a named barrier ends the
    step.  A wire from stage ``a`` to stage ``b`` lives in a shared-memory
    ring of ``b - a + 1`` chunk slots (``[slot][t][voice]``, so a warp's
    access is 32 neighbouring words); a warp's lanes come into a double
    buffer one chunk ahead (``cp.async``).  Each warp keeps its modules'
    params, state and feedback carries in a struct of registers and stores
    its part of the final state.  K1's Output stage writes each chunk of
    audio into a tile ``[2][C][32][chunk + 1]``, and a store warp stores
    it at the next step row by row, 32 consecutive samples of one voice
    per warp store; K3's stages store
    their output wires per sample (``[O, n, V]``, coalesced).  K2's
    feedback ring stays in device memory (``[n_fb, block, V]``): the warp
    of a key's reading stage copies the chunk's slots ``ring[k][t %
    block]`` into shared memory at the top of the chunk, the warp of its
    source stores each sample's value at the end of the sample
    (:func:`ring_chunk_limit` keeps the two a block apart).

    A warp runs its chunk in groups of ``group`` samples
    (:func:`pick_group` by default) of straight-line code: the group's
    reads, its calls (module by module where no carry runs between two of
    the stage's modules; a CV-driven Oscillator's pitch for every sample
    first), then its writes; the render's last samples, fewer than a
    group, take the one-sample loop.  Every module is called as in the
    one-thread kernel, with the same arguments in the same order per
    sample, so the result is the same bit for bit.

    K10's forward (``t_chunk``; ``chunk`` must divide it, so every
    checkpoint falls on a chunk's first sample): at the top of a chunk
    whose first sample ``t`` has ``t % t_chunk == 0``, each stage warp
    stores the state rows of the leaves it owns (its modules' state and
    the feedback carries whose cycle it holds), as they stand before
    sample ``t``, into ``ck[t / t_chunk]`` at the rows
    :func:`_state_row_stores` gives them, 32 neighbouring voices a store.
    So ``ck`` is the one-thread forward's ``[n_chunks, S, V]``.

    Each stage is a struct ``srk_st<g>`` and three functions: ``_load``,
    ``_chunk`` (one chunk of samples) and ``_store``; ``_fetch`` copies a
    chunk of its lanes.  The card runs them in the stage warps; the host
    build (``srk_fused_host``) runs the same lock step, stage after stage
    and lane after lane of each 32-voice block, through the same shared
    buffers, and the store warp's store after each step's stages."""
    cfg = compiled.cfg
    plan = compiled.plan if stage is None else stage.stage_plan
    fb_lanes = cfg.buffer_feedback and stage is not None
    buffer = cfg.buffer_feedback and stage is None   # K2's ring
    if stage is not None and compiled.output_id in plan:
        raise ValueError("the serial-stage kernel runs without the Output "
                         "module")
    n_ch = cfg.channels
    G = part.n_stages
    lane_idx = {k: i for i, k in enumerate(lanes)}
    params_of, state_of = _args_of(layout)
    stage_of = part.stage_of()
    if set(stage_of) != set(plan):
        raise ValueError("the partition does not cover the plan")
    ckpt = t_chunk is not None
    lanes_of, n_tile, rings, limit = split_needs(compiled, part, lanes,
                                                 stage, layout)
    chunk = chunk or pick_chunk(part, lanes_of, n_tile, limit, rings,
                                t_chunk)
    if chunk is None:
        raise ValueError(f"no chunk of the {G} stages fits {SMEM_BUDGET} "
                         "bytes of shared memory"
                         + (f" and divides t_chunk {t_chunk}" if ckpt else ""))
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if buffer and chunk > limit:
        raise ValueError(f"a chunk of {chunk} samples is longer than K2's "
                         f"feedback ring allows (block {cfg.block_size}: "
                         f"at most {limit})")
    group = pick_group(chunk, part, layout) if group is None else group
    if group < 1 or group & (group - 1) or chunk % group:
        raise ValueError(f"a group of {group} samples is not a power of two "
                         f"that divides the chunk of {chunk}")
    sm = smem_layout(part, lanes_of, n_tile, chunk, rings)
    if ckpt and t_chunk % chunk:
        raise ValueError(f"a chunk of {chunk} samples does not divide "
                         f"t_chunk {t_chunk}")
    if ckpt and sm.nbytes > SMEM_BUDGET:
        raise ValueError(f"the forward's {G} stages take {sm.nbytes} bytes "
                         f"of shared memory at a chunk of {chunk}, over "
                         f"{SMEM_BUDGET}")
    wire_at = {w: (off, slots) for w, off, slots in sm.wires}
    wire_from = {w: a for w, a, _ in part.wires}
    lane_at = dict(sm.lanes)
    fb_at = dict(sm.fb)
    out_stage = None if stage is not None else stage_of[compiled.output_id]
    if stage is not None:
        kind = "serial-stage kernel (K3)"
    elif ckpt:
        kind = "forward kernel of the fused VJP (K10)"
    else:
        kind = ("fused buffer-feedback kernel (K2)" if buffer
                else "fused voice kernel (K1)")
    L = _header(compiled, plan, lanes, kind + f", {G} pipeline stages")
    L += [f"// Stage {g}: " + ", ".join(mods) + f" ({part.costs[g]} ops)."
          for g, mods in enumerate(part.stages)]
    L.append(f"// Each stage runs its chunk in groups of SRK_U = {group} "
             "samples.")
    L += [f"// Feedback {k[0]}#{k[1]}: read in stage {g}, written in stage "
          f"{h}." for k, g, h in rings]
    if buffer:
        L.append(f"#define SRK_FB_BLOCK {int(cfg.block_size)}")
    if ckpt:
        L += [f"#define SRK_T_CHUNK {int(t_chunk)}",
              f"#define SRK_S_ROWS {layout.n_sf + layout.n_si}"]
    L += [f"#define SRK_STAGES {G}",
          f"#define SRK_THREADS {WARP * (G + (out_stage is not None))}",
          f"#define SRK_T {chunk}",
          f"#define SRK_U {group}",
          f"#define SRK_SMEM_FLOATS {sm.floats}",
          '#include "modules_adj.cuh"' if ckpt else '#include "modules.cuh"',
          '#include "pipeline.cuh"']
    ptrs = ("const float* __restrict__ lanes, float* __restrict__ ring, "
            "float* __restrict__ audio, float* __restrict__ sm"
            + (", int* __restrict__ ck" if ckpt else ""))

    def fb_slot(k, slot="slot"):
        return (f"ring[((size_t){compiled.fb_keys.index(k)} * SRK_FB_BLOCK "
                f"+ {slot}) * V + v]")
    for g, mods in enumerate(part.stages):
        mods = list(mods)
        leaves = [leaf for leaf in layout.params + layout.state
                  if _leaf_mid(leaf) in mods]
        members, loads = [], []
        for leaf in leaves:
            arr = ("p" if leaf in layout.params else "s") + leaf.kind
            member, load = _struct_leaf(leaf, arr)
            members.append(member)
            loads += load
        L += ["", f"struct srk_st{g} {{"] + (members or ["  int unused;"])
        L += ["};", "",
              f"SRK_HD void srk_st{g}_load(srk_st{g}& S, int v, int V, "
              "const float* __restrict__ pf, const int* __restrict__ pi, "
              "const float* __restrict__ sf, const int* __restrict__ si"
              + (", const double* __restrict__ pd, "
                 "const double* __restrict__ sd" if layout.doubles else "")
              + ") {"]
        L += loads + ["}", "",
                      f"SRK_HD void srk_st{g}_store(const srk_st{g}& S, "
                      "int v, int V, float* __restrict__ sf_out, "
                      "int* __restrict__ si_out"
                      + (", double* __restrict__ sd_out" if layout.doubles
                         else "") + ") {"]
        for leaf in leaves:
            if leaf in layout.state:
                var = _var(leaf.path)
                L += [f"  {_row('s' + leaf.kind + '_out', leaf, j)} = S.{var}"
                      + (f"[{j}];" if leaf.rest else ";")
                      for j in range(leaf.rows)]
        L.append("}")
        if lanes_of[g]:
            L += ["",
                  f"SRK_HD void srk_st{g}_fetch(int c, int lane, int v, "
                  "int V, int n, const float* __restrict__ lanes, "
                  "float* __restrict__ sm) {",
                  "  const int t0 = c * SRK_T;",
                  "  const int cnt = n - t0 < SRK_T ? n - t0 : SRK_T;",
                  "  const int lb = (c & 1) * SRK_T * 32 + lane;",
                  "  for (int tc = 0; tc < cnt; ++tc) {"]
            L += [f"    srk_cp_async4(sm + {lane_at[(g, k)]} + lb + tc * 32, "
                  f"lanes + ((size_t){lane_idx[k]} * n + t0 + tc) * V + v);"
                  for k in lanes_of[g]]
            L += ["  }", "}"]
        L += ["",
              f"SRK_HD void srk_st{g}_chunk(srk_st{g}& S, int c, "
              f"int n_chunks, int lane, int v, int V, int n, {ptrs}) {{"]
        for leaf in leaves:
            var = _var(leaf.path)
            q = "const auto&" if leaf in layout.params else "auto&"
            L.append(f"  {q} {var} = S.{var};")
        L += ["  const int t0 = c * SRK_T;",
              "  const int cnt = n - t0 < SRK_T ? n - t0 : SRK_T;"]
        owned = [leaf for leaf in leaves if leaf in layout.state]
        if ckpt and owned:
            L += ["  if (t0 % SRK_T_CHUNK == 0) {  // this stage's checkpoint "
                  "rows",
                  "      int* ckr = ck + (size_t)(t0 / SRK_T_CHUNK) * "
                  "SRK_S_ROWS * V + v;"]
            L += _state_row_stores(layout, "ckr", owned)
            L.append("  }")
        if lanes_of[g]:
            L += [f"  if (c + 1 < n_chunks) srk_st{g}_fetch(c + 1, lane, v, "
                  "V, n, lanes, sm);",
                  "  srk_cp_commit();",
                  "  srk_cp_wait1();  // this chunk's lanes have landed",
                  "  const int lb = (c & 1) * SRK_T * 32 + lane;"]
        # the wires this stage reads from earlier stages' rings
        ins = {}
        for mid in mods:
            for c in compiled.instances[mid][2]:
                if (c is not None and c[0] in stage_of
                        and stage_of[c[0]] != g
                        and compiled.plan_pos[c[0]]
                        < compiled.plan_pos[mid]):
                    ins.setdefault(c[0], set()).add(c[1])
        ring = {}   # wire -> the local holding its ring index this chunk
        for i, (w, a, _) in enumerate(part.wires):
            if a == g or w[1] in ins.get(w[0], ()):
                off, slots = wire_at[w]
                ring[w] = f"ws{i}"
                L.append(f"  const int ws{i} = {off} + (c % {slots}) * SRK_T"
                         " * 32 + lane;")
        if g == out_stage:
            L += [f"  float* a{ch} = sm + {sm.tile} + ((c & 1) * "
                  f"{n_ch * WARP} + {ch * WARP} + lane) * (SRK_T + 1);"
                  for ch in range(n_ch)]
        read_keys = [k for k, gr, _ in rings if gr == g]
        write_keys = [k for k in compiled.fb_keys
                      if buffer and stage_of[k[0]] == g]
        if read_keys:
            # the chunk's feedback reads, each written a block earlier in
            # an earlier chunk step, before any write of this chunk: one
            # wait for the whole chunk, not one per sample
            L += ["#pragma unroll 8",
                  "  for (int tc = 0; tc < cnt; ++tc) {",
                  "    const int slot = (t0 + tc) % SRK_FB_BLOCK;"]
            L += [f"    sm[{fb_at[(g, k)]} + tc * 32 + lane] = {fb_slot(k)};"
                  for k in read_keys]
            L.append("  }")
        carries = [k for k in compiled.fb_keys if not buffer and not fb_lanes
                   and stage_of.get(k[0]) == g]

        def sample(u):
            """Sample ``u`` of a group (None: the one-sample loop's body):
            its reads of shared memory, its module calls and its writes."""
            sfx = "" if u is None else f"_u{u}"
            i = "tc" if not u else f"(tc + {u})"
            t = "t" if not u else f"(t + {u})"
            if buffer:      # this sample's copy of K2's ring slots
                fb = (lambda k: _var(("fb", k)) + sfx)
            elif u and not fb_lanes:   # the group's previous sample's wire
                fb = (lambda k: f"w_{_ident(k[0])}_u{u - 1}[{k[1]}]")
            else:           # the carry, or the delayed wire's lane
                fb = None
            reads = [f"    const float {_lane_var(k)}{sfx} = "
                     f"sm[{lane_at[(g, k)]} + lb + {i} * 32];"
                     for k in lanes_of[g]]
            reads += [f"    const float {_var(('fb', k))}{sfx} = "
                      f"sm[{fb_at[(g, k)]} + {i} * 32 + lane];"
                      for k in read_keys]
            for src, ports in ins.items():
                mdef, statics, _ = compiled.instances[src]
                n_out = max(mdef.num_outputs(cfg, statics), 1)
                reads.append(f"    float w_{_ident(src)}{sfx}[{n_out}];")
                reads += [f"    w_{_ident(src)}{sfx}[{p}] = "
                          f"sm[{ring[(src, p)]} + {i} * 32];"
                          for p in sorted(ports)]
            # per module: its pitch (a group's Oscillator) and its call
            pitches = {mid: _pitch_call(compiled, mid, lane_idx, params_of,
                                        stage, fb_lanes, sfx, fb)
                       for mid in (pitched if u is not None else ())}
            calls = {mid: _emit_calls(
                compiled, [mid], lane_idx, params_of, state_of, stage,
                fb_lanes, t_expr=i, sfx=sfx, fb=fb, audio=u is None,
                pitched=pitched if u is not None else ()) for mid in mods}
            writes = [f"    sm[{ring[w]} + {i} * 32] = "
                      f"w_{_ident(w[0])}{sfx}[{w[1]}];"
                      for w in ring if wire_from[w] == g]
            if u is not None and g == out_stage:
                vals, _ = _inputs_of(compiled, compiled.output_id, stage,
                                     fb_lanes, sfx, fb)
                writes += [f"    srk_output(a{c}, {i}, {val});"
                           for c, val in enumerate(vals)]
            slot = "slot" if u is None else f"{t} % SRK_FB_BLOCK"
            writes += [f"    {fb_slot(k, slot)} = w_{_ident(k[0])}{sfx}"
                       f"[{k[1]}];" for k in write_keys]
            if u is None:
                writes += [f"    {_var(('fb', k))} = "
                           f"w_{_ident(k[0])}[{k[1]}];" for k in carries]
            if stage is not None:
                writes += [f"    audio[((size_t){j} * n + {t}) * V + v] = "
                           f"w_{_ident(src)}{sfx}[{port}];"
                           for j, (src, port) in enumerate(stage.stage_out)
                           if stage_of[src] == g]
            return reads, pitches, calls, writes

        # module by module (each module's calls for the group's samples
        # adjacent) unless a carry goes from one module of the stage to
        # another, whose next sample needs the other's sample before
        by_module = not any(
            c in carries and c[0] != mid
            and compiled.plan_pos[c[0]] >= compiled.plan_pos[mid]
            for mid in mods for c in compiled.instances[mid][2])
        pitched = {mid for mid in mods if _pitch_first(
            compiled, mid, mods, params_of, by_module,
            not buffer and not fb_lanes)}
        reads, _, calls, writes = sample(None)
        if group > 1:
            # groups of SRK_U samples in straight-line code: every read of
            # the group, then its calls, then every write, so the chains of
            # neighbouring samples share no load or store in between
            groups = [sample(u) for u in range(group)]
            L += ["  int tc = 0;",
                  "  for (; tc + SRK_U <= cnt; tc += SRK_U) {",
                  "    const int t = t0 + tc;",
                  "    (void)t;",
                  "    // group: reads"]
            L += [x for reads, _, _, _ in groups for x in reads]
            L.append("    // group: calls")
            if by_module:
                for mid in mods:
                    L += [x for _, p, _, _ in groups for x in p.get(mid, ())]
                    L += [x for _, _, c, _ in groups for x in c[mid]]
            else:
                L += [x for _, p, _, _ in groups for mid in p for x in p[mid]]
                L += [x for _, _, c, _ in groups for mid in mods
                      for x in c[mid]]
            L.append("    // group: writes")
            L += [x for _, _, _, writes in groups for x in writes]
            L += [f"    {_var(('fb', k))} = "
                  f"w_{_ident(k[0])}_u{group - 1}[{k[1]}];" for k in carries]
            L += ["  }",
                  "  for (; tc < cnt; ++tc) {  // the render's last samples"]
        else:
            L.append("  for (int tc = 0; tc < cnt; ++tc) {")
        L += ["    const int t = t0 + tc;",
              "    (void)t;"]
        if write_keys:
            L.append("    const int slot = t % SRK_FB_BLOCK;")
        L += reads + [x for mid in mods for x in calls[mid]] + writes
        L += ["  }", "}"]
    if out_stage is not None:
        L += ["",
              "// the Output stage's chunk of audio, from the tile to [V, C, "
              "n], by the",
              "// store warp: one voice's row at a time, 32 consecutive "
              "samples a store",
              "SRK_HD void srk_tile_store(int c, int lane, int v0, int V, "
              "int n, float* __restrict__ audio, "
              "const float* __restrict__ sm) {",
              "  const int t0 = c * SRK_T;",
              "  const int cnt = n - t0 < SRK_T ? n - t0 : SRK_T;",
              "  for (int u = 0; u < 32 && v0 + u < V; ++u) {",
              f"    for (int ch = 0; ch < {n_ch}; ++ch) {{",
              f"      float* row = audio + ((size_t)(v0 + u) * {n_ch} + ch) "
              "* n + t0;",
              f"      const float* tile = sm + {sm.tile} + ((c & 1) * "
              f"{n_ch * WARP} + ch * 32 + u) * (SRK_T + 1);",
              "      for (int tc = lane; tc < cnt; tc += 32) row[tc] = "
              "tile[tc];",
              "    }",
              "  }",
              "}"]
    L += _pipeline_entries(part, lanes_of, out_stage, ckpt, layout.doubles)
    return "\n".join(L) + "\n"


def _pipeline_entries(part, lanes_of, out_stage, ckpt=False,
                      doubles=False) -> list:
    """The split kernel (one warp per stage, and with an Output stage
    ``out_stage`` a store warp), its ``extern "C"`` launch (which sets the
    dynamic shared memory) and the host build's lock-step loop, with the
    one-thread kernel's arguments (``ckpt``: K10's forward, entry
    ``srk_vjp_fwd``, with the checkpoints ``ck``; ``doubles``: the double
    rows ``pd``, ``sd``, ``sd_out`` of exact precision).  The store warp
    stores chunk ``c`` of the audio tile at step ``c + out_stage + 1``, the
    step after the Output stage wrote it, while that stage writes chunk
    ``c + 1`` into the tile's other buffer; after the stages' last step it
    stores the chunk that step wrote."""
    entry = "srk_vjp_fwd" if ckpt else "srk_fused"
    ck = ", int* ck" if ckpt else ""
    dd = _DOUBLE_DECL if doubles else ""
    decl = ("const float* pf, const int* pi, const float* sf, const int* si, "
            "const float* lanes, float* ring, float* audio, float* sf_out, "
            f"int* si_out{dd}{ck}, int V, int n")
    ck = ", ck" if ckpt else ""
    da = _DOUBLE_ARGS if doubles else ""
    args = (f"pf, pi, sf, si, lanes, ring, audio, sf_out, si_out{da}{ck}, "
            "V, n")
    load = "pf, pi, sf, si" + (", pd, sd" if doubles else "")
    store = "sf_out, si_out" + (", sd_out" if doubles else "")
    chunk_args = f"lane, v, V, n, lanes, ring, audio, sm{ck}"
    # the chunk the store warp stores at step k (k = n_chunks + SRK_STAGES
    # - 1, one past the stages' last step, is the store warp's alone)
    stored = None if out_stage is None else f"k - {out_stage + 1}"
    L = ["", "#ifdef __CUDACC__",
         "__global__ void __launch_bounds__(SRK_THREADS) "
         f"{entry}_kernel({decl}) {{",
         "  extern __shared__ float sm[];",
         "  const int g = threadIdx.x >> 5;",
         "  const int lane = threadIdx.x & 31;",
         "  const int v0 = blockIdx.x * 32;",
         "  const int v = v0 + lane;",
         "  const bool live = v < V;",
         "  const int n_chunks = (n + SRK_T - 1) / SRK_T;"]
    for g in range(part.n_stages):
        L += [("  if" if g == 0 else "  } else if") + f" (g == {g}) {{",
              f"    srk_st{g} S;",
              "    if (live) {",
              f"      srk_st{g}_load(S, v, V, {load});"]
        if lanes_of[g]:
            L += ["      if (n_chunks > 0) {",
                  f"        srk_st{g}_fetch(0, lane, v, V, n, lanes, sm);",
                  "        srk_cp_commit();",
                  "      }"]
        L += ["    }",
              "    for (int k = 0; k < n_chunks + SRK_STAGES - 1; ++k) {",
              f"      const int c = k - {g};",
              "      if (c >= 0 && c < n_chunks) {",
              f"        if (live) srk_st{g}_chunk(S, c, n_chunks, "
              f"{chunk_args});"]
        L += ["      }",
              "      srk_step_barrier(SRK_THREADS);",
              "    }",
              f"    if (live) srk_st{g}_store(S, v, V, {store});"]
    if stored is not None:
        # every trip of the loop ends at the barrier and the last chunk is
        # stored after it.  The 16,384-voice farm (4 CTAs an SM) takes
        # 29.9-35.4 ms on an H100 by where ptxas places the warps' code;
        # this form measured fastest there (PERF.md §7)
        L += ["  } else {  // the store warp",
              "    for (int k = 0; k < n_chunks + SRK_STAGES - 1; ++k) {",
              f"      if ({stored} >= 0 && {stored} < n_chunks)",
              f"        srk_tile_store({stored}, lane, v0, V, n, audio, sm);",
              "      srk_step_barrier(SRK_THREADS);",
              "    }",
              "    const int k = n_chunks + SRK_STAGES - 1;",
              f"    if ({stored} >= 0 && {stored} < n_chunks)",
              f"      srk_tile_store({stored}, lane, v0, V, n, audio, sm);"]
    L += ["  }", "}", "",
          f'extern "C" int {entry}_launch({decl}, void* stream) {{',
          "  const int blocks = (V + 31) / 32;",
          "  const int bytes = SRK_SMEM_FLOATS * (int)sizeof(float);",
          f"  cudaError_t err = cudaFuncSetAttribute({entry}_kernel, "
          "cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);",
          "  if (err != cudaSuccess) return (int)err;",
          f"  {entry}_kernel<<<blocks, SRK_THREADS, bytes, "
          f"(cudaStream_t)stream>>>({args});",
          "  return (int)cudaGetLastError();",
          "}",
          "#else",
          "#include <vector>",
          "",
          f'extern "C" int {entry}_host({decl}) {{',
          "  std::vector<float> smem(SRK_SMEM_FLOATS);",
          "  float* sm = smem.data();",
          "  const int n_chunks = (n + SRK_T - 1) / SRK_T;",
          "  for (int v0 = 0; v0 < V; v0 += 32) {",
          "    const int live = V - v0 < 32 ? V - v0 : 32;"]
    for g in range(part.n_stages):
        L.append(f"    std::vector<srk_st{g}> S{g}(32);")
    L += ["    for (int lane = 0; lane < live; ++lane) {",
          "      const int v = v0 + lane;"]
    for g in range(part.n_stages):
        L.append(f"      srk_st{g}_load(S{g}[lane], v, V, {load});")
        if lanes_of[g]:
            L.append(f"      if (n_chunks > 0) srk_st{g}_fetch(0, lane, v, V, "
                     "n, lanes, sm);")
    L += ["    }",
          "    // the card's lock step: at step k stage g runs chunk k - g"]
    last = "<"
    if stored is not None:
        L += ["    // and the store warp stores the chunk the Output stage "
              "wrote at k - 1"]
        last = "<="
    L += [f"    for (int k = 0; k {last} n_chunks + SRK_STAGES - 1; ++k) {{"]
    for g in range(part.n_stages):
        L += [f"      if (k - {g} >= 0 && k - {g} < n_chunks) {{",
              "        for (int lane = 0; lane < live; ++lane) {",
              "          const int v = v0 + lane;",
              f"          srk_st{g}_chunk(S{g}[lane], k - {g}, n_chunks, "
              f"{chunk_args});",
              "        }"]
        L.append("      }")
    if stored is not None:
        # after the stages' step, so a tile with one buffer would fail
        L += [f"      if ({stored} >= 0 && {stored} < n_chunks)",
              "        for (int lane = 0; lane < 32; ++lane) "
              f"srk_tile_store({stored}, lane, v0, V, n, audio, sm);"]
    L += ["    }",
          "    for (int lane = 0; lane < live; ++lane) {",
          "      const int v = v0 + lane;"]
    L += [f"      srk_st{g}_store(S{g}[lane], v, V, {store});"
          for g in range(part.n_stages)]
    L += ["    }", "  }", "  return 0;", "}", "#endif"]
    return L


def _adj_target(compiled, mid, conn) -> str:
    """Where the cotangent of an input wire accumulates: the source's wire
    cotangent, or for a feedback read the carry's (the old value's)."""
    src, sport = conn
    if compiled.plan_pos[src] >= compiled.plan_pos[mid]:
        return "d_" + _var(("fb", (src, sport)))
    return f"dw_{_ident(src)}[{sport}]"


def _zeros(n: int) -> str:
    return "{" + ", ".join(["0.0f"] * n) + "}"


def _generate_bwd(compiled, layout: Layout, lanes: tuple,
                  t_chunk: int) -> str:
    """The backward kernel of the fused VJP (K10), one thread per voice.

    It walks the chunks of ``t_chunk`` samples in reverse.  For each chunk
    it loads the chunk's checkpoint (``ck``, written by the "ckpt" mode)
    and replays the forward step with the emitted step code, storing the
    state before each sample to the scratch ``scr`` (``[t_chunk, S, V]``
    int32 words), so int phases, envelope modes and edge detectors replay
    bit for bit.  Then it sweeps the chunk backwards: at each sample it
    loads the stored state, re-runs the step to get every wire, and calls
    the modules' adjoints (``ModuleDef.cuda_adj``) in reverse plan order.
    The param cotangents accumulate in registers over the render; the state
    cotangents (the feedback carries' included) start from the final
    state's (``ctf``, ``[n_sf, V]``, entering at sample n-1) and end as
    the initial state's.  The audio cotangent ``cta`` is ``[V, C, n]``.
    Outputs: ``dpf`` (``[n_pf, V]``, the float params' rows) and ``dsf``
    (``[n_sf, V]``)."""
    plan = compiled.plan
    n_ch = compiled.cfg.channels
    lane_idx = {k: i for i, k in enumerate(lanes)}
    params_of, state_of = _args_of(layout)
    pleaf = {leaf.path: leaf for leaf in layout.params}
    sleaves = {}
    for leaf in layout.state:
        if leaf.path[0] == "states":
            sleaves.setdefault(leaf.path[1], []).append(leaf)
    L = _header(compiled, plan, lanes, "backward kernel of the fused VJP "
                "(K10)")
    L += [f"#define SRK_T_CHUNK {int(t_chunk)}",
          f"#define SRK_S_ROWS {layout.n_sf + layout.n_si}",
          '#include "modules_adj.cuh"',
          "",
          "SRK_HD void srk_voice_bwd(int v, int V, int n, "
          "const float* __restrict__ pf, const int* __restrict__ pi, "
          "const float* __restrict__ lanes, const int* __restrict__ ck, "
          "const float* __restrict__ cta, const float* __restrict__ ctf, "
          "int* __restrict__ scr, float* __restrict__ dpf, "
          "float* __restrict__ dsf) {",
          "  // params, loaded once"]
    L += [_load(leaf, "p" + leaf.kind, True) for leaf in layout.params]
    L.append("  // the float params' cotangents, summed over the render; an "
             "automated param's lane gets none (d_sink)")
    for leaf in layout.params:
        if leaf.kind == "f":
            var = "d_" + _var(leaf.path)
            L.append(f"  float {var}[{leaf.rows}] = {_zeros(leaf.rows)};"
                     if leaf.rest else f"  float {var} = 0.0f;")
    L.append("  float d_sink = 0.0f;")
    L.append("  // the float state's cotangents, from the final state's")
    for leaf in layout.state:
        if leaf.kind == "f":
            var = "d_" + _var(leaf.path)
            if leaf.rest:
                vals = ", ".join(_row("ctf", leaf, j)
                                 for j in range(leaf.rows))
                L.append(f"  float {var}[{leaf.rows}] = {{{vals}}};")
            else:
                L.append(f"  float {var} = {_row('ctf', leaf, 0)};")
    L.append("  // the state, replayed")
    for leaf in layout.state:
        var = _var(leaf.path)
        L.append(f"  {leaf.ctype} {var}[{leaf.rows}];" if leaf.rest
                 else f"  {leaf.ctype} {var};")
    L += [f"  const float* ct{c} = cta + ((size_t)v * {n_ch} + {c}) * "
          "(size_t)n;" for c in range(n_ch)]
    L += [
        "  const int n_chunks = (n + SRK_T_CHUNK - 1) / SRK_T_CHUNK;",
        "  for (int c = n_chunks - 1; c >= 0; --c) {",
        "    const int t0 = c * SRK_T_CHUNK;",
        "    const int t1 = t0 + SRK_T_CHUNK < n ? t0 + SRK_T_CHUNK : n;",
        "    {",
        "      const int* ckr = ck + (size_t)c * SRK_S_ROWS * V + v;",
    ]
    L += _state_row_loads(layout, "ckr")
    L += [
        "    }",
        "    // replay the chunk, storing the state before each sample",
        "    for (int t = t0; t < t1; ++t) {",
        "      int* sr = scr + (size_t)(t - t0) * SRK_S_ROWS * V + v;",
    ]
    L += _state_row_stores(layout, "sr")
    L += _lane_loads(lane_idx)
    L += _emit_calls(compiled, plan, lane_idx, params_of, state_of, None,
                     False, audio=False)
    L += _fb_updates(compiled)
    L += [
        "    }",
        "    // sweep it backwards",
        "    for (int t = t1 - 1; t >= t0; --t) {",
        "      const int* sr = scr + (size_t)(t - t0) * SRK_S_ROWS * V + v;",
    ]
    L += _state_row_loads(layout, "sr", prefix="o_", decl=True)
    for leaf in layout.state:
        var = _var(leaf.path)
        if leaf.rest:
            L += [f"      {var}[{j}] = o_{var}[{j}];" for j in range(leaf.rows)]
        else:
            L.append(f"      {var} = o_{var};")
    L += _lane_loads(lane_idx)
    L += _emit_calls(compiled, plan, lane_idx, params_of, state_of, None,
                     False, scoped=False, audio=False)
    L.append("    // the wires' cotangents; a feedback source's new carry "
             "takes the carried one")
    for mid in plan:
        if mid != compiled.output_id:
            mdef, statics, _ = compiled.instances[mid]
            n_out = max(mdef.num_outputs(compiled.cfg, statics), 1)
            L.append(f"    float dw_{_ident(mid)}[{n_out}] = "
                     f"{_zeros(n_out)};")
    for k in compiled.fb_keys:
        d = "d_" + _var(("fb", k))
        L.append(f"    dw_{_ident(k[0])}[{k[1]}] += {d}; {d} = 0.0f;")
    L.append("    // the adjoints, in reverse plan order")
    for mid in reversed(plan):
        mdef, statics, inputs = compiled.instances[mid]
        if mid == compiled.output_id:
            L += [f"    {mdef.cuda_adj}(ct{c}, t, "
                  f"{_adj_target(compiled, mid, c_)});"
                  for c, c_ in enumerate(inputs) if c_ is not None]
            continue
        ins, conn = _inputs_of(compiled, mid, None, False)
        tmpl = ", ".join([str(conn)] + _statics_args(statics))
        keys = params_of.get(mid, [])
        args = _param_args(compiled, mid, keys, lane_idx)
        args += ["o_" + var for var in state_of.get(mid, [])]
        if mid in lane_idx:
            args.append(_lane_var(mid))
        args.append(f"in_{_ident(mid)}" if ins else "nullptr")
        for key in keys:
            if pleaf[(mid, key)].kind == "f":
                auto = compiled._auto_key(mid, key) in lane_idx
                args.append("d_sink" if auto else "d_" + _var((mid, key)))
        args += ["d_" + _var(leaf.path) for leaf in sleaves.get(mid, [])
                 if leaf.kind == "f"]
        args.append(f"dw_{_ident(mid)}")
        call = f"{mdef.cuda_adj}<{tmpl}>("
        if ins:
            L.append(f"    {{ float din[{len(ins)}] = {_zeros(len(ins))};")
            L.append(f"      {call}" + ", ".join(args + ["din"]) + ");")
            L += [f"      {_adj_target(compiled, mid, c_)} += din[{i}];"
                  for i, c_ in enumerate(inputs) if c_ is not None]
            L.append("    }")
        else:
            L.append(f"    {call}" + ", ".join(args + ["nullptr"]) + ");")
    L += ["    }", "  }",
          "  // the float params' and the initial float state's cotangents"]
    for arr, leaves in (("dpf", layout.params), ("dsf", layout.state)):
        for leaf in leaves:
            if leaf.kind != "f":
                continue
            var = "d_" + _var(leaf.path)
            L += [f"  {_row(arr, leaf, j)} = "
                  + (f"{var}[{j}];" if leaf.rest else f"{var};")
                  for j in range(leaf.rows)]
    L.append("}")
    args = "pf, pi, lanes, ck, cta, ctf, scr, dpf, dsf"
    decl = ("const float* pf, const int* pi, const float* lanes, "
            "const int* ck, const float* cta, const float* ctf, int* scr, "
            "float* dpf, float* dsf, int V, int n")
    L += _entries("srk_vjp_bwd", "srk_voice_bwd", args, decl)
    return "\n".join(L) + "\n"


# -- K10's backward as a reverse pipeline of stage warps fed by replay warps --


@dataclasses.dataclass(frozen=True)
class BwdShape:
    """The shape of K10's split backward for one plan, partition, lane set
    and chunk: ``xwires`` the cross-stage forward wires the replay stores
    after the state row (scratch rows ``S + i``); per stage its scratch rows
    (``words``, its state leaves' rows then the wires it reads) and lanes;
    ``rings`` the cotangent hops ``(key, writer stage, reader stage)``
    (key: ``("p", wire)`` a partial sum, ``("c", wire, i)`` the i-th
    contribution to a feedback source's wire); ``replays`` the replay
    warps; ``smem`` the shared-memory offsets (floats)."""
    chunk: int
    replays: int
    xwires: tuple
    words: tuple
    lanes_of: tuple
    rings: tuple
    out_stage: object
    offsets: dict
    floats: int

    @property
    def nbytes(self) -> int:
        return 4 * self.floats

    @property
    def buffers(self) -> int:
        """Chunks of scratch in flight: the replay warps' plus two."""
        return self.replays + 2


def _consumers(compiled, plan):
    """Within-sample reads ``{(src, port): [(mid, input idx), ...]}`` in the
    one-thread backward's order of accumulation: consumers in reverse plan
    order, each one's inputs in port order."""
    out = {}
    for mid in reversed(plan):
        for i, c in enumerate(compiled.instances[mid][2]):
            if c is not None and compiled.plan_pos[c[0]] < \
                    compiled.plan_pos[mid]:
                out.setdefault(c, []).append((mid, i))
    return out


def bwd_replays(compiled, part) -> int:
    """Replay warps: two where one thread's forward step of the whole plan
    costs more than the costliest sweep stage, else one (a replay warp then
    replays half a chunk step's samples)."""
    fwd = sum(module_ops(compiled, m) for m in compiled.plan)
    return 2 if fwd > max(part.costs) else 1


def bwd_shape(compiled, part, lanes, layout, chunk, t_chunk) -> BwdShape:
    """The scratch rows, lanes, cotangent rings and shared memory of K10's
    split backward with sub-chunks of ``chunk`` samples."""
    stage_of = part.stage_of()
    G = part.n_stages
    xwires = tuple(w for w, _, _ in part.wires)
    s_rows = layout.n_sf + layout.n_si
    cons = _consumers(compiled, compiled.plan)
    words = []
    for g, mods in enumerate(part.stages):
        rows = []
        for leaf in layout.state:
            if _leaf_mid(leaf) in mods:
                base = leaf.row if leaf.kind == "f" else layout.n_sf + leaf.row
                rows += range(base, base + leaf.rows)
        rows += [s_rows + i for i, (w, a, _) in enumerate(part.wires)
                 if a < g and any(stage_of[mid] == g for mid, _ in
                                  cons.get(w, ()))]
        words.append(tuple(rows))
    lanes_of = stage_lanes(compiled, part, lanes, None, layout)
    rings = []
    for w, a, _ in part.wires:
        later = [(mid, i) for mid, i in cons[w] if stage_of[mid] > a]
        if w in compiled.fb_keys:
            rings += [(("c", w, j), stage_of[mid], a)
                      for j, (mid, _) in enumerate(later)]
        else:
            hops = sorted({stage_of[mid] for mid, _ in later}, reverse=True)
            rings += [(("p", w), b, c) for b, c in zip(hops, hops[1:] + [a])]
    out_stage = stage_of.get(compiled.output_id)
    off, offsets = 0, {}
    for g in range(G):
        offsets[("words", g)] = off
        off += 2 * chunk * len(words[g]) * WARP
        for k in lanes_of[g]:
            offsets[("lane", g, k)] = off
            off += 2 * chunk * WARP
    if out_stage is not None:
        offsets["cta"] = off
        off += 2 * compiled.cfg.channels * WARP * (chunk + 1)
    for key, b, c in rings:
        offsets[("ring", key, b)] = off
        off += (b - c + 1) * chunk * WARP
    return BwdShape(chunk, bwd_replays(compiled, part), xwires, tuple(words),
                    lanes_of, tuple(rings), out_stage, offsets, off)


def pick_bwd_chunk(compiled, part, lanes, layout, t_chunk):
    """The backward's sub-chunk: the largest power of two from ``CHUNK_MIN``
    to ``CHUNK_MAX`` that divides ``t_chunk`` into at least G sub-chunks
    (the replay's lead) and whose buffers and rings fit ``SMEM_BUDGET``;
    None if none does (the one-thread twin runs)."""
    chunk = CHUNK_MAX
    while chunk >= CHUNK_MIN:
        if (t_chunk % chunk == 0 and t_chunk // chunk >= part.n_stages
                and bwd_shape(compiled, part, lanes, layout, chunk,
                              t_chunk).nbytes <= SMEM_BUDGET):
            return chunk
        chunk //= 2
    return None


def _generate_bwd_pipeline(compiled, layout: Layout, lanes: tuple,
                           t_chunk: int, part, chunk) -> str:
    """K10's backward for a plan cut into ``part.n_stages`` sweep stages
    (``partition(..., cost=sweep_ops)``), fed by replay warps.

    One CTA holds 32 voices, one warp per sweep stage and ``R``
    (:func:`bwd_replays`) replay warps.  Time goes in sub-chunks of
    ``chunk`` = T samples, in lock step ending in a named barrier.  Chunks
    of ``t_chunk`` samples (the checkpoints' spacing) are taken last first;
    chunk ``q`` of that order holds sub-chunk steps ``[q m, q m + m)``,
    ``m = t_chunk / T`` (the last chunk in time padded at its end, so
    every chunk holds ``m``).

    * Replay warp ``j`` replays the chunks ``q = j (mod R)``: chunk ``q``
      from its checkpoint ``ck`` during steps ``[q m, q m + R m)``, T / R
      samples a step, with the forward's step code; it stores the state
      before each sample and every cross-stage forward wire into the
      scratch ``scr`` (``[R + 2, t_chunk, W, V]`` int32 words, W = S plus
      the wires; chunk ``c`` in buffer ``c % (R + 2)``).
    * Sweep stage ``g`` runs reverse sub-chunk step ``r`` at step ``r + D +
      G - 1 - g`` (``D = R m + 1``): the output stage leads.  It prefetches
      the next sub-chunk's scratch rows (its state and the wires it reads),
      its lanes and, for the Output's stage, the audio cotangent into
      shared double buffers (``cp.async``); then, sample by sample in
      reverse, it re-runs its modules' steps and calls their adjoints in
      reverse plan order.  The partial cotangent of a wire from an earlier
      stage goes down a shared ring to the next earlier stage that reads
      it, or to its source's; a feedback source's wire sends each of its
      later readers' contributions on its own ring, since the one-thread
      kernel adds the carried cotangent first.
    * Replay leads by ``D``: a chunk is replayed a step before its first
      sub-chunk is fetched, and ``R + 2`` buffers keep it until stage 0
      has read it (``m >= G``, :func:`pick_bwd_chunk`).

    Every float cotangent takes the one-thread kernel's operations in its
    order, so the two agree bit for bit.  The host build
    (``srk_vjp_bwd_host``) runs the same lock step, the stages before the
    replay within a step, through the same buffers."""
    plan = compiled.plan
    cfg = compiled.cfg
    n_ch = cfg.channels
    G = part.n_stages
    sh = bwd_shape(compiled, part, lanes, layout, chunk, t_chunk)
    R = sh.replays
    if t_chunk % chunk or t_chunk // chunk < G or chunk % R:
        raise ValueError(f"sub-chunks of {chunk} samples do not divide "
                         f"t_chunk {t_chunk} into at least {G}")
    if sh.nbytes > SMEM_BUDGET:
        raise ValueError(f"the backward's {G} stages take {sh.nbytes} bytes "
                         f"of shared memory, over {SMEM_BUDGET}")
    lane_idx = {k: i for i, k in enumerate(lanes)}
    params_of, state_of = _args_of(layout)
    stage_of = part.stage_of()
    if set(stage_of) != set(plan):
        raise ValueError("the partition does not cover the plan")
    s_rows = layout.n_sf + layout.n_si
    xrow = {w: s_rows + i for i, w in enumerate(sh.xwires)}
    xfrom = {w: a for w, a, _ in part.wires}
    pleaf = {leaf.path: leaf for leaf in layout.params}
    L = _header(compiled, plan, lanes, "backward kernel of the fused VJP "
                f"(K10), {G} sweep stages and {R} replay warps")
    L += [f"// Stage {g}: " + ", ".join(mods) + f" ({part.costs[g]} ops)."
          for g, mods in enumerate(part.stages)]
    L += [f"#define SRK_STAGES {G}",
          f"#define SRK_REPLAYS {R}",
          f"#define SRK_THREADS {WARP * (G + R)}",
          f"#define SRK_T {chunk}",
          f"#define SRK_T_CHUNK {int(t_chunk)}",
          f"#define SRK_M {int(t_chunk) // chunk}",
          f"#define SRK_D {R * (int(t_chunk) // chunk) + 1}",
          f"#define SRK_NB {sh.buffers}",
          f"#define SRK_S_ROWS {s_rows}",
          f"#define SRK_W_ROWS {s_rows + len(sh.xwires)}",
          f"#define SRK_SMEM_FLOATS {sh.floats}",
          '#include "modules_adj.cuh"',
          '#include "pipeline.cuh"',
          "",
          "// does reverse sub-chunk step r hold samples?",
          "SRK_HD bool srk_sub_live(int r, int n, int n_chunks) {",
          "  return r >= 0 && r < n_chunks * SRK_M"
          " && (n_chunks * SRK_M - 1 - r) * SRK_T < n;",
          "}",
          "",
          "// the scratch word of row w for sample row `row` of buffer b",
          "#define SRK_SCR(b, row, w) ((((size_t)(b) * SRK_T_CHUNK + (row)) "
          "* SRK_W_ROWS + (w)) * V + v)"]
    ptrs = ("const float* __restrict__ lanes, const int* __restrict__ ck, "
            "const float* __restrict__ cta, int* __restrict__ scr, "
            "float* __restrict__ sm")
    # -- the replay warps: the whole plan, one thread per voice ------------
    members, loads = [], []
    for leaf in layout.params + layout.state:
        arr = ("p" if leaf in layout.params else "s") + leaf.kind
        member, load = _struct_leaf(leaf, arr)
        members.append(member)
        if leaf in layout.params:
            loads += load
    L += ["", "struct srk_rp {"] + members + ["};", "",
          "SRK_HD void srk_rp_load(srk_rp& S, int v, int V, "
          "const float* __restrict__ pf, const int* __restrict__ pi) {"]
    L += loads + ["}", "",
                  "// replay warp j at step k: T / R samples of its chunk",
                  "SRK_HD void srk_rp_step(srk_rp& S, int k, int j, int v, "
                  f"int V, int n, int n_chunks, {ptrs}) {{"]
    for leaf in layout.params + layout.state:
        var = _var(leaf.path)
        q = "const auto&" if leaf in layout.params else "auto&"
        L.append(f"  {q} {var} = S.{var};")
    L += ["  const int qk = k / SRK_M;",
          "  const int q = qk - ((qk - j) % SRK_REPLAYS + SRK_REPLAYS) "
          "% SRK_REPLAYS;",
          "  if (q < 0 || q >= n_chunks) return;",
          "  const int u = k - q * SRK_M;    // in [0, R m)",
          "  const int c = n_chunks - 1 - q;",
          "  const int t0 = c * SRK_T_CHUNK;",
          "  const int b = c % SRK_NB;",
          "  if (u == 0) {  // the chunk's checkpoint",
          "    const int* ckr = ck + (size_t)c * SRK_S_ROWS * V + v;"]
    L += ["  " + x for x in _state_row_loads(layout, "ckr")]
    L += ["  }",
          "  const int r0 = u * (SRK_T / SRK_REPLAYS);",
          "  for (int i = 0; i < SRK_T / SRK_REPLAYS; ++i) {",
          "    const int row = r0 + i, t = t0 + row;",
          "    if (t >= n) break;",
          "    int* sr = scr + SRK_SCR(b, row, 0);",
          "    (void)sr;"]
    L += ["  " + x for x in _state_row_stores(layout, "sr")]
    L += _lane_loads(lane_idx)
    L += _emit_calls(compiled, plan, lane_idx, params_of, state_of, None,
                     False, audio=False)
    L += _fb_updates(compiled)
    L += [f"    scr[SRK_SCR(b, row, {xrow[w]})] = "
          f"srk_float_bits(w_{_ident(w[0])}[{w[1]}]);" for w in sh.xwires]
    L += ["  }", "}"]
    # -- the sweep stages ----------------------------------------------------
    cons = _consumers(compiled, plan)
    ring_of = {(key, b): (c, sh.offsets[("ring", key, b)])
               for key, b, c in sh.rings}
    ring_into = {}
    for key, b, c in sh.rings:
        ring_into.setdefault(c, []).append((key, b))
    for g, mods in enumerate(part.stages):
        mods = list(mods)
        pls = [leaf for leaf in layout.params if _leaf_mid(leaf) in mods]
        sls = [leaf for leaf in layout.state if _leaf_mid(leaf) in mods]
        members, loads, stores = [], [], []
        for leaf in pls:
            member, load = _struct_leaf(leaf, "p" + leaf.kind)
            members.append(member)
            loads += load
        for leaf in pls + sls:
            if leaf.kind != "f":
                continue
            var = "d_" + _var(leaf.path)
            arr = "ctf" if leaf in sls else None
            members.append(f"  float {var}[{leaf.rows}];" if leaf.rest
                           else f"  float {var};")
            for j in range(leaf.rows):
                lhs = f"S.{var}[{j}]" if leaf.rest else f"S.{var}"
                loads.append(f"  {lhs} = "
                             + (_row(arr, leaf, j) if arr else "0.0f") + ";")
                stores.append(f"  {_row('dsf' if arr else 'dpf', leaf, j)} "
                              f"= {lhs};")
        members.append("  float d_sink;")
        loads.append("  S.d_sink = 0.0f;")
        words = sh.words[g]
        nw = len(words)
        wpos = {w: i for i, w in enumerate(words)}
        L += ["", f"struct srk_bg{g} {{"] + members + ["};", "",
              f"SRK_HD void srk_bg{g}_load(srk_bg{g}& S, int v, int V, "
              "const float* __restrict__ pf, const int* __restrict__ pi, "
              "const float* __restrict__ ctf) {"]
        L += loads + ["}", "",
                      f"SRK_HD void srk_bg{g}_store(const srk_bg{g}& S, "
                      "int v, int V, float* __restrict__ dpf, "
                      "float* __restrict__ dsf) {"]
        L += stores + ["}"]
        # the prefetch of reverse sub-chunk r: scratch rows, lanes, cta
        woff = sh.offsets[("words", g)]
        L += ["",
              f"SRK_HD void srk_bg{g}_fetch(int r, int lane, int v, int V, "
              f"int n, int n_chunks, {ptrs}) {{",
              "  if (!srk_sub_live(r, n, n_chunks)) return;",
              "  const int s = n_chunks * SRK_M - 1 - r;",
              "  const int t0 = s * SRK_T;",
              "  const int cnt = n - t0 < SRK_T ? n - t0 : SRK_T;",
              "  const int c = s / SRK_M, row0 = (s % SRK_M) * SRK_T;",
              "  const int b = c % SRK_NB;",
              "  (void)b; (void)row0;",
              "  for (int tc = 0; tc < cnt; ++tc) {"]
        if nw:
            L += [f"    float* dst = sm + {woff} + ((r & 1) * SRK_T + tc) * "
                  f"{nw * WARP} + lane;",
                  "    const int* src = scr + SRK_SCR(b, row0 + tc, 0);"]
            L += [f"    srk_cp_async4(dst + {i * WARP}, (const float*)(src "
                  f"+ {w} * (size_t)V));" for i, w in enumerate(words)]
        L += [f"    srk_cp_async4(sm + {sh.offsets[('lane', g, k)]} + "
              "((r & 1) * SRK_T + tc) * 32 + lane, lanes + "
              f"((size_t){lane_idx[k]} * n + t0 + tc) * V + v);"
              for k in sh.lanes_of[g]]
        if g == sh.out_stage:
            L += [f"    srk_cp_async4(sm + {sh.offsets['cta']} + ((r & 1) * "
                  f"{n_ch} * 32 + {c} * 32 + lane) * (SRK_T + 1) + tc, "
                  f"cta + ((size_t)v * {n_ch} + {c}) * n + t0 + tc);"
                  for c in range(n_ch)]
        L += ["  }", "}"]
        # one reverse sub-chunk
        L += ["",
              f"SRK_HD void srk_bg{g}_sub(srk_bg{g}& S, int r, int lane, "
              f"int v, int V, int n, int n_chunks, {ptrs}) {{"]
        for leaf in pls:
            L.append(f"  const auto& {_var(leaf.path)} = S.{_var(leaf.path)};")
        for leaf in pls + sls:
            if leaf.kind == "f":
                var = "d_" + _var(leaf.path)
                L.append(f"  auto& {var} = S.{var};")
        L += ["  auto& d_sink = S.d_sink;",
              "  const int s = n_chunks * SRK_M - 1 - r;",
              "  const int t0 = s * SRK_T;",
              "  const int cnt = n - t0 < SRK_T ? n - t0 : SRK_T;"]
        for leaf in sls:
            var = _var(leaf.path)
            L.append(f"  {leaf.ctype} {var}[{leaf.rows}];" if leaf.rest
                     else f"  {leaf.ctype} {var};")
        if g == sh.out_stage:
            L += [f"  const float* ctp{c} = sm + {sh.offsets['cta']} + ((r & 1)"
                  f" * {n_ch} * 32 + {c} * 32 + lane) * (SRK_T + 1);"
                  for c in range(n_ch)]
        L += ["  for (int tc = cnt - 1; tc >= 0; --tc) {",
              "    const int t = t0 + tc;",
              "    (void)t;"]
        if nw:
            L.append(f"    const int wb = {woff} + ((r & 1) * SRK_T + tc) * "
                     f"{nw * WARP} + lane;")
        # the state before the sample, then its locals
        for leaf in sls:
            var = _var(leaf.path)
            base = leaf.row if leaf.kind == "f" else layout.n_sf + leaf.row
            vals = []
            for j in range(leaf.rows):
                at = f"wb + {wpos[base + j] * WARP}"
                vals.append(f"sm[{at}]" if leaf.kind == "f"
                            else f"srk_ld_word(sm + {at})")
            if leaf.rest:
                L.append(f"    const {leaf.ctype} o_{var}[{leaf.rows}] = "
                         f"{{{', '.join(vals)}}};")
                L += [f"    {var}[{j}] = o_{var}[{j}];"
                      for j in range(leaf.rows)]
            else:
                L += [f"    const {leaf.ctype} o_{var} = {vals[0]};",
                      f"    {var} = o_{var};"]
        L += [f"    const float {_lane_var(k)} = sm[{sh.offsets[('lane', g, k)]}"
              " + ((r & 1) * SRK_T + tc) * 32 + lane];"
              for k in sh.lanes_of[g]]
        ins = {}
        for mid in mods:
            for c in compiled.instances[mid][2]:
                if (c is not None and stage_of[c[0]] != g
                        and compiled.plan_pos[c[0]] < compiled.plan_pos[mid]):
                    ins.setdefault(c[0], set()).add(c[1])
        for src, ports in ins.items():
            mdef, statics, _ = compiled.instances[src]
            n_out = max(mdef.num_outputs(cfg, statics), 1)
            L.append(f"    float w_{_ident(src)}[{n_out}];")
            L += [f"    w_{_ident(src)}[{p}] = sm[wb + "
                  f"{wpos[xrow[(src, p)]] * WARP}];" for p in sorted(ports)]
        L += _emit_calls(compiled, mods, lane_idx, params_of, state_of, None,
                         False, scoped=False, audio=False)
        L.append("    // the wires' cotangents")
        for mid in mods:
            if mid != compiled.output_id:
                mdef, statics, _ = compiled.instances[mid]
                n_out = max(mdef.num_outputs(cfg, statics), 1)
                L.append(f"    float dw_{_ident(mid)}[{n_out}] = "
                         f"{_zeros(n_out)};")
        for k in compiled.fb_keys:
            if stage_of[k[0]] == g:
                d = "d_" + _var(("fb", k))
                L.append(f"    dw_{_ident(k[0])}[{k[1]}] += {d}; {d} = 0.0f;")

        def ring_at(key, b, r="r"):
            c, off = ring_of[(key, b)]
            return (f"sm[{off} + ({r} % {b - c + 1}) * SRK_T * 32 + tc * 32 "
                    "+ lane]")
        # cotangents arriving from later stages, in the one-thread order
        for key, b in sorted(ring_into.get(g, ()),
                             key=lambda kb: (kb[0][1], kb[0][2:])):
            w = key[1]
            if xfrom[w] == g:
                if key[0] == "p":
                    L.append(f"    dw_{_ident(w[0])}[{w[1]}] = "
                             f"{ring_at(key, b)};")
                else:
                    L.append(f"    dw_{_ident(w[0])}[{w[1]}] += "
                             f"{ring_at(key, b)};")
        # partial sums of wires from earlier stages read here
        targets = {}
        for w, a, _ in part.wires:
            if a >= g or w in compiled.fb_keys:
                continue
            readers = [mid for mid, _ in cons[w] if stage_of[mid] == g]
            if not readers:
                continue
            var = f"dx_{_ident(*w)}"
            inflow = [b for key, b in ring_into.get(g, ())
                      if key == ("p", w)]
            L.append(f"    float {var} = "
                     + (ring_at(("p", w), inflow[0]) if inflow else "0.0f")
                     + ";")
            targets[w] = var
        contrib = {}
        for w, a, _ in part.wires:
            if w in compiled.fb_keys and a < g:
                later = [(mid, i) for mid, i in cons[w] if stage_of[mid] > a]
                for j, (mid, i) in enumerate(later):
                    if stage_of[mid] == g:
                        contrib[(mid, i)] = ("c", w, j)

        def target(mid, i, conn):
            src, sport = conn
            if (mid, i) in contrib:
                key = contrib[(mid, i)]
                return f"dc_{_ident(*key[1])}_{key[2]}"
            if compiled.plan_pos[src] >= compiled.plan_pos[mid]:
                return "d_" + _var(("fb", (src, sport)))
            if stage_of[src] != g:
                return targets[conn]
            return f"dw_{_ident(src)}[{sport}]"
        for key in contrib.values():
            L.append(f"    float dc_{_ident(*key[1])}_{key[2]} = 0.0f;")
        L.append("    // the adjoints, in reverse plan order")
        for mid in reversed(mods):
            mdef, statics, inputs = compiled.instances[mid]
            if mid == compiled.output_id:
                L += [f"    {mdef.cuda_adj}(ctp{c}, tc, "
                      f"{target(mid, c, c_)});"
                      for c, c_ in enumerate(inputs) if c_ is not None]
                continue
            ins_, conn = _inputs_of(compiled, mid, None, False)
            tmpl = ", ".join([str(conn)] + _statics_args(statics))
            keys = params_of.get(mid, [])
            args = _param_args(compiled, mid, keys, lane_idx)
            args += ["o_" + var for var in state_of.get(mid, [])]
            if mid in lane_idx:
                args.append(_lane_var(mid))
            args.append(f"in_{_ident(mid)}" if ins_ else "nullptr")
            for key in keys:
                if pleaf[(mid, key)].kind == "f":
                    auto = compiled._auto_key(mid, key) in lane_idx
                    args.append("d_sink" if auto else "d_" + _var((mid, key)))
            args += ["d_" + _var(leaf.path) for leaf in sls
                     if leaf.path[0] == "states" and leaf.path[1] == mid
                     and leaf.kind == "f"]
            args.append(f"dw_{_ident(mid)}")
            call = f"{mdef.cuda_adj}<{tmpl}>("
            if ins_:
                L.append(f"    {{ float din[{len(ins_)}] = "
                         f"{_zeros(len(ins_))};")
                L.append(f"      {call}" + ", ".join(args + ["din"]) + ");")
                L += [f"      {target(mid, i, c_)} += din[{i}];"
                      for i, c_ in enumerate(inputs) if c_ is not None]
                L.append("    }")
            else:
                L.append(f"    {call}" + ", ".join(args + ["nullptr"]) + ");")
        # hand the partial sums and contributions on
        for (key, b), (c, _) in ring_of.items():
            if b != g:
                continue
            val = (targets[key[1]] if key[0] == "p"
                   else f"dc_{_ident(*key[1])}_{key[2]}")
            L.append(f"    {ring_at(key, b)} = {val};")
        L += ["  }", "}"]
    L += _bwd_pipeline_entries(part, R)
    return "\n".join(L) + "\n"


def _bwd_pipeline_entries(part, R) -> list:
    """The split backward kernel (a warp per sweep stage, then the replay
    warps), its launch (which sets the dynamic shared memory) and the host
    build's lock step, with the one-thread backward's arguments."""
    decl = ("const float* pf, const int* pi, const float* lanes, "
            "const int* ck, const float* cta, const float* ctf, int* scr, "
            "float* dpf, float* dsf, int V, int n")
    args = "pf, pi, lanes, ck, cta, ctf, scr, dpf, dsf, V, n"
    tail = "v, V, n, n_chunks, lanes, ck, cta, scr, sm"
    G = part.n_stages
    L = ["", "#ifdef __CUDACC__",
         "__global__ void __launch_bounds__(SRK_THREADS) "
         f"srk_vjp_bwd_kernel({decl}) {{",
         "  extern __shared__ float sm[];",
         "  const int w = threadIdx.x >> 5;",
         "  const int lane = threadIdx.x & 31;",
         "  const int v = blockIdx.x * 32 + lane;",
         "  const bool live = v < V;",
         "  const int n_chunks = (n + SRK_T_CHUNK - 1) / SRK_T_CHUNK;",
         "  const int steps = n_chunks > 0 ? n_chunks * SRK_M + SRK_D + "
         "SRK_STAGES - 1 : 0;",
         "  if (w >= SRK_STAGES) {",
         "    srk_rp S;",
         "    if (live) srk_rp_load(S, v, V, pf, pi);",
         "    for (int k = 0; k < steps; ++k) {",
         f"      if (live) srk_rp_step(S, k, w - SRK_STAGES, {tail});",
         "      srk_step_barrier(SRK_THREADS);",
         "    }"]
    for g in range(G):
        lead = f"SRK_D + {G - 1 - g}"
        L += [f"  }} else if (w == {g}) {{",
              f"    srk_bg{g} S;",
              f"    if (live) srk_bg{g}_load(S, v, V, pf, pi, ctf);",
              "    for (int k = 0; k < steps; ++k) {",
              f"      const int r = k - ({lead});",
              "      if (live) {",
              f"        srk_bg{g}_fetch(r + 1, lane, {tail});",
              "        srk_cp_commit();",
              "        if (srk_sub_live(r, n, n_chunks)) {",
              "          srk_cp_wait1();",
              f"          srk_bg{g}_sub(S, r, lane, {tail});",
              "        }",
              "      }",
              "      srk_step_barrier(SRK_THREADS);",
              "    }",
              f"    if (live) srk_bg{g}_store(S, v, V, dpf, dsf);"]
    L += ["  }", "}", "",
          f'extern "C" int srk_vjp_bwd_launch({decl}, void* stream) {{',
          "  const int blocks = (V + 31) / 32;",
          "  const int bytes = SRK_SMEM_FLOATS * (int)sizeof(float);",
          "  cudaError_t err = cudaFuncSetAttribute(srk_vjp_bwd_kernel, "
          "cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);",
          "  if (err != cudaSuccess) return (int)err;",
          "  srk_vjp_bwd_kernel<<<blocks, SRK_THREADS, bytes, "
          f"(cudaStream_t)stream>>>({args});",
          "  return (int)cudaGetLastError();",
          "}",
          "#else",
          "#include <vector>",
          "",
          f'extern "C" int srk_vjp_bwd_host({decl}) {{',
          "  std::vector<float> smem(SRK_SMEM_FLOATS);",
          "  float* sm = smem.data();",
          "  const int n_chunks = (n + SRK_T_CHUNK - 1) / SRK_T_CHUNK;",
          "  const int steps = n_chunks > 0 ? n_chunks * SRK_M + SRK_D + "
          "SRK_STAGES - 1 : 0;",
          "  for (int v0 = 0; v0 < V; v0 += 32) {",
          "    const int live = V - v0 < 32 ? V - v0 : 32;",
          "    std::vector<srk_rp> P(32 * SRK_REPLAYS);"]
    L += [f"    std::vector<srk_bg{g}> S{g}(32);" for g in range(G)]
    L += ["    for (int lane = 0; lane < live; ++lane) {",
          "      const int v = v0 + lane;",
          "      for (int j = 0; j < SRK_REPLAYS; ++j) "
          "srk_rp_load(P[32 * j + lane], v, V, pf, pi);"]
    L += [f"      srk_bg{g}_load(S{g}[lane], v, V, pf, pi, ctf);"
          for g in range(G)]
    L += ["    }",
          "    // the card's lock step; within a step the stages, then the "
          "replay",
          "    for (int k = 0; k < steps; ++k) {"]
    for g in range(G):
        L += [f"      {{ const int r = k - (SRK_D + {G - 1 - g});",
              "        for (int lane = 0; lane < live; ++lane) {",
              "          const int v = v0 + lane;",
              f"          srk_bg{g}_fetch(r + 1, lane, {tail});",
              "          if (srk_sub_live(r, n, n_chunks))",
              f"            srk_bg{g}_sub(S{g}[lane], r, lane, {tail});",
              "        } }"]
    L += ["      for (int j = 0; j < SRK_REPLAYS; ++j)",
          "        for (int lane = 0; lane < live; ++lane) {",
          "          const int v = v0 + lane;",
          f"          srk_rp_step(P[32 * j + lane], k, j, {tail});",
          "        }",
          "    }",
          "    for (int lane = 0; lane < live; ++lane) {",
          "      const int v = v0 + lane;"]
    L += [f"      srk_bg{g}_store(S{g}[lane], v, V, dpf, dsf);"
          for g in range(G)]
    L += ["    }", "  }", "  return 0;", "}", "#endif"]
    return L


# the entry's argument types, without the stream: the nine operand
# pointers of :meth:`FusedKernel._launch`, then V and n; a layout with f64
# leaves adds its double rows pd, sd and sd_out after the nine
ARGTYPES = [P] * 9 + [I, I]
ARGTYPES_F64 = [P] * 12 + [I, I]


def _pack_rows(leaves, kinds: dict, tree_get, v: int, device) -> dict:
    """Pack the leaves ``[V, *rest]`` of each kind in ``kinds`` (``{kind:
    (rows, dtype)}``) into ``[rows, V]`` arrays of that dtype (bool as
    int32), never empty (one dummy row)."""
    out = {k: torch.zeros((max(rows, 1), v), dtype=dt, device=device)
           for k, (rows, dt) in kinds.items()}
    for leaf in leaves:
        if leaf.kind not in out:
            continue
        t = tree_get(leaf.path)
        if tuple(t.shape) != (v,) + leaf.rest:
            raise ValueError(f"{leaf.path}: expected shape "
                             f"{(v,) + leaf.rest}, got {tuple(t.shape)}")
        if t.dtype != leaf.dtype:
            raise TypeError(f"{leaf.path}: expected {leaf.dtype}, got "
                            f"{t.dtype}")
        if t.device != torch.device(device):
            raise ValueError(f"{leaf.path} lies on {t.device}, not {device}")
        out[leaf.kind][leaf.row:leaf.row + leaf.rows] = \
            t.reshape(v, leaf.rows).T
    return out


def pack(leaves, n_f, n_i, tree_get, v: int, device):
    """Pack leaves ``[V, *rest]`` into ``[n_f, V]`` f32 and ``[n_i, V]`` i32
    rows (bool as int32).  Arrays are never empty (one dummy row).  f64
    leaves are left to :func:`pack_doubles`."""
    rows = _pack_rows(leaves, {"f": (n_f, torch.float32),
                               "i": (n_i, torch.int32)}, tree_get, v, device)
    return rows["f"], rows["i"]


def pack_doubles(leaves, n_d, tree_get, v: int, device) -> torch.Tensor:
    """The f64 leaves among ``leaves`` as ``[n_d, V]`` double rows."""
    return _pack_rows(leaves, {"d": (n_d, torch.float64)}, tree_get, v,
                      device)["d"]


def unpack(leaves, sf, si, v: int, sd=None) -> dict:
    """Inverse of :func:`pack` (and of :func:`pack_doubles` for the rows
    ``sd``): ``{path: tensor [V, *rest]}``."""
    out = {}
    for leaf in leaves:
        src = {"f": sf, "i": si, "d": sd}[leaf.kind]
        t = src[leaf.row:leaf.row + leaf.rows].T.reshape((v,) + leaf.rest)
        out[leaf.path] = (t != 0) if leaf.dtype == torch.bool else \
            t.contiguous()
    return out


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def state_tree(compiled, flat: dict) -> dict:
    states = {mid: {} for mid in compiled.instances}
    fb = {}
    for path, t in flat.items():
        if path[0] == "states":
            states[path[1]][path[2]] = t
        else:
            fb[path[1]] = t
    return {"states": states, "fb": fb}


def pack_lanes(lanes, xs: dict, v: int, n: int, device) -> torch.Tensor:
    """The render's lanes ``{key: [V, n]}`` as one ``[L, n, V]`` f32 array
    in the kernel's lane order (one dummy element when there are none)."""
    if set(xs) != set(lanes):
        raise ValueError(f"the kernel was generated for lanes "
                         f"{sorted(lanes)}, the render has {sorted(xs)}")
    if not lanes:
        return torch.zeros((1,), dtype=CV_DTYPE, device=device)
    for k in lanes:
        a = xs[k]
        if tuple(a.shape) != (v, n) or a.device != torch.device(device):
            raise ValueError(f"lane {k}: expected [{v}, {n}] on {device}, "
                             f"got {tuple(a.shape)} on {a.device}")
    return torch.stack([xs[k].to(CV_DTYPE) for k in lanes]).transpose(
        1, 2).contiguous()


def pack_ring(compiled, state: dict, v: int, device) -> torch.Tensor:
    """K2's fb ring: ``state["fb"][k]`` (``[V, block]``) stacked and
    transposed into ``[n_fb, block, V]`` (one dummy element when the plan
    has no feedback)."""
    block = compiled.cfg.block_size
    if not compiled.fb_keys:
        return torch.zeros((1,), dtype=CV_DTYPE, device=device)
    for k in compiled.fb_keys:
        a = state["fb"][k]
        if tuple(a.shape) != (v, block) or a.device != torch.device(device):
            raise ValueError(f"fb {k}: expected [{v}, {block}] on {device}, "
                             f"got {tuple(a.shape)} on {a.device}")
    ring = torch.stack([state["fb"][k].to(CV_DTYPE)
                        for k in compiled.fb_keys])
    return ring.transpose(1, 2).contiguous()


def unpack_ring(compiled, ring: torch.Tensor) -> dict:
    """Inverse of :func:`pack_ring`: ``{k: [V, block]}``."""
    return {k: ring[i].T.contiguous()
            for i, k in enumerate(compiled.fb_keys)}


class FusedKernel(CudaLib):
    """The fused kernel of one compiled plan and lane set: its generated
    source, its build, its launch wrapper and a count of launches: K1's
    counterpart (``fused_voice``), or in buffer-feedback mode K2's
    (``fused_voice_buffer``).  Its plan is cut into at most ``stages``
    pipeline stages (``ops/partition.py``; K2's plan has no carried cycle,
    so any cut is free): a CTA of ``32 * G`` threads, one stage warp each,
    per 32 voices, with chunks of ``chunk`` samples (:func:`pick_chunk` by
    default, for K2 at most :func:`ring_chunk_limit`).  ``stages=1`` builds
    the one-thread form, the twin the card's A/B phase compares."""

    plain = "engine='scan'"  # what the CPU runs instead

    def __init__(self, compiled, lanes=(), stages: int = MAX_STAGES,
                 chunk: int = None, group: int = None):
        if not eligible(compiled):
            raise ValueError(
                "patch not eligible for the fused kernel (needs fast "
                "precision, no probes, and module types with a CUDA "
                "device function)")
        self.compiled = compiled
        self.lanes = tuple(sorted(lanes))
        self.buffer = compiled.cfg.buffer_feedback
        self.layout = Layout.of(compiled)
        self.partition = partition(compiled, carried=not self.buffer,
                                   max_stages=stages)
        self._pipeline(None, chunk, group)
        super().__init__(
            "fused_voice_buffer" if self.buffer else "fused_voice",
            generate_source(compiled, self.layout, self.lanes,
                            split=self.partition, chunk=self.chunk,
                            group=self.group),
            "fused kernel")

    def _pipeline(self, stage, chunk, group) -> None:
        """The chunk length, the samples of a stage warp's group and the
        shared-memory bytes of a split kernel (None, None and 0 for the
        one-thread form, which a plan takes when no chunk of its stages
        fits the shared-memory budget or, for K2, the feedback ring's
        block)."""
        part = self.partition
        self.chunk, self.group, self.smem_bytes = None, None, 0
        if part.n_stages > 1:
            lanes_of, n_tile, rings, limit = split_needs(
                self.compiled, part, self.lanes, stage, self.layout)
            self.chunk = chunk or pick_chunk(part, lanes_of, n_tile, limit,
                                             rings)
            if self.chunk is None:
                self.partition = one_stage(
                    self.compiled, [m for mods in part.stages for m in mods])
                return
            self.group = group or pick_group(self.chunk, part,
                                                self.layout)
            self.smem_bytes = smem_layout(part, lanes_of, n_tile,
                                          self.chunk, rings).nbytes

    @property
    def warps(self) -> int:
        """Warps per CTA as the generated source launches them
        (``SRK_THREADS``): one per stage and K1's (K2's) store warp; 1 for
        the one-thread form (one warp of voices)."""
        found = re.search(r"^#define SRK_THREADS (\d+)$", self.source, re.M)
        return int(found.group(1)) // WARP if found else 1

    @property
    def threads(self) -> int:
        """Threads per CTA."""
        return WARP * self.warps

    @property
    def ring_words(self) -> int:
        """K2's feedback ring, in words a voice: a block of each feedback
        key; 0 outside buffer mode."""
        if not self.buffer:
            return 0
        return len(self.compiled.fb_keys) * self.compiled.cfg.block_size

    def pack(self, params: dict, state: dict, n: int, xs: dict):
        """The kernel's f32 and i32 operands for one render on ``params``'
        device: ``(pf, pi, sf, si, lanes, ring, v)``."""
        return self.operands(params, state, n, xs)[:7]

    def operands(self, params: dict, state: dict, n: int, xs: dict):
        """:meth:`pack`'s operands and the double rows ``(pd, sd)`` of a
        layout with f64 leaves (exact precision; None without them)."""
        compiled = self.compiled
        leaves = tree_leaves(params) + tree_leaves(state)
        if not leaves:
            raise ValueError("no param or state leaf gives the voice count")
        device = leaves[0].device
        v = leaves[0].shape[0]
        if v < 1:
            raise ValueError("the fused kernel needs at least one voice")
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        if self.buffer and n % compiled.cfg.block_size:
            raise ValueError(
                f"buffer_feedback mode renders whole blocks: n={n} is not a "
                f"multiple of block_size={compiled.cfg.block_size}")
        lay = self.layout
        derived = compiled.derived_params(params)
        pf, pi = pack(lay.params, lay.n_pf, lay.n_pi,
                      lambda p: _get(derived, p), v, device)
        sf, si = pack(lay.state, lay.n_sf, lay.n_si,
                      lambda p: _get(state, p), v, device)
        pd = sd = None
        if lay.doubles:
            pd = pack_doubles(lay.params, lay.n_pd,
                              lambda p: _get(derived, p), v, device)
            sd = pack_doubles(lay.state, lay.n_sd,
                              lambda p: _get(state, p), v, device)
        lanes = pack_lanes(self.lanes, xs, v, n, device)
        if self.buffer:
            with span("srk.ring"):
                ring = pack_ring(compiled, state, v, device)
        else:
            ring = torch.zeros((1,), dtype=CV_DTYPE, device=device)
        return pf, pi, sf, si, lanes, ring, v, pd, sd

    def finish(self, sf_out, si_out, ring, v: int, sd_out=None) -> dict:
        """The final state tree from the kernel's outputs (``sd_out``: the
        double rows of a layout with f64 leaves)."""
        with span("srk.finish"):
            final = state_tree(self.compiled,
                               unpack(self.layout.state, sf_out, si_out, v,
                                      sd_out))
            if self.buffer:
                with span("srk.ring"):
                    final["fb"] = unpack_ring(self.compiled, ring)
            return final

    def _launch(self, params: dict, state: dict, n: int, xs: dict,
                out_shape):
        """One launch on CUDA tensors: the packed operands, an output of
        ``out_shape(V)`` f32 and the state outputs.  Returns ``(out,
        final_state)``."""
        leaves = tree_leaves(params) + tree_leaves(state)
        device = leaves[0].device if leaves else torch.device("cpu")
        if device.type != "cuda":
            raise ValueError(
                f"the {self.what} runs CUDA tensors; these lie on {device} "
                f"(the CPU runs {self.plain})")
        with span("srk.pack"):
            pf, pi, sf, si, lanes, ring, v, pd, sd = self.operands(
                params, state, n, xs)
            out = torch.empty(out_shape(v), dtype=CV_DTYPE, device=device)
            sf_out, si_out = torch.empty_like(sf), torch.empty_like(si)
            operands = (pf, pi, sf, si, lanes, ring, out, sf_out, si_out)
            sd_out, argtypes = None, ARGTYPES
            if self.layout.doubles:
                sd_out = torch.empty_like(sd)
                operands += (pd, sd, sd_out)
                argtypes = ARGTYPES_F64
        require_cuda(*operands)
        self.launch("srk_fused_launch", argtypes,
                    tuple(t.data_ptr() for t in operands) + (v, n), device)
        return out, self.finish(sf_out, si_out, ring, v, sd_out)

    def render(self, params: dict, state: dict, n: int, xs: dict = None):
        """Render ``n`` samples of V voices: ``params``, ``state`` and the
        lanes ``xs`` (``{key: [V, n]}``, this kernel's lane set) carry a
        leading voice axis and lie on one CUDA device.  Returns
        ``(audio [V, C, n], final_state)``."""
        channels = self.compiled.cfg.channels
        return self._launch(params, state, n, xs or {},
                            lambda v: (v, channels, n))


class StageKernel(FusedKernel):
    """Kernel K3, ``serial_stage``: the block engine's serial stage on
    CUDA, for one stage plan and lane set.  Replaces
    ``srack_tpu/ops/serial_kernel.py::make_serial_kernel`` (the Pallas
    kernel at its ``pallas_call``), which the JAX block engine runs on a
    TPU only.

    The same generated source as K1 in a stage mode, the stage's plan cut
    into pipeline stages as K1's is: the stage modules' state and the
    in-stage feedback carries in each stage warp's registers (in buffer
    mode a feedback read takes the previous block's lane instead, streamed
    in like an input wire); the stage's input wires, its modules'
    automation lanes and hoisted lanes come from ``[W, n, V]`` into each
    reading warp's shared-memory double buffer one chunk ahead
    (``cp.async``, 128 contiguous bytes per warp, lane and sample), and
    each stage output wire streams out to ``[O, n, V]``.  Like K1 it is
    bound by the serial chain of its costliest stage, not by memory: per
    voice-sample it moves ``4 * (W + O)`` bytes.  Its plain version is
    ``BlockProgram.stage_plain``, a torch loop over the same module steps,
    which it equals bit for bit (``--fmad=false``).

    An exact stage that holds an Oscillator (e.g. feedback_patch's, both
    its Oscillators on the feedback cycle) is K3's f64 build,
    ``serial_stage_f64``: its f64 leaves (the phase, a hoisted increment)
    sit in double rows beside the float and int ones, the exact
    Oscillator's device function runs in double on the same stage-warp
    pipeline, and the wires between stages stay f32.  The JAX package has
    no Pallas stage in exact precision (it runs ``lax.scan``), so this
    build ports no Pallas kernel."""

    plain = "BlockProgram.stage_plain"

    def __init__(self, program, lanes=(), stages: int = MAX_STAGES,
                 chunk: int = None, group: int = None):
        if not program.kernel_ok:
            raise ValueError(
                "the serial stage holds a module type without a CUDA device "
                "function; kernel K3 cannot run it")
        compiled = program.compiled
        self.compiled = compiled
        self.program = program
        self.lanes = tuple(sorted(lanes))
        from ..block_engine import wire_key
        missing = sorted(
            wire_key(w) for w in program.stage_in
            + [("fb",) + k for k in program.stage_fb_in]
            if wire_key(w) not in self.lanes)
        if missing:
            raise ValueError(f"stage input wires without a lane: {missing}")
        self.buffer = False
        self.layout = Layout.of(compiled, program.stage_plan)
        self.partition = partition(
            compiled, program.stage_plan,
            carried=not compiled.cfg.buffer_feedback, max_stages=stages)
        self._pipeline(program, chunk, group)
        # a stage with f64 leaves (the exact Oscillator's phase) is K3's f64
        # build, counted apart
        CudaLib.__init__(self, "serial_stage_f64" if self.layout.doubles
                         else "serial_stage", generate_source(
            compiled, self.layout, self.lanes, stage=program,
            split=self.partition, chunk=self.chunk, group=self.group),
            "serial-stage kernel")

    def run(self, params: dict, state: dict, lanes: dict, n: int):
        """Run the stage over ``n`` samples of V voices: ``params`` (every
        module's, ``[V, ...]``), ``state`` (``{"states": {stage mid: ...},
        "fb": ...}``) and ``lanes`` (``{key: [V, n]}``, this kernel's lane
        set) lie on one CUDA device.  Returns ``({wire: [V, n]},
        final stage state)``."""
        outs_key = self.program.stage_out
        outs, final = self._launch(params, state, n, lanes,
                                   lambda v: (max(len(outs_key), 1), n, v))
        final["states"] = {m: final["states"][m]
                           for m in self.program.stage_plan}
        return ({w: outs[j].T for j, w in enumerate(outs_key)}, final)
