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
stage-mode switch.  They
carry none of the TPU layout over: no (8, 128) tiles, no 1,024-voice
padding, no time chunks with a scratch carry, no padded-tail snapshot, and
for K2 no outer scan of one kernel call per block.

Design:

* **One thread per voice, one launch per render.**  The whole sample loop
  runs in the thread; the module state and the sample-feedback carries
  live in registers, and the params are loaded once.  Voices are
  independent, time is a recurrence, so the kernels are bound by the
  serial chain of each thread, not by memory: per voice-sample K1 reads
  one float per lane and writes 4 bytes per channel.  For the subtractive
  voice a sample is ~512 SASS instructions, issued one after another by
  the single warp a scheduler holds (IPC ~0.7, ~427 ns per sample on an
  H100 80GB HBM3 at 700 W); unrolling the sample loop gains nothing there,
  fewer instructions would.
* **Occupancy.**  V voices give V threads.  The headline's 1,024 voices fill
  1,024 threads, 32 warps, of a card with 132 SMs and room for 2,048
  threads on each: at most one warp per SM scheduler, nothing to hide
  latency behind but the thread's own instruction-level parallelism.
  ``BLOCK_DIM = 32`` (one warp per block) spreads the warps over as many
  SMs as possible, so each has an SM's load/store unit and L1 to itself;
  16,384 voices give 512 one-warp blocks, about 4 per SM.  Measured on an
  H100 80GB HBM3 at 700 W: a 1 s render takes the same ~21 ms from 1,024
  to 16,384 voices; blockDim 32, 64 and 128 are within 1 %, 256 is 9 %
  slower.  K2 keeps blockDim 32.
* **Lanes** (Noise draws, bound Input drivers, automation arrays) come in
  as one ``[L, n, V]`` f32 array, so a warp's 32 voices read 128
  contiguous bytes per lane and sample.  The wrapper's transpose from the
  ``[V, n]`` lanes costs one extra read and write of every lane
  (``8 * L * V * n`` bytes, 3.9 GB for one lane at 1,024 x 480,000).
  Which lanes exist depends on the render call (an Input with or without
  a driver, an automated param with or without an array), so the lane set
  is part of the generated source and of its build hash.
* **Sequencer tables** stay in the packed int rows: a table param is an
  ``srk_rows`` view, and a lookup is one load of ``tbl[(row + j) * V + v]``
  (32 neighbouring ints per warp), not a select chain.
* **K2's delayed feedback** lives in a per-voice ring in device memory,
  ``[n_fb, block, V]`` f32, a warp's voices on 128 contiguous bytes.  At
  sample t every fb read of key k takes ``ring[k][t % block]``, the value
  that key's source wrote one block earlier; all fb slots are loaded at
  the top of the sample and this sample's values stored at its end, which
  keeps the order right whatever the plan order of sinks and sources.  The
  ring starts as ``state["fb"]`` (``[V, block]``, transposed in) and, since
  ``n % block == 0``, ends as the last block in time order: K2's final fb.
  It bounds K2 like K1, by the serial chain, plus one ring load and one
  ring store per fb key per sample.  At 1,024 voices and block 1,024 the
  ring is 4 MiB per key and stays in the 50 MB L2; at 16,384 voices it is
  64 MiB per key and does not, so its traffic goes to device memory
  (4 + 4 bytes per key per voice-sample).
* **The audio writes** go straight to ``[V, C, n]``: at each sample the 32
  threads of a warp store 32 floats that lie ``C * n * 4`` bytes apart, 32
  separate 32-byte sectors each carrying 4 useful bytes.  Each thread's
  sector is filled by its next 7 samples while it waits in L2, so device
  memory sees whole sectors; the cost is 32 L1/L2 transactions per warp
  store where a coalesced layout would need 4.
* **Generated per plan.**  The module steps are the inline functions of
  ``csrc/modules.cuh``; this file emits a small ``.cu`` per compiled plan
  and lane set that loads params and state, calls the steps in plan order
  with wires as locals (a feedback read uses the carried local, or K2's
  ring slot), writes the audio and stores the final state.  Its one
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
from .cuda_lib import (BUILD_ROOT, CSRC, NVCC_FLAGS, CudaLib, I,  # noqa: F401
                       P, build, require_cuda)

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
    ``row`` of the float (``kind="f"``) or int (``kind="i"``) array."""
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
        return "float" if self.kind == "f" else "int"


def _layout(entries):
    """Assign rows to ``(path, tensor)`` entries: floats in one array,
    int32 and bool (as int32) in the other."""
    leaves, nxt = [], {"f": 0, "i": 0}
    for path, t in entries:
        if t.dtype == torch.float32:
            kind = "f"
        elif t.dtype in (torch.int32, torch.bool):
            kind = "i"
        else:
            raise TypeError(f"{path}: unsupported leaf dtype {t.dtype}")
        leaf = Leaf(path, tuple(t.shape), t.dtype, kind, nxt[kind])
        nxt[kind] += leaf.rows
        leaves.append(leaf)
    return tuple(leaves), nxt["f"], nxt["i"]


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
    from the plan's unbatched defaults (derived params included)."""
    params: tuple
    n_pf: int
    n_pi: int
    state: tuple
    n_sf: int
    n_si: int

    @classmethod
    def of(cls, compiled, mids=None) -> "Layout":
        """The layout of every module, or of the modules ``mids`` (a serial
        stage: its modules and the feedback carries)."""
        mids = list(compiled.instances if mids is None else mids)
        derived = compiled.derived_params(compiled.default_params)
        p = _layout(_param_entries(compiled, derived, mids))
        s = _layout(_state_entries(compiled, compiled.init_state(), mids))
        return cls(*p, *s)


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


def _inputs_of(compiled, mid, stage, fb_lanes):
    """The C expressions of ``mid``'s input ports and its ``CONN`` bits: a
    wire local, a feedback carry (or, in a buffer-mode stage, its lane), a
    stage input lane, or ``0.0f`` unconnected."""
    ins, conn = [], 0
    for i, c in enumerate(compiled.instances[mid][2]):
        if c is None:
            ins.append("0.0f")
            continue
        conn |= 1 << i
        src, sport = c
        if compiled.plan_pos[src] >= compiled.plan_pos[mid]:
            ins.append(_lane_var(f"fb:{src}#{sport}") if fb_lanes
                       else _var(("fb", (src, sport))))
        elif stage is not None and src not in stage.stage_set:
            # a stage input wire, streamed in as a lane
            ins.append(_lane_var(f"{src}#{sport}"))
        else:
            ins.append(f"w_{_ident(src)}[{sport}]")
    return ins, conn


def _param_args(compiled, mid, keys, lane_idx) -> list:
    """The step's param arguments: an automated param with an array reads
    this sample's lane value."""
    out = []
    for key in keys:
        auto = compiled._auto_key(mid, key)
        out.append(_lane_var(auto) if auto in lane_idx else _var((mid, key)))
    return out


def _emit_calls(compiled, plan, lane_idx, params_of, state_of, stage,
                fb_lanes, scoped=True, audio=True) -> list:
    """One sample's module calls in plan order, wires as locals ``w_<mid>``.
    ``scoped``: each call's input array lives in a block of its own; else it
    is ``in_<mid>``, kept in the sample's scope for the adjoints.
    ``audio``: the Output module writes the audio rows (else it is
    skipped)."""
    cfg = compiled.cfg
    L = []
    for mid in plan:
        mdef, statics, _ = compiled.instances[mid]
        ins, conn = _inputs_of(compiled, mid, stage, fb_lanes)
        if mid == compiled.output_id:
            if audio:
                L += [f"    {mdef.cuda_fn}(a{c}, t, {val});"
                      for c, val in enumerate(ins)]
            continue
        w = f"w_{_ident(mid)}"
        n_out = mdef.num_outputs(cfg, statics)
        tmpl = ", ".join([str(conn)] + _statics_args(statics))
        args = _param_args(compiled, mid, params_of.get(mid, []), lane_idx)
        args += state_of.get(mid, [])
        if mid in lane_idx:
            args.append(_lane_var(mid))
        L.append(f"    float {w}[{max(n_out, 1)}];")
        if ins and scoped:
            L.append(f"    {{ const float in[{len(ins)}] = "
                     f"{{{', '.join(ins)}}};")
            L.append(f"      {mdef.cuda_fn}<{tmpl}>("
                     + ", ".join(args + ["in", w]) + "); }")
        elif ins:
            L.append(f"    const float in_{_ident(mid)}[{len(ins)}] = "
                     f"{{{', '.join(ins)}}};")
            L.append(f"    {mdef.cuda_fn}<{tmpl}>("
                     + ", ".join(args + [f"in_{_ident(mid)}", w]) + ");")
        else:
            L.append(f"    {mdef.cuda_fn}<{tmpl}>("
                     + ", ".join(args + ["nullptr", w]) + ");")
    return L


def _state_row_stores(layout, ptr: str) -> list:
    """Store the state row to ``ptr`` (one voice's column of ``[S, V]``
    int32 words, S = n_sf + n_si): float leaves first, as their bits, then
    int and bool leaves."""
    L = []
    for leaf in layout.state:
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
                    stage=None, mode=None, t_chunk: int = 128) -> str:
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

    Deterministic: the same plan and lanes give the same text.  In buffer
    mode (``cfg.buffer_feedback``) it is K2's counterpart.  The same file
    builds with g++ (``-x c++``) into a host loop over voices,
    ``srk_fused_host`` (``srk_vjp_fwd_host``, ``srk_vjp_bwd_host``), which
    the tests use to check the generated code on the CPU."""
    cfg = compiled.cfg
    if mode not in (None, "ckpt", "bwd"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode is not None and (stage is not None or cfg.buffer_feedback):
        raise ValueError("the fused VJP kernels take a whole sample-mode "
                         "patch")
    if mode is not None and t_chunk < 1:
        raise ValueError(f"t_chunk must be >= 1, got {t_chunk}")
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
    if ckpt:
        args += ", ck"
        decl += ", int* ck"
    decl += ", int V, int n"
    entry = "srk_vjp_fwd" if ckpt else "srk_fused"
    L += _entries(entry, "srk_voice", args, decl)
    return "\n".join(L) + "\n"


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


# the entry's argument types, without the stream: the nine operand
# pointers of :meth:`FusedKernel._launch`, then V and n
ARGTYPES = [P] * 9 + [I, I]


def pack(leaves, n_f, n_i, tree_get, v: int, device):
    """Pack leaves ``[V, *rest]`` into ``[n_f, V]`` f32 and ``[n_i, V]`` i32
    rows (bool as int32).  Arrays are never empty (one dummy row)."""
    pf = torch.zeros((max(n_f, 1), v), dtype=torch.float32, device=device)
    pi = torch.zeros((max(n_i, 1), v), dtype=torch.int32, device=device)
    for leaf in leaves:
        t = tree_get(leaf.path)
        if tuple(t.shape) != (v,) + leaf.rest:
            raise ValueError(f"{leaf.path}: expected shape "
                             f"{(v,) + leaf.rest}, got {tuple(t.shape)}")
        if t.dtype != leaf.dtype:
            raise TypeError(f"{leaf.path}: expected {leaf.dtype}, got "
                            f"{t.dtype}")
        if t.device != torch.device(device):
            raise ValueError(f"{leaf.path} lies on {t.device}, not {device}")
        dst = pf if leaf.kind == "f" else pi
        dst[leaf.row:leaf.row + leaf.rows] = t.reshape(v, leaf.rows).T
    return pf, pi


def unpack(leaves, sf, si, v: int) -> dict:
    """Inverse of :func:`pack`: ``{path: tensor [V, *rest]}``."""
    out = {}
    for leaf in leaves:
        src = sf if leaf.kind == "f" else si
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
    source, its build, its launch wrapper and a count of launches.  In
    buffer-feedback mode it is K2's counterpart (``fused_voice_buffer``),
    else K1's (``fused_voice``)."""

    plain = "engine='scan'"  # what the CPU runs instead

    def __init__(self, compiled, lanes=()):
        if not eligible(compiled):
            raise ValueError(
                "patch not eligible for the fused kernel (needs fast "
                "precision, no probes, and module types with a CUDA "
                "device function)")
        self.compiled = compiled
        self.lanes = tuple(sorted(lanes))
        self.buffer = compiled.cfg.buffer_feedback
        self.layout = Layout.of(compiled)
        super().__init__(
            "fused_voice_buffer" if self.buffer else "fused_voice",
            generate_source(compiled, self.layout, self.lanes),
            "fused kernel")

    def pack(self, params: dict, state: dict, n: int, xs: dict):
        """The kernel's operands for one render on ``params``' device:
        ``(pf, pi, sf, si, lanes, ring, v)``."""
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
        lanes = pack_lanes(self.lanes, xs, v, n, device)
        ring = (pack_ring(compiled, state, v, device) if self.buffer
                else torch.zeros((1,), dtype=CV_DTYPE, device=device))
        return pf, pi, sf, si, lanes, ring, v

    def finish(self, sf_out, si_out, ring, v: int) -> dict:
        """The final state tree from the kernel's outputs."""
        final = state_tree(self.compiled,
                           unpack(self.layout.state, sf_out, si_out, v))
        if self.buffer:
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
        pf, pi, sf, si, lanes, ring, v = self.pack(params, state, n, xs)
        out = torch.empty(out_shape(v), dtype=CV_DTYPE, device=device)
        sf_out, si_out = torch.empty_like(sf), torch.empty_like(si)
        operands = (pf, pi, sf, si, lanes, ring, out, sf_out, si_out)
        require_cuda(*operands)
        self.launch("srk_fused_launch", ARGTYPES,
                    tuple(t.data_ptr() for t in operands) + (v, n), device)
        return out, self.finish(sf_out, si_out, ring, v)

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

    The same generated source as K1 in a stage mode: one thread per voice,
    the stage modules' state and the in-stage feedback carries in
    registers (in buffer mode a feedback read takes the previous block's
    lane instead, streamed in like an input wire); the stage's input
    wires, its modules' automation lanes and hoisted lanes stream in from
    ``[W, n, V]`` (a warp's 32 voices read 128
    contiguous bytes per lane and sample), and each stage output wire
    streams out to ``[O, n, V]``.  Like K1 it is bound by each thread's
    serial chain, not by memory: per voice-sample it moves ``4 * (W + O)``
    bytes.  Its plain version is ``BlockProgram.stage_plain``, a torch loop
    over the same module steps, which it equals bit for bit (``--fmad=
    false``)."""

    plain = "BlockProgram.stage_plain"

    def __init__(self, program, lanes=()):
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
        CudaLib.__init__(self, "serial_stage", generate_source(
            compiled, self.layout, self.lanes, stage=program),
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
