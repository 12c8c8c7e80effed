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

Both are one source, generated per plan with a buffer-mode switch.  They
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

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..compiler import tree_leaves
from ..modules.base import CV_DTYPE

BLOCK_DIM = 32
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "srack_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


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


def _param_entries(compiled, params):
    out = []
    for mid, (mdef, _, _) in compiled.instances.items():
        out += [((mid, key), params[mid][key]) for key in sorted(params[mid])
                if key not in mdef.host_params]
    return out


def _state_entries(compiled, state):
    out = [(("states", mid, key), state["states"][mid][key])
           for mid in compiled.instances
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
    def of(cls, compiled) -> "Layout":
        derived = compiled.derived_params(compiled.default_params)
        p = _layout(_param_entries(compiled, derived))
        s = _layout(_state_entries(compiled, compiled.init_state()))
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


def generate_source(compiled, layout: Layout = None, lanes=()) -> str:
    """The ``.cu`` source of the fused kernel for ``compiled``'s plan and
    the lane set ``lanes`` (sorted lane keys: module ids of Noise and of
    driven Inputs, ``mid~param`` of automation arrays).

    Deterministic: the same plan and lanes give the same text.  In buffer
    mode (``cfg.buffer_feedback``) it is K2's counterpart.  The same file
    builds with g++ (``-x c++``) into a host loop over voices,
    ``srk_fused_host``, which the tests use to check the generated code on
    the CPU."""
    cfg = compiled.cfg
    layout = layout or Layout.of(compiled)
    lanes = tuple(lanes)
    buffer = cfg.buffer_feedback
    n_ch = cfg.channels
    lane_idx = {k: i for i, k in enumerate(lanes)}

    def row(arr, leaf, j):
        return f"{arr}[{leaf.row + j} * (size_t)V + v]"

    def load(leaf, arr, const):
        var, q = _var(leaf.path), "const " if const else ""
        if leaf.rest and leaf.kind == "i":
            # an int table: a view into the rows, read per sample
            return (f"  const srk_rows {var}{{{arr} + {leaf.row} * (size_t)V"
                    " + v, (size_t)V};")
        if leaf.rest:
            vals = ", ".join(row(arr, leaf, j) for j in range(leaf.rows))
            return f"  {q}{leaf.ctype} {var}[{leaf.rows}] = {{{vals}}};"
        return f"  {q}{leaf.ctype} {var} = {row(arr, leaf, 0)};"

    params_of, state_of = {}, {}
    for leaf in layout.params:
        params_of.setdefault(leaf.path[0], []).append(leaf.path[1])
    for leaf in layout.state:
        if leaf.path[0] == "states":
            state_of.setdefault(leaf.path[1], []).append(_var(leaf.path))

    def fb_slot(k):
        return (f"ring[((size_t){compiled.fb_keys.index(k)} * SRK_FB_BLOCK "
                "+ slot) * V + v]")

    kind = "buffer-feedback kernel (K2)" if buffer else "voice kernel (K1)"
    L = [
        f"// Generated by srack_tpu_torch/ops/fused.py: the fused {kind}",
        "// for one plan, " + ", ".join(
            f"{mid} ({compiled.instances[mid][0].type_name})"
            for mid in compiled.plan) + ".",
        "// Lanes: " + (", ".join(lanes) if lanes else "none") + ".",
        f"#define SRK_SAMPLE_RATE {int(cfg.sample_rate)}",
        f"#define SRK_BLOCK {BLOCK_DIM}",
    ]
    if buffer:
        L.append(f"#define SRK_FB_BLOCK {int(cfg.block_size)}")
    L += [
        '#include "modules.cuh"',
        "",
        "SRK_HD void srk_voice(int v, int V, int n, "
        "const float* __restrict__ pf, const int* __restrict__ pi, "
        "const float* __restrict__ sf, const int* __restrict__ si, "
        "const float* __restrict__ lanes, float* __restrict__ ring, "
        "float* __restrict__ audio, float* __restrict__ sf_out, "
        "int* __restrict__ si_out) {",
        "  // params, loaded once",
    ]
    L += [load(leaf, "p" + leaf.kind, True) for leaf in layout.params]
    L.append("  // state" + ("" if buffer else " and feedback carries")
             + ", in registers")
    L += [load(leaf, "s" + leaf.kind, False) for leaf in layout.state]
    L += [f"  float* a{c} = audio + ((size_t)v * {n_ch} + {c}) * (size_t)n;"
          for c in range(n_ch)]
    if buffer:
        L.append("  int slot = 0;  // t % SRK_FB_BLOCK")
    L.append("  for (int t = 0; t < n; ++t) {")
    L += [f"    const float {_lane_var(k)} = "
          f"lanes[((size_t){i} * n + t) * V + v];"
          for k, i in lane_idx.items()]
    if buffer:
        L += [f"    const float {_var(('fb', k))} = {fb_slot(k)};"
              for k in compiled.fb_keys]
    for mid in compiled.plan:
        mdef, statics, inputs = compiled.instances[mid]
        ins, conn = [], 0
        for i, c in enumerate(inputs):
            if c is None:
                ins.append("0.0f")
                continue
            conn |= 1 << i
            src, sport = c
            if compiled.plan_pos[src] >= compiled.plan_pos[mid]:
                ins.append(_var(("fb", (src, sport))))
            else:
                ins.append(f"w_{_ident(src)}[{sport}]")
        if mid == compiled.output_id:
            L += [f"    {mdef.cuda_fn}(a{c}, t, {val});"
                  for c, val in enumerate(ins)]
            continue
        w = f"w_{_ident(mid)}"
        n_out = mdef.num_outputs(cfg, statics)
        tmpl = ", ".join([str(conn)] + _statics_args(statics))
        args = []
        for key in params_of.get(mid, []):
            auto = compiled._auto_key(mid, key)
            # an automated param with an array reads this sample's value
            args.append(_lane_var(auto) if auto in lane_idx
                        else _var((mid, key)))
        args += state_of.get(mid, [])
        if mid in lane_idx:
            args.append(_lane_var(mid))
        L.append(f"    float {w}[{max(n_out, 1)}];")
        if ins:
            L.append(f"    {{ const float in[{len(ins)}] = "
                     f"{{{', '.join(ins)}}};")
            L.append(f"      {mdef.cuda_fn}<{tmpl}>("
                     + ", ".join(args + ["in", w]) + "); }")
        else:
            L.append(f"    {mdef.cuda_fn}<{tmpl}>("
                     + ", ".join(args + ["nullptr", w]) + ");")
    if buffer:
        L += [f"    {fb_slot(k)} = w_{_ident(k[0])}[{k[1]}];"
              for k in compiled.fb_keys]
        L.append("    if (++slot == SRK_FB_BLOCK) slot = 0;")
    else:
        L += [f"    {_var(('fb', k))} = w_{_ident(k[0])}[{k[1]}];"
              for k in compiled.fb_keys]
    L.append("  }")
    L.append("  // final state: after sample n-1")
    for leaf in layout.state:
        var = _var(leaf.path)
        for j in range(leaf.rows):
            val = f"{var}[{j}]" if leaf.rest else var
            L.append(f"  {row('s' + leaf.kind + '_out', leaf, j)} = {val};")
    L.append("}")
    args = "pf, pi, sf, si, lanes, ring, audio, sf_out, si_out"
    decl = ("const float* pf, const int* pi, const float* sf, const int* si, "
            "const float* lanes, float* ring, float* audio, float* sf_out, "
            "int* si_out, int V, int n")
    L += [
        "",
        "#ifdef __CUDACC__",
        f"__global__ void __launch_bounds__(SRK_BLOCK) "
        f"srk_fused_kernel({decl}) {{",
        "  const int v = blockIdx.x * blockDim.x + threadIdx.x;",
        f"  if (v < V) srk_voice(v, V, n, {args});",
        "}",
        "",
        f'extern "C" int srk_fused_launch({decl}, void* stream) {{',
        "  const int blocks = (V + SRK_BLOCK - 1) / SRK_BLOCK;",
        "  srk_fused_kernel<<<blocks, SRK_BLOCK, 0, (cudaStream_t)stream>>>("
        f"{args}, V, n);",
        "  return (int)cudaGetLastError();",
        "}",
        "#else",
        f'extern "C" int srk_fused_host({decl}) {{',
        f"  for (int v = 0; v < V; ++v) srk_voice(v, V, n, {args});",
        "  return 0;",
        "}",
        "#endif",
    ]
    return "\n".join(L) + "\n"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and Path(cuda_home, "bin", "nvcc").exists():
        return str(Path(cuda_home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the fused "
        "kernel is built from source at first use")


def build(source: str, compiler=None, flags=NVCC_FLAGS,
          root: Path = BUILD_ROOT) -> tuple:
    """Compile ``source`` (with ``csrc/`` on the include path) into a shared
    library under ``root/<hash>/``; reuse it when the hash matches.  Returns
    ``(path, compiler_log)``."""
    compiler = compiler or _nvcc()
    header = (CSRC / "modules.cuh").read_text()
    key = hashlib.sha256("\0".join(
        [source, header, Path(compiler).name, *flags]).encode()).hexdigest()
    out_dir = root / key[:16]
    lib = out_dir / "fused.so"
    log_path = out_dir / "build.log"
    if lib.exists():
        return lib, log_path.read_text() if log_path.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "fused.cu"
    src.write_text(source)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [compiler, *flags, "-I", str(CSRC), "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"building the fused kernel failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}")
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    os.replace(tmp, lib)
    return lib, log


def _bind(lib_path, entry: str, extra=()):
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int] + list(
        extra)
    fn.restype = ctypes.c_int
    return lib, fn


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


class FusedKernel:
    """The fused kernel of one compiled plan and lane set: its generated
    source, its build, its launch wrapper and a count of launches.  In
    buffer-feedback mode it is K2's counterpart (``fused_voice_buffer``),
    else K1's (``fused_voice``)."""

    def __init__(self, compiled, lanes=()):
        if not eligible(compiled):
            raise ValueError(
                "patch not eligible for the fused kernel (needs fast "
                "precision, no probes, and module types with a CUDA "
                "device function)")
        self.compiled = compiled
        self.lanes = tuple(sorted(lanes))
        self.buffer = compiled.cfg.buffer_feedback
        self.name = "fused_voice_buffer" if self.buffer else "fused_voice"
        self.layout = Layout.of(compiled)
        self.source = generate_source(compiled, self.layout, self.lanes)
        self.launches = 0  # the wrapper adds one where it launches
        self.build_log = ""
        self._fn = None
        self._lib = None

    def build(self):
        """Build (or reuse) the library and bind its entry point."""
        if self._fn is None:
            path, self.build_log = build(self.source)
            self._lib, self._fn = _bind(path, "srk_fused_launch",
                                        [ctypes.c_void_p])
        return self._fn

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

    def render(self, params: dict, state: dict, n: int, xs: dict = None):
        """Render ``n`` samples of V voices: ``params``, ``state`` and the
        lanes ``xs`` (``{key: [V, n]}``, this kernel's lane set) carry a
        leading voice axis and lie on one CUDA device.  Returns
        ``(audio [V, C, n], final_state)``."""
        leaves = tree_leaves(params) + tree_leaves(state)
        device = leaves[0].device if leaves else torch.device("cpu")
        if device.type != "cuda":
            raise ValueError(
                f"the fused kernel renders CUDA tensors; these lie on "
                f"{device} (the CPU runs engine='scan')")
        pf, pi, sf, si, lanes, ring, v = self.pack(params, state, n,
                                                   xs or {})
        audio = torch.empty((v, self.compiled.cfg.channels, n),
                            dtype=CV_DTYPE, device=device)
        sf_out, si_out = torch.empty_like(sf), torch.empty_like(si)
        for t in (pf, pi, sf, si, lanes, ring, audio, sf_out, si_out):
            if not t.is_contiguous() or t.device != device:
                raise ValueError("kernel operands must be contiguous and on "
                                 "one device")
        fn = self.build()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(pf.data_ptr(), pi.data_ptr(), sf.data_ptr(),
                     si.data_ptr(), lanes.data_ptr(), ring.data_ptr(),
                     audio.data_ptr(), sf_out.data_ptr(), si_out.data_ptr(),
                     v, n, stream)
        if err != 0:
            raise RuntimeError(f"fused kernel launch failed: CUDA error {err}")
        self.launches += 1
        return audio, self.finish(sf_out, si_out, ring, v)
