"""The Freeverb on CUDA: kernel K8 (counterpart:
``srack_tpu/ops/freeverb_kernel.py``, the Pallas kernel built by ``_build``).

``csrc/freeverb.cu`` has two entries, each with a launch count here:

* ``freeverb`` (:data:`FREEVERB`, entry ``srk_freeverb``), the main path's:
  one CTA of 160 threads per voice with the voice's 24 lines in shared
  memory (111,776 B at 48 kHz, two CTAs per SM, 3.9 waves at 1,024
  voices).  Time goes in chunks of ``T`` samples (:func:`tile_for`): 128
  reader threads compute a chunk's comb sums, allpass chains and output mix
  in parallel, one writer warp runs the 16 combs' damping one-poles one
  chunk behind them.  The wet/dry mix is fused: no raw ``[2, V, n]``.
* ``freeverb_twin`` (:data:`FREEVERB_TWIN`, entry ``srk_freeverb_twin``),
  its one-thread twin: one thread per voice and channel with the lines in
  device memory, then an elementwise mix pass.

Both run the module's exact per-sample ticks in the same order, so they
agree bit for bit; the source note states the launch shapes, the
shared-memory arithmetic and what bounds each.

Exact precision's f64 core has its own build of both entries,
:data:`FREEVERB_F64` (``srk_freeverb_f64``) and :data:`FREEVERB_TWIN_F64`
(``srk_freeverb_twin_f64``): the same templates with the lines, filter
states and gains in double, the lanes in and out f32.  A voice's lines then
take ``8 * (rows + 2T)`` bytes of shared memory, 223,552 B at 48 kHz: one
CTA per SM.  At 96 kHz they do not fit, and the same rule sends the voice
to the f64 twin.  The JAX package runs its exact Freeverb in XLA (its K8
takes f32 only), so these builds port no Pallas kernel.

**Which entry runs** is a rule on the line lengths, fixed by the sample
rate (:func:`kernel_for`): the shared-memory kernel when its chunk and the
voice's lines fit (:func:`tile_for`: ``T = min(128, shortest line,
shortest comb // 2)`` at least 8, and :func:`tile_bytes` within a block's
232,448), else the twin.  From 1,568 Hz to 96 kHz it is the
shared-memory kernel (``T`` = 24 at 4,800 Hz, 128 from 44.1 kHz); at 192
kHz a voice's lines take 443,160 B, and below 1,568 Hz the shortest
allpass is under 8 samples: the twin runs.  A build or launch
error raises: it never selects the twin.

The wrapper (:func:`render`, called by the module's ``_block`` for CUDA
tensors):

1. brings the 24 rings ``[V, L_j]`` into time order with kernel K9
   (``ops/ring_roll.py``), which writes them straight into the kernels'
   ``[rows, V]`` layout, line j at rows ``offs[j]``;
2. launches K8, which updates the lines and the comb filter states in
   place and writes the two output lanes.  K8 reads its input lanes where
   they lie, each through its own voice and time strides (four arguments
   after the two lane pointers, ``SRK_FV_LANES``): the block engine's
   stage kernel K3 stores its output wires time-major, so the reverb's
   input is a ``[V, n]`` view with strides ``(1, V)``, which the wrapper
   once copied into rows (~16 ms a render at 1,024 x 480,000).  Only a
   lane not in f32 is still copied; :class:`FreeverbKernel` counts both
   (``strided_lanes``, ``lane_copies``);
3. moves the lines back into rings with K9, rotated by ``n % L``, so they
   return as the module's block form returns them: time order, write
   index 0, the 24 rings views of one new buffer.

Its plain version is ``modules/freeverb.py::block_plain``, the chunked
form.  The wrapper launches a kernel for CUDA tensors or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..modules.base import CV_DTYPE
from ..modules.freeverb import FS_KEYS, LINE_KEYS, line_lengths
from .cuda_lib import CudaLib, I, P, csrc, require_cuda
from .ring_roll import ring_align_for

LL = ctypes.c_longlong
# the entries' shared arguments (SRK_FV_ARGS), without the stream: each
# input lane a pointer and its voice and time strides; the shared-memory
# entry adds the rows and T
ARGTYPES = [P, LL, LL, P, LL, LL, P, I, P, I, P, P, I, P, I, P, I, P, P, P, P,
            P, P, P, I, I, I]
TILE_ARGTYPES = ARGTYPES + [I, I]
TILE_MIN, TILE_MAX = 8, 128  # csrc/freeverb.cu SRK_FV_TILE_MIN, _MAX
SMEM_MAX = 232448       # dynamic shared memory one block may take (227 KB)


def all_lengths(cfg) -> tuple:
    """The 24 line lengths in the kernel's order: combs left, right;
    allpasses left, right."""
    cl, cr, al, ar = line_lengths(cfg.sample_rate)
    return cl + cr + al + ar


def tile_bytes(lens, t: int, itemsize: int = 4) -> int:
    """The shared memory of one CTA of the shared-memory kernel: the
    voice's lines and the mix buffers ``[2][T]``, of ``itemsize``-byte
    words (8 for the f64 core)."""
    return itemsize * (sum(lens) + 2 * t)


def tile_for(lens, itemsize: int = 4) -> int:
    """The shared-memory kernel's chunk ``T`` for these 24 line lengths, or
    None when it cannot run them: ``T`` is at most every line (a chunk
    never reads its own writes) and half the shortest comb (the writer runs
    a chunk behind the readers), at least 8 (the writer's runs of 16
    samples need combs of at least 16), and :func:`tile_bytes` must fit
    one block's shared memory."""
    t = min(TILE_MAX, min(lens), min(lens[:16]) // 2)
    if t < TILE_MIN or tile_bytes(lens, t, itemsize) > SMEM_MAX:
        return None
    return t


def _gain(x: torch.Tensor, v: int, n: int):
    """A gain of :func:`~..modules.freeverb.block_gains` as the kernel takes
    it: ``([V], 0)`` per voice or ``([V, n], 1)`` as a lane."""
    if x.shape[-1] == n and n > 1:
        return x.expand(v, n).contiguous(), 1
    return x.expand(v, 1).reshape(v).contiguous(), 0


def operands(cfg, l_in, r_in, gains, fs, lines, n: int, skip_r: bool,
             tables, raw: bool = True):
    """The entries' shared arguments (stream excluded) for one render, and
    the outputs: ``(args, keep, out_l, out_r)``; ``keep`` holds the tensors
    the pointers point into.  ``l_in``, ``r_in``: ``[V, n]`` f32 views of
    any strides (the kernels read a lane in place through its voice and
    time strides: a transposed or broadcast view does), or None (silence);
    ``fs``: ``[V, 16]`` and ``lines``: ``[sum L, V]``, both updated in
    place; ``tables``: the int32 ``(lens, offsets)`` of the lines; ``raw``:
    allocate the twin's raw outputs ``[2, V, n]`` (the shared-memory entry
    mixes in place and takes none)."""
    cl, cr, _, _ = line_lengths(cfg.sample_rate)
    lens = all_lengths(cfg)
    v = fs.shape[0]
    chunk = max(min(min(cl), min(cr), n), 1)
    damp, feed, in_gain, wet1, wet2, dry = gains
    core = fs.dtype
    g = [_gain(x, v, n) for x in (damp, feed)]
    ing, _ = _gain(in_gain, v, 1)
    mix = [_gain(x, v, n) for x in (wet1, wet2, dry)]
    device = fs.device
    raw_out = (torch.empty((2, v, n), dtype=core, device=device) if raw
               else None)
    out_l = torch.empty((v, n), dtype=CV_DTYPE, device=device)
    out_r = None if skip_r else torch.empty_like(out_l)
    for x in (l_in, r_in):
        if x is not None and (tuple(x.shape) != (v, n)
                              or x.dtype != CV_DTYPE):
            raise ValueError(f"Freeverb input lane {tuple(x.shape)} "
                             f"{x.dtype}, expected a [{v}, {n}] f32 view")
    if tuple(fs.shape) != (v, 16) or tuple(lines.shape) != (sum(lens), v):
        raise ValueError("Freeverb state in the wrong layout")
    if lines.dtype != core or any(x.dtype != core for x, _ in g + mix) \
            or ing.dtype != core:
        raise TypeError(f"Freeverb lines, filter states and gains must "
                        f"share one core dtype, {core}")

    def ptr(x):
        return None if x is None else x.data_ptr()

    def lane(x):
        return (None, 0, 0) if x is None else (x.data_ptr(), *x.stride())

    args = (*lane(l_in), *lane(r_in), g[0][0].data_ptr(), g[0][1],
            g[1][0].data_ptr(), g[1][1], ing.data_ptr(),
            mix[0][0].data_ptr(), mix[0][1], mix[1][0].data_ptr(),
            mix[1][1], mix[2][0].data_ptr(), mix[2][1], fs.data_ptr(),
            lines.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(),
            ptr(raw_out), out_l.data_ptr(), ptr(out_r), v, n, chunk)
    keep = [x for x in (l_in, r_in, ing, raw_out, out_l, out_r, *tables)
            if x is not None] + [a for a, _ in g + mix]
    return args, keep, out_l, out_r


def line_tables(lens, device) -> tuple:
    """``(lens, row offsets)`` of the lines as int32 on ``device``."""
    offs, off = [], 0
    for length in lens:
        offs.append(off)
        off += length
    return (torch.tensor(lens, dtype=torch.int32, device=device),
            torch.tensor(offs, dtype=torch.int32, device=device))


class FreeverbKernel(CudaLib):
    """One entry of ``csrc/freeverb.cu``: the shared-memory kernel
    (``tiled``) or its one-thread twin, for the core dtype ``core``.

    Beside ``launches``, two counts of the input lanes its operands took
    (:meth:`lanes`; a mono voice's one lane counted once):
    ``strided_lanes``, read in place with a time stride other than 1 (K3's
    time-major output, a broadcast), and ``lane_copies``, copied first (a
    lane not in f32)."""

    def __init__(self, name: str, entry: str, what: str, tiled: bool,
                 core: torch.dtype = CV_DTYPE):
        super().__init__(name, csrc("freeverb.cu"), what)
        self.entry = entry
        self.tiled = tiled
        self.core = core
        self.itemsize = torch.empty((), dtype=core).element_size()
        self._tables: dict = {}  # (lens, device) -> line_tables
        self.strided_lanes = 0
        self.lane_copies = 0

    def lanes(self, l_in, r_in, v: int, n: int):
        """The input lanes as the entries read them: each broadcast to a
        ``[V, n]`` view of its own strides, copied only where it is not f32
        (then only the lane as given, before the broadcast), and counted.
        ``r_in is l_in`` (a mono voice) stays one lane."""
        def lane(x):
            if x is None:
                return None
            if x.dtype != CV_DTYPE:
                self.lane_copies += 1
                return x.to(CV_DTYPE).expand(v, n)
            x = x.expand(v, n)
            if x.stride(1) != 1:
                self.strided_lanes += 1
            return x
        left = lane(l_in)
        return left, left if r_in is l_in else lane(r_in)

    def entry_args(self, cfg, l_in, r_in, gains, fs, lines, n: int,
                   skip_r: bool, tables):
        """This entry's arguments (stream excluded): ``(args, argtypes,
        keep, out_l, out_r)``, as :func:`operands` on the lanes of
        :meth:`lanes`, the shared-memory entry with its rows and chunk."""
        lens = all_lengths(cfg)
        if fs.dtype != self.core:
            raise TypeError(f"the {self.what} takes a {self.core} core, "
                            f"not {fs.dtype}")
        l_in, r_in = self.lanes(l_in, r_in, fs.shape[0], n)
        args, keep, out_l, out_r = operands(cfg, l_in, r_in, gains, fs,
                                            lines, n, skip_r, tables,
                                            raw=not self.tiled)
        if not self.tiled:
            return args, ARGTYPES, keep, out_l, out_r
        t = tile_for(lens, self.itemsize)
        if t is None:
            raise ValueError(f"the Freeverb lines of {cfg.sample_rate} Hz "
                             "do not fit the shared-memory kernel")
        return args + (sum(lens), t), TILE_ARGTYPES, keep, out_l, out_r

    def launch_lines(self, cfg, l_in, r_in, gains, fs, lines, n: int,
                     skip_r: bool = False):
        """One launch on operands in the kernel's layout (see
        :func:`operands`).  Returns ``(out_l, out_r or None)``."""
        lens = all_lengths(cfg)
        device = require_cuda(fs, lines)
        _on_device(device, (l_in, r_in))
        key = (lens, str(device))
        if key not in self._tables:
            self._tables[key] = line_tables(lens, device)
        args, argtypes, keep, out_l, out_r = self.entry_args(
            cfg, l_in, r_in, gains, fs, lines, n, skip_r, self._tables[key])
        _on_device(device, keep)
        self.launch(self.entry, argtypes, args, device)
        return out_l, out_r


def _on_device(device, tensors) -> None:
    """Raise unless every tensor (None aside) lies on ``device``.  The
    input lanes are views of any strides; :func:`operands` makes every
    other operand it points into contiguous."""
    for x in tensors:
        if x is not None and x.device != device:
            raise ValueError(f"the kernel takes CUDA tensors on one device; "
                             f"got {x.device} beside {device}")


FREEVERB = FreeverbKernel("freeverb", "srk_freeverb",
                          "Freeverb kernel (K8)", tiled=True)
FREEVERB_TWIN = FreeverbKernel("freeverb_twin", "srk_freeverb_twin",
                               "Freeverb kernel, one-thread twin (K8)",
                               tiled=False)
FREEVERB_F64 = FreeverbKernel("freeverb_f64", "srk_freeverb_f64",
                              "Freeverb kernel, f64 build (K8)", tiled=True,
                              core=torch.float64)
FREEVERB_TWIN_F64 = FreeverbKernel(
    "freeverb_twin_f64", "srk_freeverb_twin_f64",
    "Freeverb kernel, f64 build, one-thread twin (K8)", tiled=False,
    core=torch.float64)


def kernel_for(lens, core: torch.dtype = CV_DTYPE) -> FreeverbKernel:
    """K8's entry for these line lengths and core dtype: the shared-memory
    kernel where :func:`tile_for` gives a chunk for its word size, else the
    one-thread twin."""
    if core == torch.float64:
        return FREEVERB_F64 if tile_for(lens, 8) is not None \
            else FREEVERB_TWIN_F64
    return FREEVERB if tile_for(lens) is not None else FREEVERB_TWIN


def render(cfg, l_in, r_in, mono: bool, gains, state: dict, n: int,
           skip_r: bool = False):
    """The module's block form on CUDA tensors: ``(new_state, (out_l,
    out_r))`` with the rings in time order and write index 0.  With
    ``skip_r`` (the Right output feeds nothing) ``out_r`` is a placeholder
    that holds no memory of its own."""
    lens = all_lengths(cfg)
    v = state["cl0"].shape[0]
    device = state["cl0"].device
    core = state["cl0"].dtype        # f64 in exact precision
    k9 = ring_align_for(core)
    if mono:
        r_in = l_in
    lines = torch.empty((sum(lens), v), dtype=core, device=device)
    line_rows = torch.split(lines, list(lens))
    idx = torch.stack([state[f"{k}_idx"] for k in LINE_KEYS]).to(
        torch.int32).contiguous()
    k9.move([state[k].contiguous() for k in LINE_KEYS],
            line_rows, lens, v, idx=idx, dst_lines=True)
    fs = torch.stack([state[k] for k in FS_KEYS], dim=1).contiguous()
    out_l, out_r = kernel_for(lens, core).launch_lines(
        cfg, l_in, r_in, gains, fs, lines, n, skip_r)
    rings = [b.view(v, length) for b, length in zip(torch.split(
        torch.empty(v * sum(lens), dtype=core, device=device),
        [v * x for x in lens]), lens)]
    k9.move(line_rows, rings, lens, v, shifts=[n % length for length in lens],
            src_lines=True)
    new_state = dict(state)
    for k, ring in zip(LINE_KEYS, rings):
        new_state[k] = ring
        new_state[f"{k}_idx"] = torch.zeros_like(state[f"{k}_idx"])
    for j, k in enumerate(FS_KEYS):
        new_state[k] = fs[:, j].contiguous()
    if out_r is None:
        out_r = torch.zeros((), dtype=CV_DTYPE, device=device).expand(v, n)
    return new_state, (out_l, out_r)
