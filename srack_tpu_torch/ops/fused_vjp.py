"""Kernel K10, ``fused_vjp``: a batched render whose forward and backward
passes are both hand-written CUDA kernels.

Replaces ``srack_tpu/ops/fused_vjp.py::make_fused_vjp`` (its two Pallas
kernels, ``fwd_pallas`` and ``bwd_pallas``).  Both sources come from the
generator of K1 (``ops/fused.py::generate_source``) in two more modes:

* **forward, ``fused_vjp_fwd``** (mode ``"ckpt"`` with a partition,
  ``ops/fused.py::_generate_pipeline``): K1's pipeline of stage warps,
  one CTA per 32 voices, with K1's partition (``partition(compiled,
  carried=True)``, weighted by ``module_ops``) and chunk rule, the chunk
  T also dividing ``t_chunk``.  At the top of each chunk that starts a
  checkpoint chunk, each stage warp stores the state rows of the leaves
  it owns (its modules' state, the feedback carries whose cycle it holds)
  into ``ck`` (``[n_chunks, S, V]`` int32 words, floats as their bits, S =
  ``n_sf + n_si``): 4 * S bytes per voice and chunk in all, 32 voices a
  store.  Audio goes through the Output stage's shared tile, lanes
  through ``cp.async`` double buffers, wires through shared rings, as in
  K1.  Audio, final state and ``ck`` equal the twin's bit for bit: every
  module is called with the same arguments in the same order.  On an
  NVIDIA H100 80GB HBM3 at 700 W the training voice (stages of 38/67/35/38
  operations, T = 32) renders 1,024 x 48,000 in about 7.9 ms where the
  twin takes 15.1 (chip_smoke.py phase 15); still ~60x its operation
  bound: a sample costs the 67-operation stage's chain, and 1,024 voices
  fill 32 of the 132 SMs.
* **the forward's twin, ``fused_vjp_fwd_twin``** (mode ``"ckpt"`` without
  a partition): the forward it replaced, one thread per voice.  The twin
  rule is :func:`ops.fused.pick_fwd_chunk`: it runs where the plan's
  partition has one stage, or where no chunk of 8 to 32 samples both fits
  the shared-memory budget and divides ``t_chunk``; ``stages=1`` builds
  it.  A forced ``fwd_chunk`` that does not fit or divide raises.
* **backward, ``fused_vjp_bwd``** (mode ``"bwd"`` with a partition,
  ``ops/fused.py::_generate_bwd_pipeline``): a reverse pipeline of sweep
  stage warps fed by replay warps, one CTA per 32 voices.

  - The plan is cut into at most four sweep stages of consecutive modules
    (``partition(..., cost=sweep_ops)``: a module weighs its step's re-run
    plus its adjoint; a feedback carry's cycle is never cut).
  - One or two replay warps (two where the whole forward step costs more
    than the costliest stage) replay the chunks of ``t_chunk`` samples
    from their checkpoints, last chunk first, with the forward's step
    code and flags (``--fmad=false``, no fast math), so int phases,
    envelope modes and edge detectors replay bit for bit.  They store the
    state before each sample and every cross-stage forward wire into a
    scratch in device memory (``[R + 2, t_chunk, W, V]`` int32 words,
    48.2 MB for the training voice at 1,024 voices, of which the two
    chunks in use at a time, 24.1 MB, stay in the 50 MB L2), a chunk ahead
    of the sweep.  Shared memory would hold the scratch only at chunks of
    a few samples, fewer sub-chunks than the pipeline has stages.
  - The sweep warps walk sub-chunks of T samples in reverse, the output
    stage leading.  Warp g prefetches its next sub-chunk's scratch rows
    (its modules' state, the wires it reads), its lanes and, for the
    Output's stage, the audio cotangent into shared double buffers
    (``cp.async``), then per sample re-runs its modules' steps and calls
    their adjoints (``csrc/modules_adj.cuh``) in reverse plan order.  A
    wire's partial cotangent goes down a shared-memory ring to the next
    earlier stage that reads it or to its source's; a feedback source's
    wire sends each later reader's contribution on a ring of its own,
    since the one-thread kernel adds the carried cotangent first.  So
    every float cotangent takes the one-thread kernel's operations in its
    order: the two agree bit for bit.
  - A named barrier ends each sub-chunk step.  The replay leads the
    output stage by ``R m + 1`` steps (``m = t_chunk / T``), so a chunk is
    replayed before its first sub-chunk is fetched, and ``R + 2`` buffers
    keep it until stage 0 has read it (``m >= G``).

  The params' cotangents accumulate in each stage's registers over the
  render; the float state's (the feedback carries' included) start from
  the final state's, which enters at sample n-1 (n need not be a multiple
  of ``t_chunk``), and end as the initial state's.
* **the twin, ``fused_vjp_bwd_twin``** (mode ``"bwd"`` without a
  partition, ``_generate_bwd``): the backward it replaced, one thread per
  voice that replays each chunk into a ``[t_chunk, S, V]`` scratch and
  then sweeps it.  It runs where a plan has one sweep stage, or where no
  sub-chunk of 8 to 32 samples both divides ``t_chunk`` into at least one
  sub-chunk per stage and fits the shared-memory budget
  (``ops/fused.py::pick_bwd_chunk``); ``stages=1`` builds it.

None of the TPU layout is carried over: no (8, 128) tiles, no 1,024-voice
padding, no padded tail, no ``bwd_unroll`` groups, no packed audio.

What bounds it: each warp's serial chain, not memory.  The split
backward's sample costs the slower of its costliest sweep stage's chain
and a replay warp's forward step over R; per voice-sample it moves the
audio cotangent in (4 * C bytes) and W scratch words out and back in
(L2 hits).  At 1,024 voices a CTA holds 4 + R warps on one SM: nothing
hides latency but each warp's own instruction-level parallelism.

The wrapper :class:`FusedVJPKernel` holds both builds and their launch
counts; :func:`make_fused_vjp` returns its ``torch.autograd.Function``.
Its inputs are the float leaves of the *derived* params and the float
state leaves; the int leaves and the lanes go in as non-differentiable
operands.  As in the JAX package's ``render_derived``, the caller derives
the params outside the Function, so autograd chains the derived leaves'
cotangents back to the raw params through ``CompiledPatch.derived_params``
(``delta`` to the Oscillator's ``val``, ``inc_a`` to the ADSR's
``a_sec``).  Int and bool leaves and the lanes get no cotangent.

The plain version is autograd through the scan engine
(``CompiledPatch._run`` with ``nograd=False``, which keeps the
Oscillator's straight-through shadow ``pos_g``); ``CompiledPatch.
grad_render_fn`` takes it for CPU tensors.  The wrapper launches the
kernels for CUDA tensors or raises; it never falls back.
"""

from __future__ import annotations

import torch

from ..compiler import tree_leaves
from ..modules.base import CV_DTYPE
from .cuda_lib import CudaLib, I, P, require_cuda
from .fused import (Layout, _get, bwd_shape, eligible, generate_source, pack,
                    pack_lanes, pick_bwd_chunk, pick_fwd_chunk, pick_group,
                    smem_layout, split_needs, state_tree, unpack)
from .partition import MAX_STAGES, partition, sweep_ops

# the entries' argument types, without the stream: the operand pointers of
# :meth:`FusedVJPKernel.run_fwd` / :meth:`FusedVJPKernel.run_bwd`, then V, n
FWD_ARGTYPES = [P] * 10 + [I, I]
BWD_ARGTYPES = [P] * 9 + [I, I]


def vjp_eligible(compiled) -> bool:
    """Can K10 differentiate this compiled patch?  (Fused-eligible, sample
    mode, every module type with an adjoint.)"""
    return (eligible(compiled) and not compiled.cfg.buffer_feedback
            and all(mdef.cuda_adj is not None
                    for mdef, _, _ in compiled.instances.values()))


def _rows(leaves, n_rows: int, tensors, v: int, device):
    """The float leaves ``tensors`` (``[V, *rest]``, in the order of
    ``leaves``; None for zeros) as ``[n_rows, V]`` f32 rows."""
    by_path = {leaf.path: (torch.zeros((v,) + leaf.rest, dtype=CV_DTYPE,
                                       device=device) if t is None else t)
               for leaf, t in zip(leaves, tensors)}
    return pack(leaves, n_rows, 0, by_path.__getitem__, v, device)[0]


class FusedVJPKernel:
    """K10 for one compiled plan, lane set and chunk length: the forward
    (``fused_vjp_fwd``) and backward (``fused_vjp_bwd``) sources, their
    builds and launch counts, the autograd Function and its packing."""

    plain = "autograd through the scan engine"

    def __init__(self, compiled, lanes=(), t_chunk: int = 128,
                 stages: int = MAX_STAGES, chunk: int = None,
                 fwd_chunk: int = None, fwd_group: int = None):
        if not vjp_eligible(compiled):
            raise ValueError(
                "patch not eligible for the fused VJP (needs a patch the "
                "fused kernel takes, sample-mode feedback, and an adjoint "
                "(ModuleDef.cuda_adj) for every module type)")
        self.compiled = compiled
        self.lanes = tuple(sorted(lanes))
        self.t_chunk = int(t_chunk)
        lay = self.layout = Layout.of(compiled)
        self.pf = [leaf for leaf in lay.params if leaf.kind == "f"]
        self.pi = [leaf for leaf in lay.params if leaf.kind == "i"]
        self.sf = [leaf for leaf in lay.state if leaf.kind == "f"]
        self.si = [leaf for leaf in lay.state if leaf.kind == "i"]
        # the forward: K1's partition and chunk rule, the chunk dividing
        # t_chunk; the twin where pick_fwd_chunk finds none
        self.fwd_partition = partition(compiled, carried=True,
                                       max_stages=stages)
        if fwd_chunk and self.fwd_partition.n_stages < 2:
            raise ValueError("a forward chunk for a plan of one stage")
        self.fwd_chunk = fwd_chunk or pick_fwd_chunk(
            compiled, self.fwd_partition, self.lanes, lay, self.t_chunk)
        self.fwd_smem_bytes, self.fwd_group = 0, None
        if self.fwd_chunk is None:
            self.fwd = CudaLib("fused_vjp_fwd_twin", generate_source(
                compiled, lay, self.lanes, mode="ckpt",
                t_chunk=self.t_chunk), "fused-VJP forward kernel (twin)")
        else:
            self.fwd_group = fwd_group or pick_group(
                self.fwd_chunk, self.fwd_partition, lay)
            self.fwd = CudaLib("fused_vjp_fwd", generate_source(
                compiled, lay, self.lanes, mode="ckpt", t_chunk=self.t_chunk,
                split=self.fwd_partition, chunk=self.fwd_chunk,
                group=self.fwd_group), "fused-VJP forward kernel")
            lanes_of, channels, _, _ = split_needs(
                compiled, self.fwd_partition, self.lanes, None, lay)
            self.fwd_smem_bytes = smem_layout(
                self.fwd_partition, lanes_of, channels, self.fwd_chunk).nbytes
        self.partition = partition(compiled, max_stages=stages,
                                   cost=sweep_ops)
        self.chunk, self.shape = None, None
        if self.partition.n_stages > 1:
            self.chunk = chunk or pick_bwd_chunk(
                compiled, self.partition, self.lanes, lay, self.t_chunk)
        if self.chunk is None:
            # the twin: one stage, or no sub-chunk fits shared memory
            self.bwd = CudaLib("fused_vjp_bwd_twin", generate_source(
                compiled, lay, self.lanes, mode="bwd",
                t_chunk=self.t_chunk), "fused-VJP backward kernel (twin)")
        else:
            self.shape = bwd_shape(compiled, self.partition, self.lanes, lay,
                                   self.chunk, self.t_chunk)
            self.bwd = CudaLib("fused_vjp_bwd", generate_source(
                compiled, lay, self.lanes, mode="bwd", t_chunk=self.t_chunk,
                split=self.partition, chunk=self.chunk),
                "fused-VJP backward kernel")
        self._functions = {}

    @property
    def s_rows(self) -> int:
        return self.layout.n_sf + self.layout.n_si

    @property
    def twin(self) -> bool:
        """Does the backward run one thread per voice?"""
        return self.shape is None

    @property
    def fwd_twin(self) -> bool:
        """Does the forward run one thread per voice?"""
        return self.fwd_chunk is None

    def scratch_shape(self, v: int, n: int) -> tuple:
        """The backward's scratch: the split kernel's ``[chunks in flight,
        t_chunk, W, V]`` (W = S plus the cross-stage wires), the twin's
        ``[t_chunk, S, V]``."""
        if self.twin:
            return (max(min(self.t_chunk, n), 1), max(self.s_rows, 1), v)
        n_chunks = -(-n // self.t_chunk)
        return (max(min(self.shape.buffers, n_chunks), 1), self.t_chunk,
                self.s_rows + len(self.shape.xwires), v)

    def _call(self, lib, entry, argtypes, operands, v, n):
        """Launch ``entry`` of ``lib`` on the operands' device."""
        device = require_cuda(*operands)
        lib.launch(entry + "_launch", argtypes,
                   tuple(t.data_ptr() for t in operands) + (v, n), device)

    def run_fwd(self, pf, pi, sf, si, lanes, v: int, n: int):
        """One forward launch on packed operands: ``(audio [V, C, n],
        sf_out, si_out, ck)``."""
        device = pf.device
        audio = torch.empty((v, self.compiled.cfg.channels, n),
                            dtype=CV_DTYPE, device=device)
        sf_out, si_out = torch.empty_like(sf), torch.empty_like(si)
        n_chunks = -(-n // self.t_chunk)
        ck = torch.empty((max(n_chunks, 1), max(self.s_rows, 1), v),
                         dtype=torch.int32, device=device)
        ring = torch.zeros((1,), dtype=CV_DTYPE, device=device)
        self._call(self.fwd, "srk_vjp_fwd", FWD_ARGTYPES,
                   (pf, pi, sf, si, lanes, ring, audio, sf_out, si_out, ck),
                   v, n)
        return audio, sf_out, si_out, ck

    def run_bwd(self, pf, pi, lanes, ck, cta, ctf, v: int, n: int):
        """One backward launch: the audio cotangent ``cta`` ``[V, C, n]``
        and the final float state's ``ctf`` ``[n_sf, V]`` in; ``(dpf
        [n_pf, V], dsf [n_sf, V])`` out."""
        device = pf.device
        scr = torch.empty(self.scratch_shape(v, n), dtype=torch.int32,
                          device=device)
        dpf = torch.zeros((max(self.layout.n_pf, 1), v), dtype=CV_DTYPE,
                          device=device)
        dsf = torch.zeros((max(self.layout.n_sf, 1), v), dtype=CV_DTYPE,
                          device=device)
        self._call(self.bwd, "srk_vjp_bwd", BWD_ARGTYPES,
                   (pf, pi, lanes, ck, cta, ctf, scr, dpf, dsf), v, n)
        return dpf, dsf

    def function(self, n: int):
        """The ``torch.autograd.Function`` of K10 for ``n`` samples."""
        fn = self._functions.get(n)
        if fn is None:
            fn = self._functions[n] = _make_function(self, int(n))
        return fn

    def operands(self, params: dict, state: dict, n: int, xs: dict):
        """The Function's operands for a render of ``params`` (raw, ``[V,
        ...]``), ``state`` and the lanes ``xs`` (``{key: [V, n]}``, this
        kernel's lane set): ``(lanes, pi, si, floats)``, the packed lanes
        and int rows, then the derived params' and the state's float leaves
        (the params derived here, under autograd)."""
        leaves = tree_leaves(params) + tree_leaves(state)
        device, v = leaves[0].device, leaves[0].shape[0]
        derived = self.compiled.derived_params(params)
        floats = ([_get(derived, leaf.path) for leaf in self.pf]
                  + [_get(state, leaf.path) for leaf in self.sf])
        for leaf, t in zip(self.pf + self.sf, floats):
            if t.dtype != CV_DTYPE:
                raise TypeError(f"{leaf.path}: expected {CV_DTYPE}, got "
                                f"{t.dtype}")
        with torch.no_grad():
            _, pi = pack(self.pi, 0, self.layout.n_pi,
                         lambda path: _get(derived, path), v, device)
            _, si = pack(self.si, 0, self.layout.n_si,
                         lambda path: _get(state, path), v, device)
            lanes = pack_lanes(self.lanes, xs, v, n, device)
        return lanes, pi, si, floats

    def float_rows(self, floats, v: int, device):
        """The float leaves of :meth:`operands` as the kernels' ``[n_pf,
        V]`` param rows and ``[n_sf, V]`` state rows."""
        n_pf = len(self.pf)
        return (_rows(self.pf, self.layout.n_pf, floats[:n_pf], v, device),
                _rows(self.sf, self.layout.n_sf, floats[n_pf:], v, device))

    def apply(self, params: dict, state: dict, n: int, xs: dict):
        """Render through the Function (operands as :meth:`operands` takes
        them).  Returns ``(audio [V, C, n], final_state)``."""
        lanes, pi, si, floats = self.operands(params, state, n, xs)
        outs = self.function(n).apply(lanes, pi, si, *floats)
        flat = dict(zip([leaf.path for leaf in self.sf + self.si], outs[1:]))
        return outs[0], state_tree(self.compiled, flat)


def _make_function(kernel: FusedVJPKernel, n: int):
    lay = kernel.layout

    class FusedVJP(torch.autograd.Function):
        """K10 over ``n`` samples.  ``apply(lanes, pi, si, *floats)``: the
        packed lanes and int rows, then the derived params' float leaves
        and the state's float leaves (``[V, *rest]``, in the layout's
        order).  Returns the audio, the final float state leaves and the
        final int and bool state leaves (not differentiable)."""

        @staticmethod
        def forward(ctx, lanes, pi, si, *floats):
            v, device = pi.shape[1], pi.device
            pf, sf = kernel.float_rows(floats, v, device)
            audio, sf_out, si_out, ck = kernel.run_fwd(pf, pi, sf, si, lanes,
                                                       v, n)
            ctx.save_for_backward(pf, pi, lanes, ck)
            final = unpack(kernel.sf + kernel.si, sf_out, si_out, v)
            outs_i = [final[leaf.path] for leaf in kernel.si]
            ctx.mark_non_differentiable(*outs_i)
            return (audio, *[final[leaf.path] for leaf in kernel.sf],
                    *outs_i)

        @staticmethod
        @torch.autograd.function.once_differentiable
        def backward(ctx, g_audio, *g_final):
            pf, pi, lanes, ck = ctx.saved_tensors
            v, device = pi.shape[1], pi.device
            if g_audio is None:
                g_audio = torch.zeros((v, kernel.compiled.cfg.channels, n),
                                      dtype=CV_DTYPE, device=device)
            ctf = _rows(kernel.sf, lay.n_sf, g_final[:len(kernel.sf)], v,
                        device)
            dpf, dsf = kernel.run_bwd(pf, pi, lanes, ck,
                                      g_audio.to(CV_DTYPE).contiguous(), ctf,
                                      v, n)
            dp = unpack(kernel.pf, dpf, dpf, v)
            ds = unpack(kernel.sf, dsf, dsf, v)
            return (None, None, None,
                    *[dp[leaf.path] for leaf in kernel.pf],
                    *[ds[leaf.path] for leaf in kernel.sf])

    FusedVJP.kernel = kernel
    FusedVJP.n = n
    return FusedVJP


def make_fused_vjp(compiled, n: int, lanes=(), t_chunk: int = 128):
    """The ``torch.autograd.Function`` of K10 for ``compiled``'s plan, the
    lane set ``lanes`` and ``n`` samples (its kernel is
    ``compiled.fused_vjp(lanes, t_chunk)``, built at first launch).  Raises
    for a patch without an adjoint for every module."""
    return compiled.fused_vjp(lanes, t_chunk).function(n)
