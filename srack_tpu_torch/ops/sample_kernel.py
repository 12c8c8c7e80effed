"""The Sample player on CUDA: kernel K7 (counterpart:
``srack_tpu/ops/sample_kernel.py``, the Pallas kernel ``_fused_rows``).

One launch computes the whole Sample player of ``modules/sample.py``'s
block form for ``[R, n]`` gate (and CV) lanes and per-row tables ``[R, K]``:
edges, rate, the segmented prefix sum, the last-trigger fill, the end stop,
the table read and the end state.  Its entry, ``srk_sample_play`` of
``csrc/sample_play.cu`` (:data:`SAMPLE_PLAY`), combines in K4's order (the
CTA scan of ``csrc/row_scan.cuh``), so that it equals the unfused form on
K4 and K6 bit for bit.  A CTA takes 8 voices and stages each chunk of
their gate (and CV) in shared memory one chunk ahead (``cp.async``),
reading the lanes as 2-D views with any strides, so the block engine's
transposed stage outputs (``[V, n]`` views of K3's ``[n, V]`` rows) go in
without a copy; 4 warps play each voice's chunk.

Its source note states what bounds it (bytes).  The plain version is
``modules/sample.py::play_unfused`` (on CPU tensors the log-doubling scans
and one ``torch.gather``), which the module's block form runs for CPU
tensors.  This wrapper launches the kernel for CUDA tensors or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaLib, I, P, csrc, require_cuda

LL = ctypes.c_longlong
# the tile shapes of ``srk_sample_play`` (csrc/sample_play.cu,
# SRK_TILE_SHAPES): (voices per CTA, warps per voice); the main path's,
# (8, 4), was the fastest of them on an H100 (chip_smoke.py's K7 times)
TILE_SHAPES = ((8, 1), (8, 2), (8, 4), (4, 8))


class SamplePlay(CudaLib):
    """K7: ``run(gate, cv, table, base, pos0, playing0, gate_last0,
    length)``."""

    def __init__(self):
        super().__init__("sample_play", csrc("sample_play.cu"),
                         "Sample-player kernel (K7)")
        self.shape = TILE_SHAPES.index((8, 4))

    def operands(self, gate, cv, table, base, pos0, playing0, gate_last0,
                 length):
        """Check the operands; the table and per-row values contiguous,
        the flags as int32.  Returns ``(table, base, pos0, ints, device)``."""
        rows, n = gate.shape
        lanes = [gate] if cv is None else [gate, cv]
        small = [table.contiguous(), base.contiguous(), pos0.contiguous()]
        ints = [playing0.to(torch.int32).contiguous(),
                gate_last0.to(torch.int32).contiguous(),
                length.contiguous()]
        device = require_cuda(*small, *ints)
        for t in lanes + small:
            if t.dtype != torch.float32:
                raise TypeError(f"the Sample player takes f32 lanes, tables "
                                f"and rates; got {t.dtype}")
            if t.device != device:
                raise ValueError(f"the kernel takes CUDA tensors on one "
                                 f"device; got {t.device}")
        if ints[2].dtype != torch.int32:
            raise TypeError(f"Sample length of {ints[2].dtype}: int32")
        if gate.dim() != 2 or table.dim() != 2 or table.shape[0] != rows \
                or (cv is not None and cv.shape != gate.shape) \
                or any(t.shape != (rows,) for t in small[1:] + ints):
            raise ValueError("the Sample player takes [R, n] lanes, an [R, K] "
                             "table and [R] per-row values")
        if table.shape[-1] < 1:
            raise ValueError("the Sample player needs a table of at least "
                             "one frame")
        return small, ints, device

    def run(self, gate, cv, table, base, pos0, playing0, gate_last0, length):
        """``gate`` (and ``cv``, or None: the constant-rate entry) ``[R, n]``
        f32 views of any strides; ``table [R, K]`` f32; per row ``base`` and
        ``pos0`` f32, ``playing0`` and ``gate_last0`` bool, ``length``
        int32.  Returns ``(out [R, n], pos_end [R], playing_end [R] bool,
        gate_last [R] bool)``."""
        (table, base, pos0), ints, device = self.operands(
            gate, cv, table, base, pos0, playing0, gate_last0, length)
        rows, n = gate.shape
        out = torch.empty((rows, n), dtype=torch.float32, device=device)
        pos_end = pos0.clone()
        playing_end, gate_last = ints[0].clone(), ints[1].clone()
        if n and rows:
            lanes = [gate] if cv is None else [gate, cv]
            vec = all(t.stride(1) == 1 and t.stride(0) % 4 == 0
                      and t.data_ptr() % 16 == 0 for t in lanes)
            c = cv if cv is not None else gate
            self.launch("srk_sample_play", [P, LL, LL, P, LL, LL] + [P] * 10
                        + [I, I, I, I, I], (
                            gate.data_ptr(), gate.stride(0), gate.stride(1),
                            None if cv is None else cv.data_ptr(),
                            c.stride(0), c.stride(1), table.data_ptr(),
                            base.data_ptr(), pos0.data_ptr(),
                            ints[0].data_ptr(), ints[1].data_ptr(),
                            ints[2].data_ptr(), out.data_ptr(),
                            pos_end.data_ptr(), playing_end.data_ptr(),
                            gate_last.data_ptr(), rows, n, table.shape[-1],
                            int(vec), self.shape), device)
        return out, pos_end, playing_end != 0, gate_last != 0


SAMPLE_PLAY = SamplePlay()
