"""The Sample player on CUDA: kernel K7 (counterpart:
``srack_tpu/ops/sample_kernel.py``, the Pallas kernel ``_fused_rows``).

One launch computes the whole Sample player of ``modules/sample.py``'s
block form for ``[R, n]`` gate (and CV) lanes and per-row tables ``[R, K]``:
edges, rate, the segmented prefix sum, the last-trigger fill, the end stop,
the table read and the end state.  The kernel is ``csrc/sample_play.cu``:
one CTA per row, K4's launch shape and K4's order of combination (the CTA
scan of ``csrc/row_scan.cuh``), so that it equals the unfused form on
K4 and K6 bit for bit.  Its source note states what bounds it (bytes).

The plain version is ``modules/sample.py::play_unfused`` (on CPU tensors
the log-doubling scans and one ``torch.gather``), which the module's block
form runs for CPU tensors.  This wrapper launches the kernel for CUDA
tensors or raises.
"""

from __future__ import annotations

import torch

from .cuda_lib import CudaLib, I, P, csrc, require_cuda


class SamplePlay(CudaLib):
    """K7: ``run(gate, cv, table, base, pos0, playing0, gate_last0,
    length)``."""

    def __init__(self):
        super().__init__("sample_play", csrc("sample_play.cu"),
                         "Sample-player kernel (K7)")

    def run(self, gate, cv, table, base, pos0, playing0, gate_last0, length):
        """``gate`` (and ``cv``, or None: the constant-rate entry) ``[R, n]``
        f32; ``table [R, K]`` f32; per row ``base`` and ``pos0`` f32,
        ``playing0`` and ``gate_last0`` bool, ``length`` int32.  Returns
        ``(out [R, n], pos_end [R], playing_end [R] bool, gate_last [R]
        bool)``."""
        rows, n = gate.shape
        k = table.shape[-1]
        f32 = [gate.contiguous(), table.contiguous(), base.contiguous(),
               pos0.contiguous()]
        if cv is not None:
            f32.append(cv.contiguous())
        ints = [playing0.to(torch.int32).contiguous(),
                gate_last0.to(torch.int32).contiguous(),
                length.contiguous()]
        device = require_cuda(*f32, *ints)
        for t in f32:
            if t.dtype != torch.float32:
                raise TypeError(f"the Sample player takes f32 lanes, tables "
                                f"and rates; got {t.dtype}")
        if ints[2].dtype != torch.int32:
            raise TypeError(f"Sample length of {ints[2].dtype}: int32")
        if table.shape[0] != rows or (cv is not None and cv.shape != gate.shape) \
                or any(t.shape != (rows,) for t in f32[2:4] + ints):
            raise ValueError("the Sample player takes [R, n] lanes, an [R, K] "
                             "table and [R] per-row values")
        if k < 1:
            raise ValueError("the Sample player needs a table of at least "
                             "one frame")
        out = torch.empty_like(f32[0])
        pos_end = f32[3].clone()
        playing_end, gate_last = ints[0].clone(), ints[1].clone()
        if n:
            self.launch("srk_sample_play", [P] * 12 + [I, I, I], (
                f32[0].data_ptr(), None if cv is None else f32[4].data_ptr(),
                f32[1].data_ptr(), f32[2].data_ptr(), f32[3].data_ptr(),
                ints[0].data_ptr(), ints[1].data_ptr(), ints[2].data_ptr(),
                out.data_ptr(), pos_end.data_ptr(), playing_end.data_ptr(),
                gate_last.data_ptr(), rows, n, k), device)
        return out, pos_end, playing_end != 0, gate_last != 0


SAMPLE_PLAY = SamplePlay()
