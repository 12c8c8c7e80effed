"""Row scans on CUDA: kernel K4 (counterpart: ``srack_tpu/ops/scan_kernel.py``,
the Pallas kernel ``_scan_rows``).

Inclusive scans along the last axis of ``[..., n]`` arrays, as the
whole-block primitives of ``ops/basic.py`` use them on CUDA tensors: ``sum``
(f32, int32), ``max`` (f32, int32), ``fill`` (k values of one dtype and a
mask) and ``affine`` (A, B).  The kernel is ``csrc/row_scan.cu``: one CTA
per row, a warp-shuffle scan within each 1,024-element chunk of the row and
the prefix of the chunks before carried in order.  Its source note states
the order of combination (the Sample player's kernel, a later slice, must
reuse it), what bounds it (bytes) and its launch shape.

The plain versions are the log-doubling forms in ``ops/basic.py``
(``cumsum_plain`` and its siblings), which the wrappers there run for CPU
tensors.  This wrapper launches the kernel for CUDA tensors or raises.
"""

from __future__ import annotations

import torch

from .cuda_lib import CudaLib, I, P, csrc, require_cuda


class RowScan(CudaLib):
    """K4: ``run(kind, arrays)`` and ``fill(values, mask)``."""

    def __init__(self):
        super().__init__("row_scan", csrc("row_scan.cu"),
                         "row-scan kernel (K4)")

    @staticmethod
    def _rows(x: torch.Tensor):
        n = x.shape[-1] if x.dim() else 1
        return x.numel() // max(n, 1), n

    def run(self, kind: str, arrs: tuple) -> tuple:
        """``kind`` in ``sum``, ``max`` (one array) or ``affine`` (A, B):
        the inclusive scans along the last axis, as new tensors."""
        x = arrs[0]
        arrs = tuple(a.contiguous() for a in arrs)
        device = require_cuda(*arrs)
        for a in arrs:
            if a.shape != x.shape:
                raise ValueError(f"{kind} scan of shapes {a.shape} and "
                                 f"{x.shape}")
        rows, n = self._rows(x)
        outs = tuple(torch.empty_like(a) for a in arrs)
        if kind in ("sum", "max"):
            dt = {torch.float32: "f32", torch.int32: "i32"}.get(x.dtype)
            if dt is None:
                raise TypeError(f"{kind} scan of {x.dtype}: f32 or int32")
            entry = f"srk_scan_{kind}_{dt}"
            argtypes = [P, P, I, I]
            args = (arrs[0].data_ptr(), outs[0].data_ptr(), rows, n)
        elif kind == "affine":
            if any(a.dtype != torch.float32 for a in arrs):
                raise TypeError("affine scan of f32 arrays only")
            entry, argtypes = "srk_scan_affine_f32", [P, P, P, P, I, I]
            args = (arrs[0].data_ptr(), arrs[1].data_ptr(),
                    outs[0].data_ptr(), outs[1].data_ptr(), rows, n)
        else:
            raise ValueError(f"unknown scan kind {kind!r}")
        self.launch(entry, argtypes, args, device)
        return outs

    def fill(self, values: tuple, mask: torch.Tensor):
        """Forward fill: each value array's most recent entry where
        ``mask`` held.  Returns ``(filled_tuple, any_valid bool)``; where
        nothing held yet the filled value is 0.  Arrays of one dtype go in
        one launch of up to four; others take further launches."""
        m = mask.to(torch.int32).contiguous()
        require_cuda(m)
        rows, n = self._rows(m)
        filled, ok = [None] * len(values), None
        groups: dict = {}
        for i, v in enumerate(values):
            if v.shape != mask.shape:
                raise ValueError(f"fill of shape {v.shape} with mask "
                                 f"{mask.shape}")
            groups.setdefault(v.dtype, []).append(i)
        for dtype, idx in groups.items():
            dt = {torch.float32: "f32", torch.int32: "i32"}.get(dtype)
            if dt is None:
                raise TypeError(f"fill of {dtype}: f32 or int32")
            for start in range(0, len(idx), 4):
                part = idx[start:start + 4]
                vals = torch.stack([values[i] for i in part]).contiguous()
                device = require_cuda(vals, m)
                out = torch.empty_like(vals)
                out_ok = torch.empty_like(m)
                self.launch(f"srk_scan_fill_{dt}", [P, P, P, P, I, I, I],
                            (vals.data_ptr(), m.data_ptr(), out.data_ptr(),
                             out_ok.data_ptr(), len(part), rows, n), device)
                for j, i in enumerate(part):
                    filled[i] = out[j]
                ok = out_ok
        if ok is None:
            raise ValueError("fill needs at least one value array")
        return tuple(filled), ok != 0


ROW_SCAN = RowScan()
