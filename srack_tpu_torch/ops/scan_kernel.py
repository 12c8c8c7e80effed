"""Row scans on CUDA: kernel K4 (counterpart: ``srack_tpu/ops/scan_kernel.py``,
the Pallas kernel ``_scan_rows``).

Inclusive scans along the last axis of ``[..., n]`` arrays, as the
whole-block primitives of ``ops/basic.py`` use them on CUDA tensors: ``sum``
(f32, int32), ``max`` (f32, int32), ``fill`` (k values of one dtype and a
mask) and ``affine`` (A, B).

Its f64 build, :data:`ROW_SCAN_F64` (``row_scan_f64``: entries
``srk_scan_sum_f64``, ``srk_scan_max_f64`` and ``srk_scan_fill_f64`` of
the same source and templates), takes exact precision's ``[V, n]`` f64
rows: the exact Oscillator block form's prefix sum of its increments and
the fill of its Sync.  The JAX package computes these in XLA (its K4
takes only f32 and int32), so this build ports no Pallas kernel; its
plain versions are the same log-doubling forms in f64.

The kernel is ``csrc/row_scan.cu``'s ``srk_scan_pipe_kernel``: one CTA per
row walking the row's 1,024-element chunks in order, the next chunks
prefetched into a ring in shared memory with ``cp.async``, the CTA scan of
``csrc/row_scan.cuh`` with two barriers a chunk.  Its source note states
the order of combination (which the Sample player's kernel K7 shares),
what bounds it (bytes) and the design.  Each entry has two variants,
picked here by :func:`vector_fits`: ``<entry>_vec`` moves a thread's
elements as 16-byte pieces and needs every array's rows 16-byte aligned
(``n`` times the element size a multiple of 16, base pointers aligned);
``<entry>`` moves one element at a time and takes any row.

The plain versions are the log-doubling forms in ``ops/basic.py``
(``cumsum_plain`` and its siblings), which the wrappers there run for CPU
tensors.  This wrapper launches the kernel for CUDA tensors or raises.
"""

from __future__ import annotations

import torch

from .cuda_lib import CudaLib, I, P, csrc, require_cuda


_SUFFIX = {torch.float32: "f32", torch.int32: "i32", torch.float64: "f64"}


def vector_fits(n: int, arrays) -> bool:
    """Whether the 16-byte variant takes rows of ``n`` elements of every
    tensor in ``arrays`` (inputs and outputs): each row starts on 16
    bytes."""
    return all((n * a.element_size()) % 16 == 0 and a.data_ptr() % 16 == 0
               for a in arrays)


class RowScan(CudaLib):
    """K4: ``run(kind, arrays)`` and ``fill(values, mask)``, for the row
    dtypes ``dtypes``; :meth:`fill` sends f64 value arrays to the f64
    build."""

    def __init__(self, name: str, what: str, dtypes: tuple):
        super().__init__(name, csrc("row_scan.cu"), what)
        self.dtypes = dtypes

    def entry(self, base: str, n: int, arrays) -> str:
        """The entry of this build for ``base`` over rows of ``n``: the
        16-byte variant where :func:`vector_fits`, else the one-element
        variant."""
        return f"{base}_vec" if vector_fits(n, arrays) else base

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
            dt = _SUFFIX.get(x.dtype) if x.dtype in self.dtypes else None
            if dt is None:
                raise TypeError(f"{kind} scan of {x.dtype} by {self.name}: "
                                f"{', '.join(map(str, self.dtypes))}")
            entry = self.entry(f"srk_scan_{kind}_{dt}", n, arrs + outs)
            argtypes = [P, P, I, I]
            args = (arrs[0].data_ptr(), outs[0].data_ptr(), rows, n)
        elif kind == "affine":
            if any(a.dtype != torch.float32 for a in arrs) or \
                    torch.float32 not in self.dtypes:
                raise TypeError("affine scan of f32 arrays only")
            entry = self.entry("srk_scan_affine_f32", n, arrs + outs)
            argtypes = [P, P, P, P, I, I]
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
        one launch of up to four; others take further launches, f64 arrays
        on the f64 build (:data:`ROW_SCAN_F64`)."""
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
            dt = _SUFFIX.get(dtype)
            if dt is None:
                raise TypeError(f"fill of {dtype}: f32, f64 or int32")
            lib = ROW_SCAN_F64 if dtype == torch.float64 else ROW_SCAN
            for start in range(0, len(idx), 4):
                part = idx[start:start + 4]
                vals = torch.stack([values[i] for i in part]).contiguous()
                device = require_cuda(vals, m)
                out = torch.empty_like(vals)
                out_ok = torch.empty_like(m)
                entry = lib.entry(f"srk_scan_fill_{dt}", n,
                                  (vals, m, out, out_ok))
                lib.launch(entry, [P, P, P, P, I, I, I],
                           (vals.data_ptr(), m.data_ptr(), out.data_ptr(),
                            out_ok.data_ptr(), len(part), rows, n), device)
                for j, i in enumerate(part):
                    filled[i] = out[j]
                ok = out_ok
        if ok is None:
            raise ValueError("fill needs at least one value array")
        return tuple(filled), ok != 0


ROW_SCAN = RowScan("row_scan", "row-scan kernel (K4)",
                   (torch.float32, torch.int32))
ROW_SCAN_F64 = RowScan("row_scan_f64", "row-scan kernel, f64 build (K4)",
                       (torch.float64,))
