"""Row gathers on CUDA: kernels K5 and K6 (counterparts: the Pallas kernels
``srack_tpu/ops/scan_kernel.py::_gather_rows`` and
``srack_tpu/ops/sample_gather.py::_gather_rows`` / ``_gather_precomputed``).

``out[r, t] = table[r, j]`` for int32 indices ``[R, n]`` and f32 or int32
tables ``[R, K]``, with ``j`` the JAX package's select-tree index
(``ops/basic.py::table_lookup``).  Both TPU kernels compute this function;
here they are one source, ``csrc/row_gather.cu``, with two entries and a
launch count each:

* ``row_gather`` (K5), the sequencers' whole-block step lookups: a CTA
  stages its row's table (K <= 1,024) in shared memory;
* ``row_gather_long`` (K6), the Sample player's reads: the table read
  through L1/L2.

The source note states what bounds them (bytes) and their launch shape.
The plain version is ``ops/basic.py::table_lookup_rows_plain`` (one
``torch.gather``), which ``table_lookup_rows`` runs for CPU tensors.  This
wrapper launches the kernel for CUDA tensors or raises.
"""

from __future__ import annotations

import torch

from .cuda_lib import CudaLib, I, P, csrc, require_cuda

GATHER_MAX_K = 1024  # the small entry's shared-memory table


class RowGather(CudaLib):
    """One entry of ``csrc/row_gather.cu``: ``run(table, idx)``."""

    def __init__(self, name: str, entry: str, what: str):
        super().__init__(name, csrc("row_gather.cu"), what)
        self.entry = entry

    def run(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``table [R, K]`` (f32 or int32) read at ``idx [R, n]`` (int32):
        a new ``[R, n]`` tensor of the table's dtype."""
        table, idx = table.contiguous(), idx.contiguous()
        device = require_cuda(table, idx)
        if table.dim() != 2 or idx.dim() != 2 or \
                table.shape[0] != idx.shape[0]:
            raise ValueError(f"row gather of a table {tuple(table.shape)} "
                             f"at indices {tuple(idx.shape)}: [R, K], [R, n]")
        if idx.dtype != torch.int32:
            raise TypeError(f"row gather indices of {idx.dtype}: int32")
        dt = {torch.float32: "f32", torch.int32: "i32"}.get(table.dtype)
        if dt is None:
            raise TypeError(f"row gather of a {table.dtype} table: f32 or "
                            "int32")
        rows, k = table.shape
        if k < 1:
            raise ValueError("row gather of an empty table")
        if self.entry == "small" and k > GATHER_MAX_K:
            raise ValueError(f"the small entry takes tables of at most "
                             f"{GATHER_MAX_K} entries, got {k}")
        out = torch.empty(idx.shape, dtype=table.dtype, device=device)
        self.launch(f"srk_gather_{self.entry}_{dt}", [P, P, P, I, I, I],
                    (table.data_ptr(), idx.data_ptr(), out.data_ptr(), rows,
                     k, idx.shape[1]), device)
        return out


ROW_GATHER = RowGather("row_gather", "small", "row-gather kernel (K5)")
ROW_GATHER_LONG = RowGather("row_gather_long", "long",
                            "row-gather kernel, long tables (K6)")
