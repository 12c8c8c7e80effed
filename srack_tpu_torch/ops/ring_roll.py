"""Ring alignment on CUDA: kernel K9 (counterpart:
``srack_tpu/ops/ring_roll.py``, the Pallas kernel ``_align_rows``).

Freeverb keeps each delay line as a ring with a per-voice write index, so
that its state stays interchangeable with the per-sample step.  The block
path wants the lines in time order, oldest first: ``chrono[i] =
buf[(idx + i) % L]``.  ``csrc/ring_align.cu`` does that for every line of
a Freeverb in one launch, and moves each line between the module's ring
layout ``[V, L]`` and the Freeverb kernel's ``[L, V]`` on the way.  Its
entry, ``srk_ring_align_tile`` (:data:`RING_ALIGN`), is a rotated
transpose through a shared-memory tile of 32 voices x
:attr:`RingAlign.tile` positions, each side read or written 128
contiguous bytes a warp access (its source note states the launch shape
and the bound, bytes).

Exact precision's f64 Freeverb lines take the f64 build,
:data:`RING_ALIGN_F64` (``srk_ring_align_tile_f64``): the same template
on 8-byte elements, exact; the JAX package rotates its f64 rings in XLA,
so it ports no Pallas kernel.  :func:`ring_align_for` picks the build by
dtype.

The plain version is :func:`ring_align_plain`, a ``torch.gather`` with the
rotated index (and a transpose where the layout changes); that gather is
also the one PyTorch call that computes the same function.
:func:`ring_align` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaLib, I, P, csrc, require_cuda

MAX_LINES = 32  # SRK_RING_MAX_LINES


def ring_align_plain(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[..., L]`` rings and ``[...]`` write indices -> time order."""
    length = buf.shape[-1]
    pos = (idx.to(torch.int64).unsqueeze(-1)
           + torch.arange(length, device=buf.device)) % length
    return torch.gather(buf, -1, pos.expand(buf.shape))


TILE_MIN, TILE_MAX = 32, 256  # SRK_RING_TILE_MIN, _MAX


class RingAlign(CudaLib):
    """K9: :meth:`move` of up to 32 lines in one launch (``tile``:
    positions per tile); for lines of ``dtype`` (f32, or f64: the ``_f64``
    entry)."""

    def __init__(self, name: str, what: str, tile: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(name, csrc("ring_align.cu"), what)
        self.tile = tile
        self.dtype = dtype
        self.suffix = "_f64" if dtype == torch.float64 else ""

    def move(self, src: list, dst: list, lens, v: int, idx=None,
             shifts=None, src_lines: bool = False,
             dst_lines: bool = False) -> None:
        """Line j of ``src`` in time order into line j of ``dst``:
        ``dst[j][v, i] = src[j][v, (idx[j, v] + shifts[j] + i) % lens[j]]``.
        Each line is its own contiguous tensor of this build's dtype, a
        ``[V, L_j]`` ring or, with ``src_lines`` / ``dst_lines``, an
        ``[L_j, V]`` block;
        ``idx``: ``[n_lines, V]`` int32 or None (0); ``shifts``: ints or
        None (0)."""
        self.launch(*self.call(src, dst, lens, v, idx, shifts, src_lines,
                               dst_lines))

    def call(self, src: list, dst: list, lens, v: int, idx=None,
             shifts=None, src_lines: bool = False, dst_lines: bool = False):
        """The checked arguments of :meth:`move`'s launch: ``(entry,
        argtypes, args, device)``; the tensors must outlive a launch."""
        n = len(lens)
        if not (len(src) == len(dst) == n <= MAX_LINES):
            raise ValueError(f"ring alignment of {len(src)} into {len(dst)} "
                             f"lines of {n} lengths (at most {MAX_LINES})")
        for t, length in zip(list(src) + list(dst), list(lens) * 2):
            if t.numel() != v * length or t.dtype != self.dtype:
                raise ValueError(f"a line of {t.numel()} {t.dtype} for "
                                 f"{v} voices of length {length}")
        if idx is not None and (tuple(idx.shape) != (n, v)
                                or idx.dtype != torch.int32):
            raise ValueError(f"write indices {tuple(idx.shape)} {idx.dtype}, "
                             f"expected [{n}, {v}] int32")
        device = require_cuda(*src, *dst,
                              *([] if idx is None else [idx]))
        shifts = [0] * n if shifts is None else [int(s) for s in shifts]
        args = ((P * n)(*[t.data_ptr() for t in src]),
                (P * n)(*[t.data_ptr() for t in dst]),
                (ctypes.c_int * n)(*lens), (ctypes.c_int * n)(*shifts),
                None if idx is None else idx.data_ptr(), n, v,
                int(src_lines), int(dst_lines))
        argtypes = [P, P, P, P, P, I, I, I, I]
        if not (TILE_MIN <= self.tile <= TILE_MAX and self.tile % 32 == 0):
            raise ValueError(f"a tile of {self.tile} positions (a multiple "
                             f"of 32 from {TILE_MIN} to {TILE_MAX})")
        return (f"srk_ring_align_tile{self.suffix}", argtypes + [I],
                args + (self.tile,), device)


# the tile's 128 positions: chip_smoke.py phase 15 times 32 to 256
RING_ALIGN = RingAlign("ring_align", "ring-alignment kernel (K9)", 128)
RING_ALIGN_F64 = RingAlign("ring_align_f64",
                           "ring-alignment kernel, f64 build (K9)", 128,
                           torch.float64)


def ring_align_for(dtype: torch.dtype) -> RingAlign:
    """The main path's K9 for lines of ``dtype``: the f64 build for exact
    precision's lines, else the f32 one."""
    return RING_ALIGN_F64 if dtype == torch.float64 else RING_ALIGN


def ring_align(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[R, L]`` rings and ``[R]`` indices -> ``[R, L]`` in time order: one
    K9 launch for CUDA tensors, the plain gather for CPU tensors."""
    if not buf.is_cuda:
        return ring_align_plain(buf, idx)
    r, length = buf.shape
    out = torch.empty((r, length), dtype=buf.dtype, device=buf.device)
    ring_align_for(buf.dtype).move(
        [buf.contiguous()], [out], (length,), r,
        idx=idx.to(torch.int32).reshape(1, r).contiguous())
    return out
