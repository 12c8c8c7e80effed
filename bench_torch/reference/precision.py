"""The number types the reference computes in.

``F32`` is the precision the configurations state (``"fast"``: f32, the
phase in uint32 fixed point).  ``BF16`` is the control's: every operation
rounded to bfloat16.  Whole-signal steps run as torch CPU ops in
``dtype``.  The per-sample recurrences (ADSR, Moog ladder, the combs'
one-pole in bfloat16) run in numpy float32 over the voices, each ``+ - *
/`` followed by ``r``, which rounds its float32 array in place to the
precision (nothing to do in f32: numpy's float32 ops round as the
program's do).
"""

from __future__ import annotations

import numpy as np
import torch

_ROUND = np.uint32(0x7FFF)
_ONE = np.uint32(1)
_SIXTEEN = np.uint32(16)
_HIGH = np.uint32(0xFFFF0000)


def _keep(x):
    return x


def _to_bf16(x):
    """Rounds a float32 array in place to bfloat16 (a scalar into a new 0-d
    array), to nearest with ties to even.  Infinities stay, and so does a
    NaN that arithmetic made (its payload's upper bits are clear)."""
    x = np.asarray(x, dtype=np.float32)
    b = x.view(np.uint32)
    t = b >> _SIXTEEN
    t &= _ONE
    t += _ROUND
    b += t
    b &= _HIGH
    return x


class Precision:
    def __init__(self, name: str, dtype: torch.dtype, r):
        self.name = name
        self.dtype = dtype
        self.r = r

    def array(self, x) -> np.ndarray:
        """``x`` as a new float32 array rounded to this precision."""
        return self.r(np.array(x, dtype=np.float32))

    def const(self, x) -> np.ndarray:
        """A constant as a 0-d float32 array of this precision."""
        return self.array(np.float32(x))

    def signal(self, x: np.ndarray) -> torch.Tensor:
        """A float32 array of this precision as a torch signal."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.dtype)

    def numpy(self, x: torch.Tensor) -> np.ndarray:
        """A torch signal as a float32 array."""
        return x.to(torch.float32).numpy()


F32 = Precision("f32", torch.float32, _keep)
BF16 = Precision("bf16", torch.bfloat16, _to_bf16)
PRECISIONS = {"f32": F32, "bf16": BF16}
