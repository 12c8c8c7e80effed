"""Noise lanes on CUDA: the Noise module's counter-based draw
(counterpart: ``srack_tpu/modules/oscillator.py::_noise_make_xs``, which
draws with ``jax.random.uniform``, threefry in XLA: this kernel ports no
Pallas kernel).

Row ``r`` of a ``[R, n]`` block is one voice's lane, keyed by a 64-bit
word ``k = k1 * 2**32 + k0``; its sample ``t`` is ``(w >> 8) * 2**-23 - 1``
with ``w = L(L(L(t ^ k0) ^ k1) ^ k0)`` and ``L`` the 32-bit bijection
lowbias32.  For one key the samples are a bijection of the counter, and
two lanes coincide (shifted or permuted) only where their whole keys are
equal.  ``csrc/noise_lanes.cu`` writes the block in one elementwise pass
(its source note states the bound, bytes, and the launch shape);
:data:`NOISE_LANES` counts its launches.

The plain version is :func:`noise_lanes_plain`: the same words in int64
tensors (a product of a word, below ``2**32``, and a multiplier taken into
``[-2**31, 2**31)`` stays inside int64 and keeps the low 32 bits of the
unsigned product), in chunks of rows so that the temporaries stay small.
:func:`noise_lanes` runs it for CPU tensors and launches the kernel for
CUDA tensors; both give the same bits.  No PyTorch call computes this
function.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaLib, P, csrc, require_cuda

M32 = 0xFFFFFFFF
# lowbias32's multipliers, the second taken into [-2**31, 2**31)
_MIX = (0x7FEB352D, 0x846CA68B - (1 << 32))
CHUNK = 1 << 22  # elements a pass of the plain version works on
INT_OPS = 30     # integer operations an element (the bound's count)


def _lowbias32_(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 of int64-held 32-bit words, in place."""
    x.bitwise_xor_(x >> 16)
    x.mul_(_MIX[0]).bitwise_and_(M32)
    x.bitwise_xor_(x >> 15)
    x.mul_(_MIX[1]).bitwise_and_(M32)
    return x.bitwise_xor_(x >> 16)


def noise_words_plain(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[R, n]`` int64 words ``w`` (below ``2**32``) of rows keyed by
    ``keys`` (``[R]`` int64 holding each 64-bit key's bits)."""
    k = keys.reshape(-1, 1)
    k0, k1 = k & M32, (k >> 32) & M32
    x = torch.arange(n, dtype=torch.int64, device=k.device) ^ k0
    _lowbias32_(x).bitwise_xor_(k1)
    _lowbias32_(x).bitwise_xor_(k0)
    return _lowbias32_(x)


def noise_lanes_plain(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[R, n]`` f32 in [-1, 1): the words' top 24 bits as ``m * 2**-23
    - 1`` (exact)."""
    keys = keys.reshape(-1)
    out = torch.empty((keys.shape[0], n), dtype=torch.float32,
                      device=keys.device)
    step = max(1, CHUNK // max(n, 1))
    for i in range(0, keys.shape[0], step):
        w = noise_words_plain(keys[i:i + step], n)
        out[i:i + step] = (w >> 8).to(torch.float32).mul_(2.0 ** -23) \
            .sub_(1.0)
    return out


class NoiseLanes(CudaLib):
    """``run(keys, n)``: the ``[R, n]`` lanes of ``R`` keys in one launch."""

    def __init__(self):
        super().__init__("noise_lanes", csrc("noise_lanes.cu"),
                         "Noise-lane kernel")

    def run(self, keys: torch.Tensor, n: int) -> torch.Tensor:
        keys = keys.reshape(-1).contiguous()
        device = require_cuda(keys)
        if keys.dtype != torch.int64:
            raise TypeError(f"Noise keys of {keys.dtype}: int64")
        if not 0 <= n < 2 ** 31:
            raise ValueError(f"a Noise lane of {n} samples (the counter is "
                             f"below 2**31)")
        out = torch.empty((keys.shape[0], n), dtype=torch.float32,
                          device=device)
        self.launch("srk_noise_lanes", [P, P, ctypes.c_longlong,
                                        ctypes.c_int],
                    (keys.data_ptr(), out.data_ptr(), keys.shape[0], n),
                    device)
        return out


NOISE_LANES = NoiseLanes()


def noise_lanes(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[R, n]`` f32 lanes of the ``[R]`` int64 keys: one launch for a
    CUDA tensor, the plain version for a CPU tensor."""
    if not keys.is_cuda:
        return noise_lanes_plain(keys, n)
    return NOISE_LANES.run(keys, n)
