"""Fast-mode DSP primitives (counterpart: ``srack_tpu/ops/basic.py``).

Per-sample register math shared by the module steps.  Each function is
elementwise over any shape and evaluates the same f32 expression, in the
same order, as its JAX twin; ``csrc/modules.cuh`` holds the CUDA copies.
Python float constants combine with f32 tensors as f32 (rounded once), the
same rule jnp applies to its weak-typed constants.
"""

from __future__ import annotations

import torch

_TWO32 = 4294967296.0  # 2**32


_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """A new 64-bit seed from ``key`` and ``data`` (the port's counterpart
    of ``jax.random.fold_in`` for the ints that seed ``torch.Generator``):
    the splitmix64 finaliser of ``key`` mixed with ``data``.  Distinct
    ``data`` give unrelated seeds; it does not reproduce JAX's bits."""
    z = (int(key) * 0x9E3779B97F4A7C15 + int(data) + 0x632BE59BD9B4E019)
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def transition(last_above: torch.Tensor, val: torch.Tensor):
    """Rising-edge detector: fires when ``val`` rises above 0.0 from <= 0.0.

    ``last_above`` starts True so a high signal at t=0 does not fire.
    Returns ``(new_last_above, fired)``.
    """
    above = val > 0.0
    fired = torch.logical_and(above, torch.logical_not(last_above))
    return above, fired


def transition_init() -> torch.Tensor:
    return torch.tensor(True)


def phase_fixed_init() -> torch.Tensor:
    """Fixed-point phase: an int32 whose bit pattern is a uint32 fraction of
    a cycle (1 ulp = 2^-32).  Two's-complement adds wrap mod 2^32, in torch
    as in the CUDA kernel (which adds as ``uint32_t``)."""
    return torch.tensor(0, dtype=torch.int32)


def f32_mod1(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mod(x, 1.0)``: the C remainder, moved into [0, 1) when negative."""
    r = torch.fmod(x, 1.0)
    return torch.where(r < 0.0, r + 1.0, r)


def delta_to_fixed(delta: torch.Tensor) -> torch.Tensor:
    """f32 per-sample phase increment (cycles) -> fixed-point int32.

    ``delta`` is wrapped to [0, 1) first; values >= 2^31 are represented by
    their wrapped negative bit pattern.  Each branch converts only values in
    int32 range; the ``where`` then picks the one that was."""
    d = f32_mod1(delta)
    u = d * _TWO32
    lo = d < 0.5
    small = torch.where(lo, u, 0.0).to(torch.int32)
    big = torch.where(lo, 0.0, u - _TWO32).to(torch.int32)
    return torch.where(lo, small, big)


# sin(pi*s) odd minimax coefficients on [-1, 1], max abs err 5.9e-6
_SINPI_ODD = (3.1415278983587682, -5.166401774862824, 2.5427129265355948,
              -0.5818593382178273, 0.0640261396169806)

# exp2 fractional-part minimax on [0, 1), deg 6, max rel err 1.9e-9
_EXP2_COEF = (1.0000000018561317, 0.6931469838082407, 0.24022983671380171,
              0.05548333989618637, 0.009678845362499107,
              0.0012439646470418081, 0.00021702400581973962)


def signed_turns(pos: torch.Tensor) -> torch.Tensor:
    """int32 fixed-point phase -> signed turns in [-1, 1)."""
    return pos.to(torch.float32) * (1.0 / 2147483648.0)


def fast_sinpi(s: torch.Tensor) -> torch.Tensor:
    """sin(pi*s) for s in [-1, 1]: 5-term odd polynomial, Horner form."""
    z = s * s
    p = torch.full_like(s, _SINPI_ODD[4])
    for k in (3, 2, 1, 0):
        p = p * z + _SINPI_ODD[k]
    return s * p


def fast_exp2(x: torch.Tensor) -> torch.Tensor:
    """2**x: deg-6 polynomial on the fractional part times 2**floor(x), the
    latter built as float exponent bits (an int32 -> f32 bit view)."""
    x = torch.clamp(x, -126.0, 126.0)
    xi = torch.floor(x)
    f = x - xi
    p = torch.full_like(x, _EXP2_COEF[6])
    for k in (5, 4, 3, 2, 1, 0):
        p = p * f + _EXP2_COEF[k]
    e = (xi.to(torch.int32) + 127) << 23
    scale = e.view(torch.float32)
    return p * scale


def table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx]`` for a small table ``[..., K]`` and an int32
    ``idx`` (per voice), the answer of the JAX package's binary select tree.

    For ``idx`` in ``[0, K)`` it is the entry at ``idx``.  The tree reads
    only the low ``ceil(log2 K)`` bits of ``idx`` and pads the table to a
    power of two with its last entry, so any other ``idx`` (negative, or at
    or past ``K``) reads ``table[min(idx & (P - 1), K - 1)]`` with ``P`` the
    padded size.  Here that is one gather."""
    k = table.shape[-1]
    p = 1
    while p < k:
        p *= 2
    j = torch.clamp(torch.bitwise_and(idx, p - 1), max=k - 1).to(torch.int64)
    batch = torch.broadcast_shapes(table.shape[:-1], j.shape)
    return torch.gather(table.expand(batch + (k,)), -1,
                        j.expand(batch).unsqueeze(-1)).squeeze(-1)


def poly_blep_signed(u: torch.Tensor) -> torch.Tensor:
    """polyBLEP in the signed-phase domain: ``sign(-u) * (1 - |u|)^2`` for
    ``|u| < 1``, else 0 (``u`` is the signed distance from the
    discontinuity in units of dt)."""
    au = torch.abs(u)
    w = 1.0 - au
    mag = torch.where(au < 1.0, w * w, 0.0)
    return torch.where(u >= 0.0, -mag, mag)
