"""DSP primitives (counterpart: ``srack_tpu/ops/basic.py``).

Per-sample register math shared by the module steps.  Each function is
elementwise over any shape and evaluates the same f32 expression, in the
same order, as its JAX twin; ``csrc/modules.cuh`` holds the CUDA copies.
Python float constants combine with f32 tensors as f32 (rounded once), the
same rule jnp applies to its weak-typed constants.

Below them, the block engine's whole-block primitives over ``[V, n]`` rows
and the scan wrappers, which launch kernel K4 for CUDA tensors (its f64
build for exact precision's f64 rows) and run their plain versions, the
JAX package's log-doubling passes, for CPU tensors; and the whole-row table lookup, which launches kernel K5 or K6
for CUDA tensors and runs one ``torch.gather`` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

_TWO32 = 4294967296.0  # 2**32


_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """A new 64-bit seed from ``key`` and ``data`` (the port's counterpart
    of ``jax.random.fold_in`` for the ints that key the Noise lanes):
    the splitmix64 finaliser of ``key`` mixed with ``data``.  Distinct
    ``data`` give unrelated seeds; it does not reproduce JAX's bits."""
    z = (int(key) * 0x9E3779B97F4A7C15 + int(data) + 0x632BE59BD9B4E019)
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in_rows(keys, data):
    """:func:`fold_in` of each ``keys[i]`` with ``data[i]``, over numpy
    arrays (uint64 arithmetic, which wraps mod 2**64 as the masks above
    do): row for row the same seeds as the scalar form."""
    z = (np.asarray(keys, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         + np.asarray(data, dtype=np.uint64)
         + np.uint64(0x632BE59BD9B4E019))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def transition(last_above: torch.Tensor, val: torch.Tensor):
    """Rising-edge detector: fires when ``val`` rises above 0.0 from <= 0.0.

    ``last_above`` starts True so a high signal at t=0 does not fire.
    Returns ``(new_last_above, fired)``.
    """
    above = val > 0.0
    fired = torch.logical_and(above, torch.logical_not(last_above))
    return above, fired


def transition_init(device=None) -> torch.Tensor:
    return torch.full((), True, dtype=torch.bool, device=device)


def phase_fixed_init(device=None) -> torch.Tensor:
    """Fixed-point phase: an int32 whose bit pattern is a uint32 fraction of
    a cycle (1 ulp = 2^-32).  Two's-complement adds wrap mod 2^32, in torch
    as in the CUDA kernel (which adds as ``uint32_t``)."""
    return torch.zeros((), dtype=torch.int32, device=device)


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


class _Clip(torch.autograd.Function):
    """``torch.clamp``'s values with ``jnp.clip``'s derivative."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        d = torch.where((x > lo) & (x < hi), 1.0,
                        torch.where((x == lo) | (x == hi), 0.5, 0.0))
        return g * d.to(g.dtype), None, None


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``torch.clamp``'s values and, under
    autograd, JAX's derivative, 1 inside, 0 outside and 1/2 at a bound
    (``jnp.clip`` is ``minimum(maximum(x, lo), hi)``, whose ties split the
    derivative; ``torch.clamp`` takes 1 there).  A saturated Moog ladder
    meets its bounds exactly, so the tie is not a corner case."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Clip.apply(x, lo, hi)
    return torch.clamp(x, lo, hi)


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
    x = clip(x, -126.0, 126.0)
    xi = torch.floor(x)
    f = x - xi
    p = torch.full_like(x, _EXP2_COEF[6])
    for k in (5, 4, 3, 2, 1, 0):
        p = p * f + _EXP2_COEF[k]
    e = (xi.to(torch.int32) + 127) << 23
    scale = e.view(torch.float32)
    return p * scale


def _select_index(idx: torch.Tensor, k: int) -> torch.Tensor:
    """The JAX select tree's index into a table of ``k`` entries: ``min(idx
    & (P - 1), k - 1)`` with ``P`` the next power of two >= ``k``."""
    p = 1
    while p < k:
        p *= 2
    return torch.clamp(torch.bitwise_and(idx, p - 1), max=k - 1).to(
        torch.int64)


def table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx]`` for a small table ``[..., K]`` and an int32
    ``idx`` (per voice), the answer of the JAX package's binary select tree.

    For ``idx`` in ``[0, K)`` it is the entry at ``idx``.  The tree reads
    only the low ``ceil(log2 K)`` bits of ``idx`` and pads the table to a
    power of two with its last entry, so any other ``idx`` (negative, or at
    or past ``K``) reads ``table[min(idx & (P - 1), K - 1)]`` with ``P`` the
    padded size.  Here that is one gather."""
    k = table.shape[-1]
    j = _select_index(idx, k)
    batch = torch.broadcast_shapes(table.shape[:-1], j.shape)
    return torch.gather(table.expand(batch + (k,)), -1,
                        j.expand(batch).unsqueeze(-1)).squeeze(-1)


def poly_blep(t: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """polyBLEP band-limiting correction of the exact (f64) phase ``t`` in
    [0, 1) with increment ``dt``: the reference's piecewise quadratic, a
    2-sample smoothing of the discontinuity at phase 0, branchless.  With
    ``dt == 0`` both region predicates are false (``t`` is in [0, 1)), so
    the selects give 0 and never the division's values."""
    lo = t / dt
    lo_val = lo + lo - lo * lo - 1.0
    hi = (t - 1.0) / dt
    hi_val = hi * hi + hi + hi + 1.0
    return torch.where(t < dt, lo_val,
                       torch.where(t > 1.0 - dt, hi_val, 0.0))


def poly_blep_signed(u: torch.Tensor) -> torch.Tensor:
    """polyBLEP in the signed-phase domain: ``sign(-u) * (1 - |u|)^2`` for
    ``|u| < 1``, else 0 (``u`` is the signed distance from the
    discontinuity in units of dt).  ``|u|`` is a select, not ``abs``: the
    same values, and autograd takes d|u|/du = +1 at u = 0 as JAX does
    (torch's ``abs`` takes 0 there, and every phase starts at u = 0)."""
    au = torch.where(u >= 0.0, u, -u)
    w = 1.0 - au
    mag = torch.where(au < 1.0, w * w, 0.0)
    return torch.where(u >= 0.0, -mag, mag)


# ---------------------------------------------------------------------------
# Whole-block primitives (the block engine's ``[V, n]`` rows: one row per
# voice, time on the last axis, where the JAX package scans axis 0 of a
# vmapped ``[n]``)
# ---------------------------------------------------------------------------

def t_index(n: int, device=None) -> torch.Tensor:
    """``arange(n)`` as int32, to broadcast against ``[V, n]`` rows."""
    return torch.arange(n, dtype=torch.int32, device=device)


def block_lane(x, v: int, n: int, fill=0.0, device=None) -> torch.Tensor:
    """A per-sample input as ``[V, n]`` f32 (a view where it broadcasts);
    ``None`` becomes the constant ``fill`` (the unconnected fallback)."""
    if x is None:
        return torch.full((v, n), fill, dtype=torch.float32, device=device)
    return torch.as_tensor(x).to(device).expand(v, n)


def block_transitions(last_above: torch.Tensor, vals: torch.Tensor):
    """:func:`transition` folded over ``[V, n]`` rows with one shift:
    returns ``(new_last_above [V], fired [V, n])``."""
    above = vals > 0.0
    prev = torch.cat([last_above.reshape(-1, 1).expand(above.shape[0], 1)
                      .to(above.dtype), above[:, :-1]], dim=1)
    return above[:, -1], torch.logical_and(above, torch.logical_not(prev))


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced mod 2^32 into int32 (two's complement)."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _shifted(x: torch.Tensor, shift: int, fill) -> torch.Tensor:
    """``x`` shifted ``shift < n`` positions later along the last axis,
    front-filled with ``fill``."""
    pad = torch.full(x.shape[:-1] + (shift,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :x.shape[-1] - shift]], dim=-1)


def _log_scan(op, x: torch.Tensor, identity) -> torch.Tensor:
    """Inclusive scan along the last axis by log-step doubling
    (Hillis-Steele), pass for pass as the JAX package's ``_log_scan``.
    Exact for int32 (adds wrap); for floats it reassociates the sum."""
    shift = 1
    while shift < x.shape[-1]:
        x = op(x, _shifted(x, shift, identity))
        shift <<= 1
    return x


# The plain versions of the row-scan kernel K4 (``ops/scan_kernel.py``):
# the log-doubling forms.  The public wrappers below launch K4 for CUDA
# tensors and run these for CPU tensors.

def cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    return _log_scan(torch.add, x, 0)


def cummax_plain(x: torch.Tensor) -> torch.Tensor:
    if x.dtype.is_floating_point:
        ident = float("-inf")
    else:
        ident = torch.iinfo(x.dtype).min
    return _log_scan(torch.maximum, x, ident)


def forward_fill_multi_plain(values: tuple, mask: torch.Tensor):
    vals, ok = list(values), mask
    shift = 1
    while shift < mask.shape[-1]:
        s_ok = _shifted(ok, shift, False)
        for i, v in enumerate(vals):
            vals[i] = torch.where(ok, v, _shifted(v, shift, 0))
        ok = torch.logical_or(ok, s_ok)
        shift <<= 1
    return tuple(vals), ok


def affine_scan_plain(a, b: torch.Tensor):
    A = torch.as_tensor(a, dtype=b.dtype, device=b.device).expand(b.shape)
    B = b
    shift = 1
    while shift < b.shape[-1]:
        A_s = _shifted(A, shift, 1.0)
        B_s = _shifted(B, shift, 0.0)
        B = A * B_s + B
        A = A * A_s
        shift <<= 1
    return A, B


def linear_recurrence_plain(a, b: torch.Tensor):
    A = torch.as_tensor(a, dtype=b.dtype, device=b.device).expand(b.shape)
    Y = b
    shift = 1
    while shift < b.shape[-1]:
        A_s = _shifted(A, shift, 1.0)
        Y_s = _shifted(Y, shift, 0.0)
        Y = Y_s * A + Y
        A = A_s * A
        shift <<= 1
    return A, Y


def _k4(dtype=None):
    """Kernel K4's wrapper for rows of ``dtype``: its f64 build
    (``row_scan_f64``, exact precision's rows) or the f32/int32 one."""
    from . import scan_kernel
    return (scan_kernel.ROW_SCAN_F64 if dtype == torch.float64
            else scan_kernel.ROW_SCAN)


def fast_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the last axis (f32, f64 or int32,
    wrapping)."""
    return _k4(x.dtype).run("sum", (x,))[0] if x.is_cuda \
        else cumsum_plain(x)


def fast_cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max along the last axis."""
    return _k4(x.dtype).run("max", (x,))[0] if x.is_cuda \
        else cummax_plain(x)


def forward_fill_multi(values: tuple, mask: torch.Tensor):
    """For each position, each array's most recent entry where ``mask``
    held (inclusive), along the last axis.  Returns ``(filled_tuple,
    any_valid)``; where ``any_valid`` is False the filled values are
    unspecified (the kernel gives 0, the plain version what its passes
    leave)."""
    if not mask.is_cuda:
        return forward_fill_multi_plain(tuple(values), mask)
    return _k4().fill(tuple(values), mask)


def forward_fill(values: torch.Tensor, mask: torch.Tensor):
    """:func:`forward_fill_multi` of one array: ``(filled, any_valid)``."""
    (filled,), ok = forward_fill_multi((values,), mask)
    return filled, ok


def monotone_fill(values: torch.Tensor, mask: torch.Tensor):
    """:func:`forward_fill` for non-decreasing, non-negative ``values``: the
    running max of the masked entries; -1 before the first masked entry."""
    neg = torch.tensor(-1, dtype=values.dtype, device=values.device)
    filled = fast_cummax(torch.where(mask, values, neg))
    return filled, filled >= 0


def affine_scan(a, b: torch.Tensor):
    """Compose ``y -> a[t]*y + b[t]`` inclusively along the last axis:
    ``(A, B)`` with ``y[t] = A[t]*y0 + B[t]``."""
    if not b.is_cuda:
        return affine_scan_plain(a, b)
    A = torch.as_tensor(a, dtype=b.dtype, device=b.device).expand(b.shape)
    return _k4().run("affine", (A, b))


def linear_recurrence(a, b: torch.Tensor):
    """``y[t] = a*y[t-1] + b[t]`` from a zero start: ``(A, Y)`` with
    ``A[t] = a^(t+1)``, so ``A*y0 + Y`` solves any start ``y0``."""
    if not b.is_cuda:
        return linear_recurrence_plain(a, b)
    return affine_scan(a, b)


def table_lookup_rows_plain(table: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """The plain version of kernels K5 and K6: each row's table ``[R, K]``
    read at that row's indices ``[R, n]`` with :func:`table_lookup`'s
    answer, in one ``torch.gather``."""
    return torch.gather(table, -1, _select_index(idx, table.shape[-1]))


def table_lookup_rows(table: torch.Tensor, idx: torch.Tensor,
                      long: bool | None = None) -> torch.Tensor:
    """:func:`table_lookup` over whole rows: ``table [R, K]``, int32 ``idx
    [R, n]``.  On CUDA tensors it launches kernel K5 (``row_gather``, the
    table in shared memory) or, for ``long`` tables, K6
    (``row_gather_long``); ``long=None`` takes K6 past K5's 1,024 entries.
    On CPU tensors it runs the plain version."""
    if not idx.is_cuda:
        return table_lookup_rows_plain(table, idx)
    from .gather_kernel import GATHER_MAX_K, ROW_GATHER, ROW_GATHER_LONG
    if long is None:
        long = table.shape[-1] > GATHER_MAX_K
    return (ROW_GATHER_LONG if long else ROW_GATHER).run(table, idx)
