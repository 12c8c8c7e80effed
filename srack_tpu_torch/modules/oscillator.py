"""Oscillator module (counterpart: ``srack_tpu/modules/oscillator.py``).

Pitch convention 1.0 CV = 1 octave with 0.0 -> 440 Hz; sine, square and saw
outputs with polyBLEP band-limiting; a Sync input that resets phase on a
rising edge.

* Fast precision: the phase is an int32 fixed-point accumulator that wraps
  mod 2^32 (zero drift over long renders), with ``pos_g``, a float shadow of
  the phase whose primal contribution cancels exactly (straight-through)
  and which carries d(phase)/d(pitch) for autograd.
* Exact precision (``cfg.exact``): the reference's f64 phase.  ``pos`` and
  the increment ``delta = 440 * 2^val / sr`` are ``torch.float64`` (no
  ``pos_g``), the phase wraps by floor-mod (``torch.remainder``, as
  ``jnp.mod``), the waves are computed in f64 (``sin``, the f64
  :func:`~..ops.basic.poly_blep`) and cast to f32.  The block form takes
  an f64 prefix sum, which kernel K4's f64 entries run on CUDA tensors.

Noise is a hoisted lane of uniform draws (``make_xs``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import AudioConfig
from ..ops.basic import (block_transitions, delta_to_fixed, fast_cumsum,
                         fast_exp2, fast_sinpi, fold_in, fold_in_rows,
                         forward_fill, phase_fixed_init, poly_blep,
                         poly_blep_signed, signed_turns, t_index, transition,
                         transition_init, wrap_i32)
from ..ops.noise_kernel import noise_lanes
from .base import CV_DTYPE, ModuleDef, const_ports, cv

F64 = torch.float64


def _osc_make(cfg: AudioConfig, val: float = 0.0, antialiasing: bool = True):
    return ("antialias", bool(antialiasing)), {"val": cv(val)}


def _osc_init_state(cfg: AudioConfig, statics, device=None):
    if cfg.exact:
        return {"pos": torch.zeros((), dtype=F64, device=device),
                "sync_last": transition_init(device)}
    return {"pos": phase_fixed_init(device),
            "pos_g": torch.zeros((), dtype=CV_DTYPE, device=device),
            "sync_last": transition_init(device)}


def _pitch(cfg: AudioConfig, octs: torch.Tensor):
    """``440 * 2^octs / sr`` as f32 cycles per sample, and its fixed-point
    increment.  ``440 / sr`` is folded in double and rounded to f32 once."""
    delta = fast_exp2(octs) * (440.0 / cfg.sample_rate)
    return delta, delta_to_fixed(delta)


def _exact_pitch(cfg: AudioConfig, val, cv_in=None):
    """The exact increment ``440 * 2^octs / sr`` in f64, in the JAX
    package's order (no pre-folded ``440 / sr``); ``octs`` is ``val`` plus
    the CV, each taken to f64 first."""
    octs = val.to(F64) if cv_in is None else cv_in.to(F64) + val.to(F64)
    return 440.0 * torch.exp2(octs) / cfg.sample_rate


def _osc_derive(cfg: AudioConfig, statics, params, connected):
    """With the CV input unconnected the pitch chain is loop-invariant."""
    if connected and connected[0]:
        return {}
    if cfg.exact:
        return {"delta": _exact_pitch(cfg, params["val"])}
    delta, dfix = _pitch(cfg, params["val"])
    return {"delta": delta, "dfix": dfix}


def _exact_waves(pos, delta, antialias: bool):
    """The exact waves of an f64 phase in [0, 1): sine, square and saw in
    f64, cast to f32 (the saw from the f32 phase, as the reference)."""
    sine = torch.sin(pos * (2.0 * math.pi)).to(CV_DTYPE)
    naive_square = torch.where(pos < 0.5, -1.0, 1.0).to(CV_DTYPE)
    naive_saw = pos.to(CV_DTYPE) * 2.0 - 1.0
    if not antialias:
        return sine, naive_square, naive_saw
    blep0 = poly_blep(pos, delta)
    blep_half = poly_blep(torch.remainder(pos + 0.5, 1.0), delta)
    square = naive_square - (blep0 - blep_half).to(CV_DTYPE)
    saw = naive_saw - blep0.to(CV_DTYPE)
    return sine, square, saw


def _osc_step_exact(cfg: AudioConfig, statics, params, state, ins):
    """One sample of the f64 phase: the reset, the increment (hoisted by
    derive, else per sample), the floor-mod wrap, the waves."""
    (_, antialias) = statics
    cv_in, sync_in = ins
    if sync_in is None:
        sync_last, fired = torch.zeros((), dtype=torch.bool), None
    else:
        sync_last, fired = transition(state["sync_last"], sync_in)
    pos = state["pos"] if fired is None else torch.where(fired, 0.0,
                                                         state["pos"])
    if cv_in is None and "delta" in params:
        delta = params["delta"]  # hoisted by derive
    else:
        delta = _exact_pitch(cfg, params["val"], cv_in)
    new_pos = torch.remainder(pos + delta, 1.0)
    return ({"pos": new_pos, "sync_last": sync_last},
            _exact_waves(pos, delta, antialias))


def _osc_step(cfg: AudioConfig, statics, params, state, ins, x=None,
              with_ste: bool = True):
    if cfg.exact:
        return _osc_step_exact(cfg, statics, params, state, ins)
    (_, antialias) = statics
    cv_in, sync_in = ins
    if sync_in is None:
        # Sync unconnected: no edge detector, and the stored detector state
        # becomes False (what transition() gives on a constant-0 input)
        sync_last, fired = torch.zeros((), dtype=torch.bool), None
    else:
        sync_last, fired = transition(state["sync_last"], sync_in)

    def reset(v):
        return v if fired is None else torch.where(fired, 0, v)

    pos_i = reset(state["pos"])
    if cv_in is None and "dfix" in params:
        delta, dfix = params["delta"], params["dfix"]  # hoisted by derive
    else:
        octs = params["val"] if cv_in is None else cv_in + params["val"]
        delta, dfix = _pitch(cfg, octs)
    acc = reset(state["pos_g"])
    # straight-through phase tangent: exactly 0 in the primal, but
    # d(ste)/d(delta-history) == 1.  Engines that are never differentiated
    # skip it; outputs are bit-identical either way.
    ste = acc - acc.detach() if with_ste else None
    new_pos = pos_i + dfix  # int32 add, wraps mod 2^32
    new_acc = acc + delta
    sine, square, saw = _fast_waves(pos_i, delta, ste, antialias)
    new_state = {"pos": new_pos, "pos_g": new_acc, "sync_last": sync_last}
    return new_state, (sine, square, saw)


def _fast_waves(pos_i, delta, ste, antialias: bool):
    """Waveforms in the signed-turns domain, s = signed_turns(pos) in [-1, 1):
    sine = sinpi(s); square = -1 where pos >= 0 else +1; saw = s + square;
    both polyBLEP corrections are sign(-u)(1-|u|)^2 in units of dt, and the
    half-phase discontinuity's signed distance is exactly the naive saw."""
    s = signed_turns(pos_i)
    if ste is not None:
        s = s + 2.0 * ste
    sine = fast_sinpi(s)
    naive_square = torch.where(pos_i >= 0, -1.0, 1.0)
    naive_saw = s + naive_square
    if antialias:
        inv2dt = 0.5 / delta
        blep0 = poly_blep_signed(s * inv2dt)
        blep_half = poly_blep_signed(naive_saw * inv2dt)
        square = naive_square - (blep0 - blep_half)
        saw = naive_saw - blep0
    else:
        square = naive_square
        saw = naive_saw
    return sine, square, saw


def _osc_step_nograd(cfg: AudioConfig, statics, params, state, ins, x=None):
    return _osc_step(cfg, statics, params, state, ins, x, with_ste=False)


def _osc_block(cfg: AudioConfig, statics, params, state, ins, x, n: int):
    """Whole-block oscillator over ``[V, n]`` rows: the phase by a
    (segmented) prefix sum.

    ``pos += dfix`` is a prefix sum of int32 increments, exact under
    two's-complement wrap; a Sync reset makes it segmented (the phase
    restarts at the last rising edge), solved with :func:`forward_fill`.  A
    constant rate (no CV, ``val`` not automated: LFOs, clocks) takes the
    closed form ``dfix * t`` and no scan.  The waves are :func:`_fast_waves`
    of the same phases, so they equal the per-sample step bit for bit; the
    end value of the float shadow ``pos_g`` is an f32 sum and is only
    close.  Scans launch kernel K4 on CUDA tensors (``ops/basic.py``).

    Exact precision: :func:`_osc_block_exact`."""
    if cfg.exact:
        return _osc_block_exact(cfg, statics, params, state, ins, n)
    (_, antialias) = statics
    cv_in, sync_in = ins
    tidx = t_index(n, state["pos"].device)
    # an automated ``val`` arrives as a [V, n] lane: the rate varies
    val_varies = params["val"].dim() == 2
    const_rate = cv_in is None and not val_varies
    if const_rate and "dfix" in params:
        delta_f = params["delta"].unsqueeze(-1)
        dfix = params["dfix"].unsqueeze(-1)
    else:
        val = params["val"] if val_varies else params["val"].unsqueeze(-1)
        delta_f, dfix = _pitch(cfg, val if cv_in is None else cv_in + val)
    full = (state["pos"].shape[0], n)
    if const_rate:
        excl = wrap_i32(dfix.to(torch.int64) * tidx)  # mod 2^32, as int32
        incl = excl + dfix
    else:
        dfix = dfix.expand(full).contiguous()
        incl = fast_cumsum(dfix)  # int32 adds wrap mod 2^32
        excl = incl - dfix
    delta_f = delta_f.expand(full)
    dfix = dfix.expand(full)
    pos0 = state["pos"].unsqueeze(-1)
    if sync_in is None:
        sync_last = state["sync_last"]
        pos_acc = pos0 + excl
        next_pos = pos0[:, 0] + incl[:, -1]
    else:
        sync_last, fires = block_transitions(state["sync_last"], sync_in)
        excl_at_fire, fired_yet = forward_fill(excl.contiguous(), fires)
        pos_acc = torch.where(fired_yet, excl - excl_at_fire, pos0 + excl)
        next_pos = pos_acc[:, -1] + dfix[:, -1]
    # the float shadow's end value, by the step's reset-then-accumulate law
    acc0 = state["pos_g"]
    if sync_in is None:
        acc_end = acc0 + delta_f.sum(dim=-1)
    else:
        cum_f = fast_cumsum(delta_f.contiguous())
        excl_f = cum_f - delta_f
        excl_f_fire, fired_yet_f = forward_fill(excl_f, fires)
        acc_end = torch.where(fired_yet_f[:, -1],
                              cum_f[:, -1] - excl_f_fire[:, -1],
                              acc0 + cum_f[:, -1])
    sine, square, saw = _fast_waves(pos_acc, delta_f, None, antialias)
    new_state = {"pos": next_pos, "pos_g": acc_end, "sync_last": sync_last}
    return new_state, (sine, square, saw)


def _osc_block_exact(cfg: AudioConfig, statics, params, state, ins, n: int):
    """The exact whole-block oscillator over ``[V, n]`` rows: the f64 phase
    by a (segmented) f64 prefix sum of the increments, the closed form
    ``delta * t`` at a constant rate, then the floor-mod wrap and the
    per-sample step's waves.  The prefix sum reassociates the step's serial
    additions, so it differs from the step by rounding only (the JAX
    package's own block-vs-scan tolerance, 5e-6)."""
    (_, antialias) = statics
    cv_in, sync_in = ins
    tidx = t_index(n, state["pos"].device)
    val_varies = params["val"].dim() == 2
    const_rate = cv_in is None and not val_varies
    if const_rate and "delta" in params:
        delta = params["delta"].unsqueeze(-1)
    else:
        val = params["val"] if val_varies else params["val"].unsqueeze(-1)
        delta = _exact_pitch(cfg, val, cv_in)
    full = (state["pos"].shape[0], n)
    if const_rate:
        excl = delta * tidx.to(F64)
        incl = delta * (tidx + 1.0)
    else:
        delta = delta.expand(full).contiguous()
        incl = fast_cumsum(delta)
        excl = incl - delta
    delta = delta.expand(full)
    pos0 = state["pos"].unsqueeze(-1)
    if sync_in is None:
        sync_last = state["sync_last"]
        pos_acc = pos0 + excl
        next_pos = pos0[:, 0] + incl[:, -1]
    else:
        sync_last, fires = block_transitions(state["sync_last"], sync_in)
        excl_at_fire, fired_yet = forward_fill(
            excl.expand(full).contiguous(), fires)
        pos_acc = torch.where(fired_yet, excl - excl_at_fire, pos0 + excl)
        next_pos = pos_acc[:, -1] + delta[:, -1]
    pos_f = torch.remainder(pos_acc, 1.0)
    new_state = {"pos": torch.remainder(next_pos, 1.0),
                 "sync_last": sync_last}
    return new_state, _exact_waves(pos_f, delta, antialias)


_osc_nin, _osc_inlabels = const_ports(2, ("CV", "Sync"))
_osc_nout, _osc_outlabels = const_ports(3, ("Sine", "Square", "Sawtooth"))

OSCILLATOR = ModuleDef(
    type_name="Oscillator",
    make=_osc_make,
    num_inputs=_osc_nin,
    num_outputs=_osc_nout,
    input_labels=_osc_inlabels,
    output_labels=_osc_outlabels,
    init_state=_osc_init_state,
    step=_osc_step,
    step_nograd=_osc_step_nograd,
    block=_osc_block,
    derive=_osc_derive,
    # per-sample pitch automation: the block form takes the prefix-sum path
    # when ``val`` arrives as a [V, n] lane
    auto_block_params=frozenset({"val"}),
    cuda_fn="srk_oscillator",
    cuda_adj="srk_oscillator_adj",
)


# ---------------------------------------------------------------------------
# Noise
# ---------------------------------------------------------------------------

def _noise_make(cfg: AudioConfig, seed: int = 0):
    # int64 holds the JAX package's uint32 seeds; the seed is folded into
    # the rows' keys on the host and never reaches a kernel
    return ("noise",), {"seed": torch.tensor(int(seed), dtype=torch.int64)}


def _noise_init_state(cfg: AudioConfig, statics, device=None):
    return {}


def noise_row_keys(key: int, seeds, voice0: int = 0) -> np.ndarray:
    """The 64-bit keys (as int64) of the rows of a Noise module's ``[V]``
    ``seeds``: the voice with index ``g`` in the whole batch (``voice0``
    plus its index here) is keyed by ``fold_in(fold_in(key, seed), g)``."""
    seeds = np.asarray(seeds).reshape(-1)
    by_seed = {int(s): fold_in(key, int(s)) for s in np.unique(seeds)}
    base = np.array([by_seed[int(s)] for s in seeds], dtype=np.uint64)
    return fold_in_rows(base, voice0 + np.arange(len(seeds))).view(np.int64)


def _noise_make_xs(cfg: AudioConfig, statics, params, key: int, n: int,
                   voice0: int = 0):
    """White noise in [-1, 1), a counter-based draw
    (:mod:`..ops.noise_kernel`: a kernel on the card).

    ``key`` is the render's key already folded with this module's index.
    Each voice's row has a key of its own (:func:`noise_row_keys`), from
    its index in the whole batch (``voice0`` plus its index in this call:
    a farm's shard passes its first voice).  So a voice's lane depends
    only on the key, the module, its seed and that index, never on the
    other voices of the call, and a shard draws the rows the whole batch
    would.  The draws are not JAX's threefry bits: parity tests feed both
    packages one numpy lane as a driver instead."""
    seed = params["seed"]
    keys = torch.from_numpy(noise_row_keys(
        key, seed.reshape(-1).cpu().numpy(), voice0)).to(seed.device)
    return noise_lanes(keys, n).reshape(tuple(seed.shape) + (n,))


def _noise_step(cfg: AudioConfig, statics, params, state, ins, x=None):
    return state, (x,)


_noise_nin, _noise_inlabels = const_ports(0, ())
_noise_nout, _noise_outlabels = const_ports(1, (None,))

NOISE = ModuleDef(
    type_name="Noise",
    make=_noise_make,
    num_inputs=_noise_nin,
    num_outputs=_noise_nout,
    input_labels=_noise_inlabels,
    output_labels=_noise_outlabels,
    init_state=_noise_init_state,
    step=_noise_step,
    make_xs=_noise_make_xs,
    host_params=frozenset({"seed"}),
    cuda_fn="srk_noise",
    cuda_adj="srk_noise_adj",
)
