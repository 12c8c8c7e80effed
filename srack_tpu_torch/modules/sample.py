"""WAV sample player (counterpart: ``srack_tpu/modules/sample.py``).

A rising gate edge restarts playback; the playback rate is ``(wav_sr /
sample_rate) * 2^cv``; the read is nearest-neighbour, truncating the f32
position; when the position runs past the end, playback stops and the
position resets.  The waveform is a param ``samples`` padded to the static
``max_len`` (statics ``("sample", max_len)``), with its ``length`` and
``wav_sr`` beside it.

* ``_step``, the scan engine's per-sample form: one gather of each voice's
  row at ``clip(trunc(pos), 0, max_len - 1)``.
* ``_block``, the block engine's whole-block form over ``[V, n]`` rows.  On
  CUDA tensors it launches kernel K7 (``ops/sample_kernel.py``) for the
  whole pipeline; on CPU tensors it runs :func:`play_unfused`, K7's plain
  version.

The type has no device function (``cuda_fn``), as the JAX package keeps it
out of its register-safe set: a Sample in the block engine's serial stage
leaves the patch to the scan engine.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import AudioConfig
from ..ops.basic import (block_lane, block_transitions, cummax_plain,
                         cumsum_plain, fast_cummax, fast_cumsum, t_index,
                         table_lookup, table_lookup_rows,
                         table_lookup_rows_plain, transition,
                         transition_init)
from .base import CV_DTYPE, ModuleDef, const_ports, in_or


def _make(cfg: AudioConfig, samples=None, wav_sample_rate=None,
          max_len: int | None = None):
    if samples is None:
        data = np.zeros((0,), dtype=np.float32)
    else:
        data = np.asarray(samples, dtype=np.float32).reshape(-1)
    n = int(data.shape[0])
    if max_len is None:
        max_len = max(n, 1)
    if n > max_len:
        raise ValueError(f"sample of {n} frames exceeds max_len={max_len}")
    padded = np.zeros((max_len,), dtype=np.float32)
    padded[:n] = data
    params = {
        "samples": torch.from_numpy(padded),
        "length": torch.tensor(n, dtype=torch.int32),
        "wav_sr": torch.tensor(
            float(wav_sample_rate) if wav_sample_rate else 0.0,
            dtype=CV_DTYPE),
    }
    return ("sample", int(max_len)), params


def _init_state(cfg: AudioConfig, statics, device=None):
    return {
        "pos": torch.zeros((), dtype=CV_DTYPE, device=device),
        "playing": torch.zeros((), dtype=torch.bool, device=device),
        "gate_last": transition_init(device),
    }


def base_rate(cfg: AudioConfig, wav_sr: torch.Tensor) -> torch.Tensor:
    """``wav_sr / sample_rate`` in f32, rounded once: the divisor is a
    tensor on ``wav_sr``'s device (on CUDA, a division by a Python scalar is
    a product with its reciprocal, which can round differently)."""
    return wav_sr / torch.full_like(wav_sr, float(cfg.sample_rate))


def _step(cfg: AudioConfig, statics, params, state, ins, x=None):
    (_, max_len) = statics
    gate = in_or(ins[0], 0.0, state["pos"])
    cv_in = in_or(ins[1], 0.0, state["pos"])
    gate_last, trigger = transition(state["gate_last"], gate)

    pos = torch.where(trigger, 0.0, state["pos"])
    playing = torch.logical_or(trigger, state["playing"])

    pos_i = pos.to(torch.int32)  # truncation; pos is non-negative
    wrapped = pos_i >= params["length"]
    pos = torch.where(wrapped, 0.0, pos)
    playing = torch.where(wrapped, False, playing)
    pos_i = torch.where(wrapped, 0, pos_i)

    # an index clipped into the table: the select tree's answer is the read
    read = table_lookup(params["samples"], torch.clamp(pos_i, 0, max_len - 1))
    out = torch.where(params["length"] > 0, read, 0.0).to(CV_DTYPE)

    rate = base_rate(cfg, params["wav_sr"]) * torch.exp2(cv_in)
    pos = torch.where(playing, pos + rate, pos)

    new_state = {"pos": pos.to(CV_DTYPE), "playing": playing,
                 "gate_last": gate_last}
    return new_state, (out,)


def play_unfused(gate, cv, table, base, pos0, playing0, gate_last0, length,
                 plain: bool = False):
    """The Sample player of :func:`_block` as separate passes over ``[R,
    n]`` rows (the JAX block form's unfused path), with K7's arguments.

    The position is a prefix sum of rates segmented by gate triggers,
    exclusive (the player reads before it advances); the last trigger's
    sum is a running max (the sums never decrease); crossing the length
    stops playback and reads ``samples[0]``.  The scans and the read go
    through the wrappers (K4 and K6 on CUDA tensors), or with ``plain``
    through the plain versions (log-doubling scans, one ``torch.gather``).
    On CPU tensors both are K7's plain version."""
    k = table.shape[-1]
    n = gate.shape[-1]
    cumsum = cumsum_plain if plain else fast_cumsum
    cummax = cummax_plain if plain else fast_cummax
    gate_last, trig = block_transitions(gate_last0, gate)
    base_c = base.unsqueeze(-1)
    if cv is None:
        rate_last = base
        cum_excl = base_c * t_index(n, gate.device).to(CV_DTYPE)
    else:
        rate = base_c * torch.exp2(cv)
        rate_last = rate[:, -1]
        cum_excl = cumsum(rate) - rate

    # the last trigger's sum: running max of the sums at triggers
    filled = cummax(torch.where(trig, cum_excl, -1.0))
    has_trig = filled >= 0
    pos_c = pos0.unsqueeze(-1)
    carry_pos = torch.where(playing0.unsqueeze(-1), cum_excl + pos_c, pos_c)
    s = torch.where(has_trig, cum_excl - filled, carry_pos)
    crossed = s >= length.to(CV_DTYPE).unsqueeze(-1)

    idx = torch.clamp(s, 0, k - 1).to(torch.int32)
    read = (table_lookup_rows_plain(table, idx) if plain
            else table_lookup_rows(table, idx, long=True))
    out = torch.where((length > 0).unsqueeze(-1),
                      torch.where(crossed, table[:, :1], read), 0.0)

    active_last = torch.logical_or(has_trig[:, -1], playing0)
    playing_end = torch.logical_and(active_last,
                                    torch.logical_not(crossed[:, -1]))
    pos_end = torch.where(playing_end, s[:, -1] + rate_last,
                          torch.where(crossed[:, -1], 0.0, pos0))
    return out.to(CV_DTYPE), pos_end.to(CV_DTYPE), playing_end, gate_last


def _block(cfg: AudioConfig, statics, params, state, ins, x, n):
    """Whole-block playback over ``[V, n]`` rows: kernel K7 on CUDA
    tensors, :func:`play_unfused` on CPU tensors."""
    pos0 = state["pos"]
    v, device = pos0.shape[0], pos0.device
    gate = block_lane(ins[0], v, n, device=device)
    # an unconnected CV input: a constant rate per voice, no prefix sum
    cv = None if ins[1] is None else block_lane(ins[1], v, n, device=device)
    args = (gate, cv, params["samples"], base_rate(cfg, params["wav_sr"]),
            pos0, state["playing"], state["gate_last"], params["length"])
    if device.type == "cuda":
        from ..ops.sample_kernel import SAMPLE_PLAY
        out, pos, playing, gate_last = SAMPLE_PLAY.run(*args)
    else:
        out, pos, playing, gate_last = play_unfused(*args)
    return ({"pos": pos, "playing": playing, "gate_last": gate_last},
            (out,))


_nin, _inlabels = const_ports(2, ("Gate", "CV"))
_nout, _outlabels = const_ports(1, (None,))

SAMPLE = ModuleDef(
    type_name="Sample",
    make=_make,
    num_inputs=_nin,
    num_outputs=_nout,
    input_labels=_inlabels,
    output_labels=_outlabels,
    init_state=_init_state,
    step=_step,
    block=_block,
)
