"""Freeverb stereo reverb (counterpart: ``srack_tpu/modules/freeverb.py``).

The Schroeder/Jezar "Freeverb" topology: per channel 8 parallel
lowpass-feedback combs summed, then 4 series allpasses, the right channel's
lines 23 samples longer.  Jezar's tunings at 44.1 kHz, scaled by
``len * sr // 44100``; fixed input gain 0.015, wet scale 3.0, dampening
scale 0.4, room scale 0.28 + offset 0.7, allpass feedback 0.5.  Freeze
forces feedback 1, dampening 0 and input gain 0; wet1/wet2 encode the
stereo width.

State: 24 ring buffers with one write index each (``cl0..7``, ``cr0..7``,
``al0..3``, ``ar0..3`` and ``<line>_idx``) and the 16 comb filter states
(``c{l,r}{0..7}_fs``), in the core dtype (:func:`_core_dtype`: f32, and
in exact precision f64, as the crate computes; the inputs and outputs stay
f32) but the int32 indices.

* ``_step``: one sample, for the scan engine and the serial stage.  It
  writes the rings in place (``ModuleDef.step_in_place``): the engines
  clone the state once per render, not the lines every sample.
* ``_block``: the whole render, for the block engine.  On CUDA tensors it
  runs kernel K8 (``ops/freeverb_kernel.py``); on CPU tensors its plain
  version :func:`block_plain`, the chunk-parallel form: chunks no longer
  than the shortest comb (every comb read within a chunk predates it), the
  damping one-pole as a linear recurrence, the allpasses in sub-pieces no
  longer than the shortest allpass, the rings brought into time order on
  entry and returned in time order with write index 0.
"""

from __future__ import annotations

import torch

from ..config import AudioConfig
from ..ops.basic import block_lane, linear_recurrence_plain
from ..ops.ring_roll import ring_align_plain
from .base import CV_DTYPE, ModuleDef, const_ports, cv, in_or

COMB_TUNINGS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
ALLPASS_TUNINGS = (556, 441, 341, 225)
STEREO_SPREAD = 23
FIXED_GAIN = 0.015
SCALE_WET = 3.0
SCALE_DAMPENING = 0.4
SCALE_ROOM = 0.28
OFFSET_ROOM = 0.7
ALLPASS_FEEDBACK = 0.5

# the 24 lines in the kernel's order: combs left, right; allpasses left, right
LINE_KEYS = (tuple(f"cl{i}" for i in range(8))
             + tuple(f"cr{i}" for i in range(8))
             + tuple(f"al{i}" for i in range(4))
             + tuple(f"ar{i}" for i in range(4)))
FS_KEYS = tuple(f"c{ch}{i}_fs" for ch in "lr" for i in range(8))


def adjust_length(length: int, sample_rate: int) -> int:
    return max(1, (length * sample_rate) // 44100)


def line_lengths(sample_rate: int):
    """(comb_l[8], comb_r[8], ap_l[4], ap_r[4]) adjusted for sample rate."""
    cl = tuple(adjust_length(t, sample_rate) for t in COMB_TUNINGS)
    cr = tuple(adjust_length(t + STEREO_SPREAD, sample_rate)
               for t in COMB_TUNINGS)
    al = tuple(adjust_length(t, sample_rate) for t in ALLPASS_TUNINGS)
    ar = tuple(adjust_length(t + STEREO_SPREAD, sample_rate)
               for t in ALLPASS_TUNINGS)
    return cl, cr, al, ar


def _core_dtype(cfg: AudioConfig) -> torch.dtype:
    """The dtype of the lines, filter states and gains: f64 in exact
    precision (the crate's; the module casts f32 in and out), else f32."""
    return torch.float64 if cfg.exact else CV_DTYPE


def _make(cfg: AudioConfig, dampening: float = 0.5, freeze: bool = False,
          wet: float = 1.0, width: float = 0.5, room_size: float = 0.5,
          dry: float = 0.0):
    params = {
        "dampening": cv(dampening),
        "freeze": torch.tensor(bool(freeze)),
        "wet": cv(wet),
        "width": cv(width),
        "room_size": cv(room_size),
        "dry": cv(dry),
    }
    return ("freeverb",), params


def _init_state(cfg: AudioConfig, statics, device=None):
    dt = _core_dtype(cfg)
    cl, cr, al, ar = line_lengths(cfg.sample_rate)
    state = {}
    for name, lens in (("cl", cl), ("cr", cr), ("al", al), ("ar", ar)):
        for i, n in enumerate(lens):
            state[f"{name}{i}"] = torch.zeros((n,), dtype=dt, device=device)
            state[f"{name}{i}_idx"] = torch.zeros((), dtype=torch.int32,
                                                  device=device)
    for key in FS_KEYS:
        state[key] = torch.zeros((), dtype=dt, device=device)
    return state


def freeverb_gains(params, dtype=CV_DTYPE):
    """Derived gains (the crate's setter math): ``(damp, feed, in_gain,
    wet1, wet2, dry)`` in ``dtype``, elementwise over whatever shape the
    params have.  The params are taken to ``dtype`` first and the
    constants stay Python floats, so in f64 nothing is rounded to f32."""
    def f(v):
        return v.to(dtype)
    frozen = params["freeze"]
    damp = torch.where(frozen, 0.0, f(params["dampening"]) * SCALE_DAMPENING)
    feed = torch.where(frozen, 1.0,
                       f(params["room_size"]) * SCALE_ROOM + OFFSET_ROOM)
    in_gain = torch.where(frozen, 0.0,
                          torch.full_like(frozen, FIXED_GAIN, dtype=dtype))
    wet = f(params["wet"]) * SCALE_WET
    width = f(params["width"])
    wet1 = wet * (width / 2.0 + 0.5)
    wet2 = wet * ((1.0 - width) / 2.0)
    return damp, feed, in_gain, wet1, wet2, f(params["dry"])


def _comb_tick(state, key, x, damp, feed):
    buf, idx = state[key], state[f"{key}_idx"]
    pos = idx.to(torch.int64).unsqueeze(-1)
    out = buf.gather(-1, pos).squeeze(-1)
    fs = out * (1.0 - damp) + state[f"{key}_fs"] * damp
    buf.scatter_(-1, pos, torch.broadcast_to(x + fs * feed,
                                             idx.shape).unsqueeze(-1))
    state[f"{key}_idx"] = torch.where(idx + 1 >= buf.shape[-1], 0, idx + 1)
    state[f"{key}_fs"] = fs
    return out


def _allpass_tick(state, key, x):
    buf, idx = state[key], state[f"{key}_idx"]
    pos = idx.to(torch.int64).unsqueeze(-1)
    delayed = buf.gather(-1, pos).squeeze(-1)
    out = delayed - x
    buf.scatter_(-1, pos, torch.broadcast_to(x + delayed * ALLPASS_FEEDBACK,
                                             idx.shape).unsqueeze(-1))
    state[f"{key}_idx"] = torch.where(idx + 1 >= buf.shape[-1], 0, idx + 1)
    return out


def _step(cfg: AudioConfig, statics, params, state, ins, x=None):
    """One sample.  The rings are written in place; the returned state
    holds the same ring tensors with the new indices and filter states.
    The core runs in :func:`_core_dtype`, the outputs are f32."""
    dt = _core_dtype(cfg)
    like = state["cl0_fs"]
    l_in = in_or(ins[0], 0.0, like).to(dt)
    r_in = in_or(ins[1], 0.0, like).to(dt)
    damp, feed, in_gain, wet1, wet2, dry = freeverb_gains(params, dt)
    state = dict(state)
    mixed = (l_in + r_in) * in_gain
    out_l = out_r = torch.zeros((), dtype=dt, device=like.device)
    for i in range(len(COMB_TUNINGS)):
        out_l = out_l + _comb_tick(state, f"cl{i}", mixed, damp, feed)
        out_r = out_r + _comb_tick(state, f"cr{i}", mixed, damp, feed)
    for i in range(len(ALLPASS_TUNINGS)):
        out_l = _allpass_tick(state, f"al{i}", out_l)
        out_r = _allpass_tick(state, f"ar{i}", out_r)
    final_l = out_l * wet1 + out_r * wet2 + l_in * dry
    final_r = out_r * wet1 + out_l * wet2 + r_in * dry
    return state, (final_l.to(CV_DTYPE), final_r.to(CV_DTYPE))


def block_gains(params, v: int, dtype=CV_DTYPE):
    """:func:`freeverb_gains` for ``[V, n]`` rows: per-voice params as
    ``[V, 1]`` columns, automation lanes as ``[V, n]``."""
    cols = {k: (p if p.dim() == 2 else p.reshape(v, 1))
            for k, p in params.items()}
    return freeverb_gains(cols, dtype)


def _block(cfg: AudioConfig, statics, params, state, ins, xs, n,
           outs_used=(True, True)):
    """The whole render on ``[V, n]`` rows (``ins``: ``[V, n]`` or None;
    ``params``: ``[V]`` or, automated, ``[V, n]``).  Kernel K8 for CUDA
    tensors, :func:`block_plain` for CPU tensors."""
    v = state["cl0"].shape[0]
    device = state["cl0"].device
    mono = ins[0] is ins[1]
    gains = block_gains(params, v, _core_dtype(cfg))
    if device.type == "cuda":
        from ..ops import freeverb_kernel
        return freeverb_kernel.render(cfg, ins[0], ins[1], mono, gains,
                                      state, n, skip_r=not outs_used[1])
    l_in = block_lane(ins[0], v, n, device=device)
    r_in = l_in if mono else block_lane(ins[1], v, n, device=device)
    return block_plain(l_in, r_in, gains, state, n)


def block_plain(l_in, r_in, gains, state, n: int):
    """K8's plain version: the chunk-parallel Freeverb over ``[V, n]``
    input lanes with :func:`block_gains`' gains, on the lines ``state``
    holds (the rings give the lengths).  Returns ``(new_state, (out_l,
    out_r))`` with the rings in time order, write index 0."""
    lens = [state[k].shape[-1] for k in LINE_KEYS]
    chunk = max(min(min(lens[:16]), n), 1)
    ap_sub = min(lens[16:])
    damp, feed, in_gain, wet1, wet2, dry = gains
    fb_varies = damp.shape[-1] > 1 or feed.shape[-1] > 1
    hist = {k: ring_align_plain(state[k], state[f"{k}_idx"])
            for k in LINE_KEYS}
    fs = {k[:-3]: state[k] for k in FS_KEYS}

    def comb_chunk(h, fs0, mixed, dmp, fd, csize):
        y = h[:, :csize]
        A, Y = linear_recurrence_plain(dmp, y * (1.0 - dmp))
        fs_t = A * fs0.unsqueeze(-1) + Y
        w = mixed + fs_t * fd
        return torch.cat([h[:, csize:], w], dim=1), fs_t[:, -1], y

    def allpass_piece(h, x, m):
        delayed = h[:, :m]
        out = delayed - x
        w = x + delayed * ALLPASS_FEEDBACK
        return torch.cat([h[:, m:], w], dim=1), out

    raw = {"l": [l_in[:, :0]], "r": [l_in[:, :0]]}  # n may be 0
    for s0 in range(0, n, chunk):
        csize = min(chunk, n - s0)
        lc, rc = l_in[:, s0:s0 + csize], r_in[:, s0:s0 + csize]
        if fb_varies:  # damp/feed held at the chunk's start
            dmp = damp.expand(-1, n)[:, s0:s0 + 1]
            fd = feed.expand(-1, n)[:, s0:s0 + 1]
        else:
            dmp, fd = damp, feed
        mixed = (lc + rc) * in_gain
        for ch in "lr":
            out = torch.zeros_like(lc)
            for i in range(len(COMB_TUNINGS)):
                k = f"c{ch}{i}"
                hist[k], fs[k], y = comb_chunk(hist[k], fs[k], mixed, dmp,
                                               fd, csize)
                out = out + y
            pieces = []
            for p0 in range(0, csize, ap_sub):
                m = min(ap_sub, csize - p0)
                x_piece = out[:, p0:p0 + m]
                for i in range(len(ALLPASS_TUNINGS)):
                    k = f"a{ch}{i}"
                    hist[k], x_piece = allpass_piece(hist[k], x_piece, m)
                pieces.append(x_piece)
            raw[ch].append(torch.cat(pieces, dim=1))
    raw_l, raw_r = torch.cat(raw["l"], dim=1), torch.cat(raw["r"], dim=1)
    new_state = dict(state)
    for k in LINE_KEYS:
        new_state[k] = hist[k]
        new_state[f"{k}_idx"] = torch.zeros_like(state[f"{k}_idx"])
    for k in FS_KEYS:
        new_state[k] = fs[k[:-3]]
    out_l = raw_l * wet1 + raw_r * wet2 + l_in * dry
    out_r = raw_r * wet1 + raw_l * wet2 + r_in * dry
    return new_state, (out_l.to(CV_DTYPE), out_r.to(CV_DTYPE))


_nin, _inlabels = const_ports(2, ("Left", "Right"))
_nout, _outlabels = const_ports(2, ("Left", "Right"))

FREEVERB = ModuleDef(
    type_name="Freeverb",
    make=_make,
    num_inputs=_nin,
    num_outputs=_nout,
    input_labels=_inlabels,
    output_labels=_outlabels,
    init_state=_init_state,
    step=_step,
    step_in_place=True,
    block=_block,
    # wet/width/dry automate exactly (output-mix lanes); dampening and
    # room_size piecewise-constant per chunk (held at each chunk's start)
    auto_block_params=frozenset(
        {"dampening", "wet", "width", "room_size", "dry"}),
    # a dead Right output skips the kernel's [V, n] store
    block_outs_hint=True,
)
