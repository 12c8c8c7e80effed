"""``.srk`` patch-file interop (counterpart: ``srack_tpu/io/srk.py``).

The reference persists patches as MessagePack of ``FileFormat { modules,
connections, positions }`` (src/ui.rs:578-586) via ``rmp_serde`` 1.x with
the default (compact) serializer (ui.rs:112,125).  That representation:

* struct -> positional array of fields in declaration order, with
  ``#[serde(skip)]`` fields omitted;
* externally-tagged enum: newtype variant -> single-entry map
  ``{"VariantName": payload}``, unit variant -> the variant-name string;
* ``Option`` -> nil or the value; ``AudioBuffer`` (a serde newtype over
  ``Option<Arc<RwLock<Box<[f32]>>>>``, synth.rs:28) -> nil or an array of
  f32 (the whole block buffer -- runtime state the reference happily
  persists, SURVEY.md §5 checkpoint note).

This module reads those files into :class:`srack_tpu_torch.Patch` objects
(parameters and meaningful runtime state; buffer contents are discarded,
they are transient per-tick data) and writes patches back out in the same
layout so the reference app can open them.  Field tables below cite the
struct declarations they mirror.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:
    import msgpack
except ImportError:  # pragma: no cover
    msgpack = None

from ..config import AudioConfig
from ..patch import Patch

_ADSR_MODES = ["Attack", "Decay", "Sustain", "Release", "None"]
_ADSR_MODE_TO_INT = {"None": 0, "Attack": 1, "Decay": 2, "Sustain": 3,
                     "Release": 4}


class SrkError(ValueError):
    """Malformed / unsupported ``.srk`` input.

    Every reader failure funnels here so callers can catch ONE exception
    type; truncated bytes, wrong field counts, bogus types and unknown
    variants must never surface as raw IndexError/KeyError/TypeError
    (round-2 verdict item 9: the reader parses externally-produced bytes
    it cannot trust)."""


def _require_msgpack():
    if msgpack is None:  # pragma: no cover
        raise RuntimeError("msgpack is not available in this environment")


def _buf(block_size: int):
    """A serialized AudioBuffer: the reference saves the raw block contents;
    zeros are equivalent on load (buffers are recomputed every tick)."""
    return [0.0] * block_size


def _detector(last=True):
    return [bool(last)]  # TransitionDetector { last } (synth.rs:277-279)


def read_srk(data, config: Optional[AudioConfig] = None) -> Patch:
    """Parse a ``.srk`` byte string into a Patch.

    Positions (UI layout) are attached as ``patch.positions`` for
    round-tripping; unknown module variants raise.
    """
    _require_msgpack()
    if not isinstance(data, (bytes, bytearray)):
        with open(data, "rb") as f:
            data = f.read()
    try:
        root = msgpack.unpackb(data, raw=False, strict_map_key=False)
    except Exception as e:
        raise SrkError(f"not valid MessagePack: {e}") from e
    if not isinstance(root, (list, tuple)) or len(root) != 3:
        raise SrkError(
            "root must be the 3-field FileFormat array "
            "[modules, connections, positions] (ui.rs:578-586), got "
            f"{type(root).__name__}"
            + (f" of length {len(root)}"
               if isinstance(root, (list, tuple)) else ""))
    modules_raw, connections, positions = root
    if not isinstance(modules_raw, (list, tuple)):
        raise SrkError("modules field is not an array")

    cfg = config or AudioConfig()
    patch = Patch(cfg, auto_output=False)
    id_map = {}  # srk uuid -> our module id

    for entry in modules_raw:
        if not isinstance(entry, dict) or len(entry) != 1:
            raise SrkError(
                "module entry is not a single-variant enum map "
                f"(externally-tagged rmp-serde), got {entry!r:.80}")
        (variant, fields), = entry.items()
        try:
            handle, srk_id = _unpack_module(patch, cfg, str(variant), fields)
        except SrkError:
            raise
        except Exception as e:
            raise SrkError(
                f"malformed {variant} module entry: "
                f"{type(e).__name__}: {e}") from e
        id_map[srk_id] = handle

    if patch.output is None:
        patch.output = patch.add("Output")

    if not isinstance(connections, (list, tuple)):
        raise SrkError("connections field is not an array")
    for quad in connections:
        try:
            src_id, src_port, sink_id, sink_port = quad
            if src_id in id_map and sink_id in id_map:
                patch.connect(id_map[src_id], int(src_port),
                              id_map[sink_id], int(sink_port))
        except SrkError:
            raise
        except Exception as e:
            raise SrkError(f"malformed connection quad {quad!r:.80}: "
                           f"{type(e).__name__}: {e}") from e

    try:
        patch.positions = {
            id_map[mid].id: tuple(pos) for mid, pos in positions
            if mid in id_map}
    except Exception as e:
        raise SrkError(f"malformed positions field: {e}") from e
    patch.srk_ids = {h.id: srk for srk, h in id_map.items()}
    return patch


def _unpack_module(patch: Patch, cfg: AudioConfig, variant: str, f: list):
    """Create a module from one serialized enum entry.  Field orders follow
    the Rust struct declarations with skipped fields omitted."""
    if variant == "OutputModuleV0":
        # output.rs:7-12: id, bufs
        h = patch.add("Output")
        return h, f[0]
    if variant == "OscillatorModuleV0":
        # oscillator.rs:10-24: id, val, sample_rate, sine, square, saw,
        # pos, antialiasing, sync_detector
        h = patch.add("Oscillator", val=float(f[1]), antialiasing=bool(f[7]))
        return h, f[0]
    if variant == "NoiseModuleV0":
        # oscillator.rs:309-312: id, out
        h = patch.add("Noise")
        return h, f[0]
    if variant in ("GridSequencerModuleV0", "GridSequencerModuleV1"):
        # sequencer.rs:13-30 (V1) / 628-645 (V0): id, cv_out, gate_out,
        # sync_out, sequence, octaves, steps_per_octave, current_step,
        # transition_detector, sync_transition_detector, last, ui_dirty
        seq_raw = f[4]
        if variant == "GridSequencerModuleV0":
            # V0 cells Option<u16> migrate to (note, hold=False)
            # (sequencer.rs:647-670)
            seq = [None if c is None else (int(c), False) for c in seq_raw]
        else:
            seq = [None if c is None else (int(c[0]), bool(c[1]))
                   for c in seq_raw]
        h = patch.add("Grid Sequencer", sequence=seq, n_steps=len(seq),
                      octaves=int(f[5]), steps_per_octave=int(f[6]))
        return h, f[0]
    if variant == "PatternSequencerModuleV0":
        # sequencer.rs:337-350: id, gate_outs, sync_out, sequence,
        # current_step, td, std, ui_dirty
        seq = [[None if c is None else bool(c) for c in row] for row in f[3]]
        h = patch.add("Pattern Sequencer", pattern=seq,
                      n_steps=len(seq[0]) if seq else 64)
        return h, f[0]
    if variant == "ADSRModuleV0":
        # adsr.rs:8-24: id, a_sec, d_sec, s_val, r_sec, phase, mode,
        # r_val, from_a_val, sample_rate, transition_detector,
        # output_buffer, ui_dirty
        h = patch.add("ADSR", a_sec=float(f[1]), d_sec=float(f[2]),
                      s_val=float(f[3]), r_sec=float(f[4]))
        return h, f[0]
    if variant == "VCAModuleV0":
        # vca.rs:7-15: id, buf, negative
        h = patch.add("VCA", negative=bool(f[2]))
        return h, f[0]
    if variant in ("MoogFilterModuleV0", "MoogFilterModuleV1"):
        # filter.rs:12-25 (V1): id, lowpass, bandpass, highpass, freq, res,
        # exp_amt, state; V0 (filter.rs:252-263): id, buf, freq, res,
        # exp_amt, state
        if variant == "MoogFilterModuleV0":
            freq, res, exp_amt = f[2], f[3], f[4]
        else:
            freq, res, exp_amt = f[4], f[5], f[6]
        h = patch.add("Moog Filter", freq=float(freq), res=float(res),
                      exp_amt=float(exp_amt))
        return h, f[0]
    if variant == "MonoMixerModuleV0":
        # mixer.rs:7-13: id, gain, buf
        h = patch.add("Mono Mixer", gains=tuple(float(g) for g in f[1]))
        return h, f[0]
    if variant == "SampleModuleV0":
        # sample.rs:72-85: id, transition_detector, pos, buf, wavebox
        # (samples, sample_rate, new), playing, sample_rate
        wave = f[4]
        samples = np.asarray(wave[0], dtype=np.float32)
        h = patch.add("Sample", samples=samples,
                      wav_sample_rate=float(wave[1]) or None)
        return h, f[0]
    if variant == "MathModuleV0":
        # math.rs:14-23: id, buf, constant, operation
        h = patch.add(str(f[3]), constant=float(f[2]))
        return h, f[0]
    if variant == "NonLinearModuleV0":
        # math.rs:177-185: id, buf, constant
        h = patch.add("Non-Linear", constant=float(f[2]))
        return h, f[0]
    if variant == "FreeverbModuleV0":
        # freeverb.rs:7-31: id, left_out, right_out, sample_rate,
        # dampening, dampening_ctl, freeze, freeze_ctl, wet, wet_ctl,
        # width, width_ctl, room_size, room_size_ctl, dry, dry_ctl
        h = patch.add("Freeverb", dampening=float(f[5]), freeze=bool(f[7]),
                      wet=float(f[9]), width=float(f[11]),
                      room_size=float(f[13]), dry=float(f[15]))
        return h, f[0]
    raise SrkError(f"unknown .srk module variant {variant!r}")


def write_srk(patch: Patch, path=None) -> bytes:
    """Serialize a Patch in the reference's FileFormat layout."""
    _require_msgpack()
    cfg = patch.config
    bs = cfg.block_size
    srk_ids = getattr(patch, "srk_ids", {})
    positions = getattr(patch, "positions", {})

    modules = []
    conns = []
    pos_list = []
    ids = {}
    for inst in patch:
        sid = srk_ids.get(inst.id, inst.id)
        ids[inst.id] = sid
        modules.append(_pack_module(inst, sid, cfg))
        if inst.id in positions:
            pos_list.append([sid, list(positions[inst.id])])
    for (src, sport, sink, sport2) in patch.connections():
        conns.append([ids[src], sport, ids[sink], sport2])

    data = msgpack.packb([modules, conns, pos_list], use_single_float=True)
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(data)
    return data


def _pack_module(inst, sid: str, cfg: AudioConfig):
    bs = cfg.block_size
    t = inst.mdef.type_name
    p = {k: v.detach().cpu().numpy() for k, v in inst.params.items()}

    def entry(variant, fields):
        return {variant: fields}

    if t == "Output":
        return entry("OutputModuleV0", [sid, [_buf(bs)] * cfg.channels])
    if t == "Oscillator":
        return entry("OscillatorModuleV0", [
            sid, float(p["val"]), cfg.sample_rate, _buf(bs), _buf(bs),
            _buf(bs), 0.0, bool(inst.statics[1]), _detector()])
    if t == "Noise":
        return entry("NoiseModuleV0", [sid, _buf(bs)])
    if t == "Grid Sequencer":
        n = int(p["n_steps"])
        cells = p["cells"]
        notes = p["notes"]
        seq = [None if cells[i] == 0 else [int(notes[i]), bool(cells[i] == 2)]
               for i in range(n)]
        return entry("GridSequencerModuleV1", [
            sid, _buf(bs), _buf(bs), _buf(bs), seq, inst.statics[1],
            int(p["steps_per_octave"]), 0, _detector(), _detector(),
            0.0, False])
    if t == "Pattern Sequencer":
        n = int(p["n_steps"])
        cells = p["cells"]
        seq = [[None if cells[r, i] == 0 else bool(cells[r, i] == 2)
                for i in range(n)] for r in range(cells.shape[0])]
        return entry("PatternSequencerModuleV0", [
            sid, [_buf(bs)] * cells.shape[0], _buf(bs), seq, 0,
            _detector(), _detector(), False])
    if t == "ADSR":
        return entry("ADSRModuleV0", [
            sid, float(p["a_sec"]), float(p["d_sec"]), float(p["s_val"]),
            float(p["r_sec"]), 0.0, "None", 0.0, 0.0,
            float(cfg.sample_rate), _detector(), _buf(bs), False])
    if t == "VCA":
        return entry("VCAModuleV0", [sid, _buf(bs), bool(inst.statics[1])])
    if t == "Moog Filter":
        state = [0.0, 0.0, 0.0, [0.0] * 5, 0.0, 0.0]
        return entry("MoogFilterModuleV1", [
            sid, _buf(bs), _buf(bs), _buf(bs), float(p["freq"]),
            float(p["res"]), float(p["exp_amt"]), state])
    if t == "Mono Mixer":
        return entry("MonoMixerModuleV0",
                     [sid, [float(g) for g in p["gain"]], _buf(bs)])
    if t == "Sample":
        n = int(p["length"])
        wave = [[float(x) for x in p["samples"][:n]], float(p["wav_sr"]),
                False]
        return entry("SampleModuleV0", [
            sid, _detector(), 0.0, _buf(bs), wave, False,
            float(cfg.sample_rate)])
    if t in ("Add", "Subtract", "Multiply"):
        return entry("MathModuleV0", [sid, _buf(bs), float(p["constant"]), t])
    if t == "Non-Linear":
        return entry("NonLinearModuleV0", [sid, _buf(bs),
                                           float(p["constant"])])
    if t == "Freeverb":
        d, fz, w = (float(p["dampening"]), bool(p["freeze"]),
                    float(p["wet"]))
        wd, rs, dr = (float(p["width"]), float(p["room_size"]),
                      float(p["dry"]))
        return entry("FreeverbModuleV0", [
            sid, _buf(bs), _buf(bs), cfg.sample_rate,
            d, d, fz, fz, w, w, wd, wd, rs, rs, dr, dr])
    raise ValueError(f"cannot serialize module type {t!r} to .srk "
                     "(no reference equivalent)")
