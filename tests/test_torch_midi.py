"""The port's MIDI import and ``midi`` command (the twin of
``tests/test_midi.py``): fixture bytes assembled by hand from the SMF
spec; the port's ``read_midi`` returns the JAX package's events, and the
CLI renders them with ``--device cpu``."""

import struct

import numpy as np
import torch

from srack_tpu.io.midi import read_midi as jax_read_midi

import srack_tpu_torch as stt
from srack_tpu_torch.__main__ import main
from srack_tpu_torch.io.midi import read_midi
from srack_tpu_torch.io.wav import read_wav
from srack_tpu_torch.utils.notes import note_track


def _varlen(v):
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


def _track(events):
    """events: (delta_ticks, raw bytes)."""
    body = b"".join(_varlen(d) + raw for d, raw in events)
    body += _varlen(0) + b"\xff\x2f\x00"  # end of track
    return b"MTrk" + struct.pack(">I", len(body)) + body


def _smf(tracks, fmt=1, ppqn=480):
    return (b"MThd" + struct.pack(">IHHH", 6, fmt, len(tracks), ppqn)
            + b"".join(tracks))


def make_fixture():
    # conductor: 120 bpm at t=0, 60 bpm at tick 960; A4 for 480 ticks, C5
    # from tick 960 for 480 ticks (1 s after the tempo change); running
    # status, and a note-on of velocity 0 as the off
    conductor = _track([
        (0, b"\xff\x51\x03" + (500000).to_bytes(3, "big")),
        (960, b"\xff\x51\x03" + (1000000).to_bytes(3, "big")),
    ])
    notes = _track([
        (0, b"\x90\x45\x64"),
        (480, b"\x80\x45\x40"),
        (480, b"\x90\x48\x50"),
        (480, b"\x48\x00"),
    ])
    return _smf([conductor, notes])


def test_read_midi_notes_and_tempo():
    events = read_midi(make_fixture())
    assert events == jax_read_midi(make_fixture())
    assert len(events) == 2
    (n1, s1, d1), (n2, s2, d2) = events
    assert (n1, n2) == (69, 72)
    assert abs(s1) < 1e-9 and abs(d1 - 0.5) < 1e-9
    assert abs(s2 - 1.0) < 1e-9 and abs(d2 - 1.0) < 1e-9


def test_missing_note_off_held_to_track_end():
    data = _smf([_track([(0, b"\x90\x45\x64"), (960, b"\x90\x48\x50"),
                         (240, b"\x80\x48\x40")])], fmt=0)
    events = read_midi(data)
    assert events == jax_read_midi(data)
    held = [e for e in events if e[0] == 69][0]
    assert abs(held[2] - (1200 * 500000 / (480 * 1e6))) < 1e-9


def test_same_note_retrigger_closes_previous():
    data = _smf([_track([(0, b"\x90\x3c\x64"), (480, b"\x90\x3c\x64"),
                         (480, b"\x80\x3c\x40"), (480, b"\x80\x3c\x40")])],
                fmt=0)
    events = read_midi(data)
    assert events == jax_read_midi(data)
    assert len(events) == 2
    (n1, s1, d1), (n2, s2, d2) = events
    assert n1 == n2 == 60
    assert abs(s1) < 1e-9 and abs(d1 - 0.5) < 1e-9
    assert abs(s2 - 0.5) < 1e-9 and abs(d2 - 0.5) < 1e-9


def test_retrigger_without_off_no_phantom_drone():
    data = _smf([_track([(0, b"\x90\x3c\x64"), (480, b"\x90\x3c\x64"),
                         (20, b"\x80\x3c\x40"), (1000, b"\xb0\x07\x64")])],
                fmt=0)
    events = read_midi(data)
    assert events == jax_read_midi(data)
    (n1, s1, d1), (n2, s2, d2) = sorted(events, key=lambda e: e[1])
    assert abs(d1 - 480 / 960) < 1e-9
    assert abs(d2 - 20 / 960) < 1e-9


def test_cli_midi_render(tmp_path, capsys):
    mid = tmp_path / "riff.mid"
    mid.write_bytes(make_fixture())
    out = tmp_path / "riff.wav"
    assert main(["midi", str(mid), "-o", str(out), "--sample-rate", "8000",
                 "--device", "cpu"]) == 0
    audio, sr = read_wav(str(out))
    assert sr == 8000
    assert audio.shape[-1] > 8000 * 2
    assert 0.05 < np.abs(audio).max() <= 1.0


def test_cli_midi_polyphonic_chord(tmp_path, capsys):
    """A held 3-note chord sounds all three notes at once (voice
    allocation over the batch's lanes)."""
    chord = _track([
        (0, b"\x90\x3c\x64"), (0, b"\x90\x40\x64"), (0, b"\x90\x43\x64"),
        (960, b"\x80\x3c\x40"), (0, b"\x80\x40\x40"), (0, b"\x80\x43\x40"),
    ])
    mid = tmp_path / "chord.mid"
    mid.write_bytes(_smf([chord], fmt=0))
    out = tmp_path / "chord.wav"
    assert main(["midi", str(mid), "-o", str(out), "--sample-rate", "8000",
                 "--voices", "4", "--device", "cpu"]) == 0
    audio, sr = read_wav(str(out))
    seg = audio[2000:8000].astype(np.float64)
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    freqs = np.fft.rfftfreq(len(seg), 1 / sr)
    for note in (60, 64, 67):
        f0 = 440.0 * 2 ** ((note - 69) / 12)
        band = spec[(freqs > f0 * 0.97) & (freqs < f0 * 1.03)].max()
        assert band > spec.mean() * 10, f"note {note} missing"


def test_midi_to_audio_end_to_end(tmp_path):
    path = tmp_path / "riff.mid"
    path.write_bytes(make_fixture())
    events = read_midi(str(path))
    cfg = stt.AudioConfig(sample_rate=8000, channels=1, precision="fast")
    n = 8000 * 2
    gate, cv = note_track(events, n, cfg.sample_rate)
    assert gate.max() == 1.0
    assert abs(cv[4000]) < 1e-6 and abs(cv[-1] - 0.25) < 1e-6
    p = stt.Patch(cfg)
    g_in, c_in = p.add("Input"), p.add("Input")
    osc = p.add("Oscillator")
    vca = p.add("VCA")
    p.connect(c_in, 0, osc, "CV")
    p.connect(osc, "Sine", vca, "Audio")
    p.connect(g_in, 0, vca, "CV")
    p.connect(vca, 0, p.output, 0)
    audio, _, _ = stt.render(p, n, drivers={g_in: torch.from_numpy(gate),
                                            c_in: torch.from_numpy(cv)},
                             device="cpu")
    a = audio[0].numpy()
    assert np.abs(a[:3900]).max() > 0.5
    assert np.abs(a[4100:7900]).max() == 0.0
    assert np.abs(a[8100:]).max() > 0.5
