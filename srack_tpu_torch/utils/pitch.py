"""Pitch helpers for the 1.0/octave CV convention, 0.0 -> 440 Hz
(counterpart: ``srack_tpu/utils/pitch.py``)."""

from __future__ import annotations

import math
import re

_NOTE_OFFSETS = {"C": -9, "D": -7, "E": -5, "F": -4, "G": -2, "A": 0, "B": 2}
_NOTE_RE = re.compile(r"^([A-Ga-g])([#b]?)(-?\d+)$")


def hz_to_cv(freq_hz: float) -> float:
    return math.log2(freq_hz / 440.0)


def cv_to_hz(cv: float) -> float:
    return 440.0 * (2.0 ** cv)


def midi_to_cv(midi_note: float) -> float:
    """MIDI note number -> CV (A4 = 69 -> 0.0)."""
    return (midi_note - 69.0) / 12.0


def note_to_cv(name: str) -> float:
    """Note name ('A4', 'C#3', 'Eb5') -> CV."""
    m = _NOTE_RE.match(name.strip())
    if not m:
        raise ValueError(f"bad note name {name!r}")
    letter, accidental, octave = m.groups()
    semis = _NOTE_OFFSETS[letter.upper()]
    semis += 1 if accidental == "#" else (-1 if accidental == "b" else 0)
    return (int(octave) - 4) + semis / 12.0
