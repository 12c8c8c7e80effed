"""Note events -> the gate and pitch-CV driver lanes of a patch's Input
modules (counterpart: ``srack_tpu/utils/notes.py``; numpy only).

A monophonic event list becomes sample-exact gate and CV arrays in the
engine's conventions: gate > 0 with rising-edge retrigger, 1.0/octave CV
with 0.0 -> 440 Hz.  Hand them to ``render(..., drivers={inp: arr})`` or
through :func:`srack_tpu_torch.interop.drivers_from_numpy`.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Union

import numpy as np

from .pitch import midi_to_cv, note_to_cv

Pitch = Union[str, float, int]


def _pitch_cv(p: Pitch) -> float:
    """Note name ('C#3'), MIDI number (int), or raw CV (float)."""
    if isinstance(p, str):
        return note_to_cv(p)
    if isinstance(p, (int, np.integer)):
        return midi_to_cv(float(p))
    return float(p)


def note_track(events: Iterable[tuple], n_samples: int, sample_rate: int,
               *, gap_samples: int = 1):
    """Monophonic event list -> ``(gate[n], cv[n])`` float32 arrays.

    ``events``: ``(pitch, start_sec, dur_sec)`` tuples; pitch is a note
    name, a MIDI note number (int) or a raw CV float.  Later events
    override earlier ones where they overlap.  ``gap_samples``: the gate
    drops for this many samples before a note that starts while the gate is
    high, so rising-edge detectors fire per note (0: legato).  CV holds its
    last value between notes; samples before the first note are 0.0.
    """
    gate = np.zeros(n_samples, dtype=np.float32)
    cv = np.zeros(n_samples, dtype=np.float32)
    written = np.zeros(n_samples, dtype=bool)
    for pitch, start, dur in sorted(events, key=lambda e: e[1]):
        a = int(round(start * sample_rate))
        b = int(round((start + dur) * sample_rate))
        a, b = max(a, 0), min(b, n_samples)
        if a >= n_samples or b <= a:
            continue
        if gap_samples and a > 0 and gate[a - 1] > 0.0:
            gate[max(0, a - gap_samples):a] = 0.0
        gate[a:b] = 1.0
        cv[a:b] = _pitch_cv(pitch)
        written[a:b] = True
    # hold CV between notes: forward-fill each unwritten sample from the
    # nearest written sample before it
    idx = np.where(written, np.arange(n_samples), 0)
    np.maximum.accumulate(idx, out=idx)
    return gate, cv[idx]


def allocate_voices(events: Iterable[tuple], n_voices: int):
    """Greedy polyphonic voice allocation: overlapping (pitch, start, dur)
    events -> ``n_voices`` monophonic event lists for :func:`note_tracks`.

    Each note goes to a lane that is free at its start (preferring the
    least-recently-freed, so releases get maximum ring-out); if none is
    free, the lane whose note started earliest is stolen -- its note is
    truncated at the new note's start (the classic oldest-note-steal
    policy of hardware polysynths).
    """
    lanes = [[] for _ in range(n_voices)]
    ends = [float("-inf")] * n_voices     # current note end per lane
    starts = [float("-inf")] * n_voices   # current note start per lane
    for pitch, start, dur in sorted(events, key=lambda e: e[1]):
        free = [i for i in range(n_voices) if ends[i] <= start]
        if free:
            i = min(free, key=lambda j: ends[j])  # longest-idle lane
        else:
            i = min(range(n_voices), key=lambda j: starts[j])  # steal oldest
            p0, s0, _ = lanes[i][-1]
            lanes[i][-1] = (p0, s0, start - s0)   # truncate stolen note
        lanes[i].append((pitch, start, dur))
        starts[i], ends[i] = start, start + dur
    return lanes


def note_tracks(event_lists: Sequence[Iterable[tuple]], n_samples: int,
                sample_rate: int, **kw):
    """Batch form: one event list per voice -> ``(gates[V, n], cvs[V, n])``
    for ``render_batch``."""
    pairs = [note_track(ev, n_samples, sample_rate, **kw)
             for ev in event_lists]
    gates = np.stack([g for g, _ in pairs])
    cvs = np.stack([c for _, c in pairs])
    return gates, cvs
