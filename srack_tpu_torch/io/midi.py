"""Minimal Standard MIDI File reader -> note events (counterpart:
``srack_tpu/io/midi.py``; stdlib only).

Bridges .mid files to the engine's note sequencing (utils/notes.py): a
DAW/keyboard-shaped front door the reference leaves to its UI sequencers
(/root/reference/src/synth/sequencer.rs).  Stdlib-only, read-only, and
deliberately small: note on/off and tempo are honoured; other events are
skipped (their payloads are parsed enough to advance correctly).

Supports format 0 and 1 files with PPQN (ticks-per-quarter) timing.
Tempo changes apply from their tick onward (format 1: tempo map read from
all tracks, as conductor tracks require).
"""

from __future__ import annotations

import struct
from typing import Optional


def _read_varlen(data: bytes, pos: int) -> tuple[int, int]:
    val = 0
    while True:
        b = data[pos]
        pos += 1
        val = (val << 7) | (b & 0x7F)
        if not b & 0x80:
            return val, pos


def _parse_track(data: bytes):
    """Yield (tick, kind, payload) events; kind in {'on','off','tempo'}."""
    pos, tick, status = 0, 0, 0
    while pos < len(data):
        delta, pos = _read_varlen(data, pos)
        tick += delta
        b = data[pos]
        if b & 0x80:
            status = b
            pos += 1
        if status == 0xFF:  # meta
            meta = data[pos]
            length, pos2 = _read_varlen(data, pos + 1)
            body = data[pos2:pos2 + length]
            pos = pos2 + length
            if meta == 0x51 and length == 3:
                yield tick, "tempo", int.from_bytes(body, "big")
            if meta == 0x2F:  # end of track
                return
        elif status in (0xF0, 0xF7):  # sysex
            length, pos2 = _read_varlen(data, pos)
            pos = pos2 + length
        else:
            kind = status & 0xF0
            n_data = 1 if kind in (0xC0, 0xD0) else 2
            d = data[pos:pos + n_data]
            pos += n_data
            if kind == 0x90 and d[1] > 0:
                yield tick, "on", (status & 0x0F, d[0], d[1])
            elif kind == 0x80 or (kind == 0x90 and d[1] == 0):
                yield tick, "off", (status & 0x0F, d[0])


def read_midi(path_or_bytes, *, channel: Optional[int] = None):
    """Parse a .mid file -> list of (midi_note, start_sec, dur_sec) events.

    The result feeds :func:`srack_tpu_torch.utils.notes.note_track` /
    ``note_tracks`` directly (pitch as MIDI numbers).  ``channel`` filters
    to one MIDI channel (0-15); default merges all.  Events are sorted by
    start time; a note missing its note-off is held to the end of its
    track's last event.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data[:4] != b"MThd":
        raise ValueError("not a Standard MIDI File (missing MThd)")
    hlen, fmt, ntrk, division = struct.unpack(">IHHH", data[4:14])
    if division & 0x8000:
        raise ValueError("SMPTE-timed MIDI files are not supported")
    ppqn = division or 480

    # collect per-track event streams
    pos = 8 + hlen
    tracks = []
    for _ in range(ntrk):
        if data[pos:pos + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        tlen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        tracks.append(list(_parse_track(data[pos + 8:pos + 8 + tlen])))
        pos += 8 + tlen

    # tempo map from all tracks (format 1 keeps it in the conductor track)
    tempo_map = sorted(
        [(t, val) for trk in tracks for (t, kind, val) in trk
         if kind == "tempo"]) or [(0, 500000)]
    if tempo_map[0][0] != 0:
        tempo_map.insert(0, (0, 500000))

    def tick_to_sec(tick: int) -> float:
        sec = 0.0
        for i, (t0, us) in enumerate(tempo_map):
            t1 = (tempo_map[i + 1][0] if i + 1 < len(tempo_map)
                  else float("inf"))
            if tick <= t0:
                break
            span = min(tick, t1) - t0
            sec += span * us / (ppqn * 1e6)
        return sec

    events = []
    for trk in tracks:
        # FIFO per (channel, note): overlapping same-note notes (sustain /
        # legato DAW exports) pair each off with the earliest open on
        open_notes: dict = {}
        last_tick = max((t for t, _, _ in trk), default=0)
        for tick, kind, payload in trk:
            if kind == "on":
                ch, note, _vel = payload
                if channel is not None and ch != channel:
                    continue
                stack = open_notes.setdefault((ch, note), [])
                if stack:
                    # retrigger while held (hardware often re-sends note-on
                    # without an off): close the earlier note here rather
                    # than leave it open -- an unbalanced on would
                    # otherwise become a phantom drone held to track end
                    t0 = stack.pop(0)
                    events.append((note, tick_to_sec(t0),
                                   tick_to_sec(tick) - tick_to_sec(t0)))
                stack.append(tick)
            elif kind == "off":
                ch, note = payload
                if channel is not None and ch != channel:
                    continue
                stack = open_notes.get((ch, note))
                if stack:
                    t0 = stack.pop(0)
                    events.append(
                        (note, tick_to_sec(t0),
                         tick_to_sec(tick) - tick_to_sec(t0)))
        for (ch, note), starts in open_notes.items():  # missing note-offs
            for t0 in starts:
                events.append((note, tick_to_sec(t0),
                               tick_to_sec(last_tick) - tick_to_sec(t0)))
    events.sort(key=lambda e: e[1])
    return events
