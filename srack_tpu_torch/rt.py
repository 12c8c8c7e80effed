"""Real-time playback: the supported audio-device sink (counterpart:
``srack_tpu/rt.py``).

The reference's cpal ``AudioEngine`` opens the default output device and
fills it block-by-block from the graph (src/main.rs:24-101: the callback
runs ``synth::execute`` whenever its interleave cursor wraps, then copies
the Output module's buffers out).  Here the same contract is a paced
consumer loop over :func:`srack_tpu_torch.engine.render_stream`, which
renders on the card by default (one voice as a batch of one on the
kernels):

* :func:`paced_consume` -- pull blocks just-in-time against wall-clock
  deadlines, counting late blocks as underruns (the cpal glitch analogue).
  This is the pacing primitive.
* :func:`play` -- the supported ``engine.play()`` API: stream a patch to
  a live audio device (``sounddevice``/PortAudio when available), a WAV
  file, or a null sink, with underrun accounting returned to the caller.

Live patching works during playback exactly as in :func:`render_stream`
(mutate the patch between blocks; state migrates), matching the
reference's play-while-editing loop (src/ui.rs:63-82).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from .config import AudioConfig
from .engine import render_stream
from .patch import Patch


def _host(audio) -> np.ndarray:
    """A block as a numpy array: the copy to the host waits for the
    device, so a block counts as ready only once it is rendered."""
    if hasattr(audio, "detach"):
        return audio.detach().cpu().numpy()
    return np.asarray(audio)


def paced_consume(stream, block_s: float, on_block: Optional[Callable] = None,
                  n_prime: int = 2):
    """The DAC-paced consumer loop (the cpal-callback replacement,
    src/main.rs:59-90): pull blocks just-in-time against wall-clock
    deadlines of ``block_s`` seconds, counting late blocks as underruns.

    ``on_block(block)`` receives each numpy block (including the
    ``n_prime`` warm-up blocks pulled before timing starts -- compiles
    happen there, as the reference builds its plan before streaming).
    Returns ``(underruns, worst_headroom, blocks_timed)``.
    """
    for _ in range(n_prime):
        audio = _host(next(stream)[0])
        if on_block is not None:
            on_block(audio)
    underruns = 0
    worst_headroom = block_s
    timed = 0
    t0 = time.perf_counter()
    deadline = t0
    for audio, _, _ in stream:
        block = _host(audio)
        now = time.perf_counter()
        headroom = (deadline + block_s) - now
        worst_headroom = min(worst_headroom, headroom)
        if headroom < 0:
            underruns += 1
            deadline = now          # resync after a glitch, like a DAC
        else:
            deadline += block_s
        # pace like a DAC: do not run ahead of real time
        ahead = deadline - time.perf_counter()
        if ahead > 0:
            time.sleep(ahead)
        timed += 1
        if on_block is not None:
            on_block(block)
    return underruns, worst_headroom, timed


@dataclass
class PlayStats:
    """Underrun accounting from one :func:`play` run (the observability
    the reference lacks -- cpal errors are swallowed, main.rs:91)."""
    blocks: int
    underruns: int
    worst_headroom_s: float
    seconds: float

    @property
    def ok(self) -> bool:
        # tolerate scheduler jitter on a busy host; >10% late is a failure
        return self.underruns <= 0.1 * max(self.blocks, 1)


def play(patch: Patch, seconds: Optional[float] = None, *,
         sink: str = "auto", voices: Optional[int] = None, params=None,
         key=None, out_path: str = "play_out.wav",
         on_block: Optional[Callable] = None, device=None) -> PlayStats:
    """Play a patch in real time -- the supported ``AudioEngine`` analogue.

    ``sink``:
      * ``"device"`` -- default audio output via ``sounddevice``
        (PortAudio); raises if unavailable.
      * ``"wav"`` -- paced render accumulated to ``out_path``.
      * ``"null"`` -- paced render discarded (timing/underrun probe).
      * ``"auto"`` -- device if available, else wav.

    ``voices``: batched playback (see :func:`render_stream`); the device
    sink plays a monitor mixdown (mean over voices).  ``seconds=None``
    plays until the stream is exhausted (infinite for live use -- stop
    with KeyboardInterrupt; accounting still returns).  ``device``: where
    the stream renders (the card by default; ``"cpu"`` for the CPU).

    Returns :class:`PlayStats`.
    """
    cfg: AudioConfig = patch.config
    block_s = cfg.block_size / cfg.sample_rate
    n_blocks = None if seconds is None else max(1, int(seconds / block_s))

    out_stream = None
    kind = sink
    if sink in ("auto", "device"):
        try:
            import sounddevice as sd
            out_stream = sd.OutputStream(samplerate=cfg.sample_rate,
                                     channels=cfg.channels, dtype="float32")
            out_stream.start()
            kind = "device"
        except Exception:
            if sink == "device":
                raise
            kind = "wav"

    stream = render_stream(patch, n_blocks=n_blocks, voices=voices,
                           params=params, key=key, device=device)
    blocks: list = []

    def consume(block):
        if voices is not None:
            block = block.mean(axis=0)  # monitor mix of the voice batch
        if kind == "device":
            out_stream.write(np.ascontiguousarray(block.T))
        elif kind == "wav":
            blocks.append(block)
        if on_block is not None:
            on_block(block)

    t0 = time.perf_counter()
    try:
        underruns, worst, timed = paced_consume(stream, block_s,
                                                on_block=consume)
    except KeyboardInterrupt:
        underruns, worst, timed = 0, block_s, len(blocks)
    finally:
        if out_stream is not None:
            out_stream.stop()
            out_stream.close()
    wall = time.perf_counter() - t0

    if kind == "wav" and blocks:
        from .io import write_wav
        write_wav(out_path, np.concatenate(blocks, axis=-1),
                  cfg.sample_rate)
    return PlayStats(blocks=timed, underruns=underruns,
                     worst_headroom_s=worst, seconds=wall)
