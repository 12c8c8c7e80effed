"""Helpers around the render API (counterpart: ``srack_tpu/utils``).

The pitch and note helpers build Input driver lanes; the losses and the
trainer fit a patch's params to target audio by gradient descent; the
profiling and debug helpers time renders, trace them and guard them.
"""

from .pitch import cv_to_hz, hz_to_cv, midi_to_cv, note_to_cv
from .notes import allocate_voices, note_track, note_tracks
from .losses import multiscale_spectral_loss, stft_mag, waveform_l2
from .profiling import RenderStats, span, timed_render, trace
from .debug import check_finite, quarantine_batch, recompile_guard

# the trainer is imported at first use: it imports the compiler, which
# imports this package for its spans
_TRAIN = ("SoundMatcher", "batched_train_step", "multi_train_step")


def __getattr__(name):
    if name in _TRAIN:
        from . import train
        return getattr(train, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["hz_to_cv", "cv_to_hz", "midi_to_cv", "note_to_cv",
           "note_track", "note_tracks", "allocate_voices",
           "multiscale_spectral_loss", "stft_mag", "waveform_l2",
           "SoundMatcher", "batched_train_step", "multi_train_step",
           "RenderStats", "span", "timed_render", "trace",
           "check_finite", "quarantine_batch", "recompile_guard"]
