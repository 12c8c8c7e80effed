"""Helpers around the render API (counterpart: ``srack_tpu/utils``).

Slice 2 of the port holds the pitch and note helpers that build Input
driver lanes; losses and training are slice 5.
"""

from .pitch import cv_to_hz, hz_to_cv, midi_to_cv, note_to_cv
from .notes import note_track, note_tracks

__all__ = ["hz_to_cv", "cv_to_hz", "midi_to_cv", "note_to_cv",
           "note_track", "note_tracks"]
