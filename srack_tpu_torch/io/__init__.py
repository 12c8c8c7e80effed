"""Audio and patch files (counterpart: ``srack_tpu/io``)."""

from .wav import read_wav, write_wav
from .patchfile import save_patch, load_patch, save_state, load_state
from .srk import read_srk, write_srk
from .midi import read_midi

__all__ = ["read_wav", "write_wav", "save_patch", "load_patch",
           "save_state", "load_state", "read_srk", "write_srk",
           "read_midi"]
