"""Audio configuration.

TPU-native analogue of the reference engine's ``AudioConfig`` struct
(reference: src/synth.rs:21-25).  The reference hard-codes
48 kHz / stereo / block 1024 at the app entry (src/main.rs:16,115-117) and
pushes the config into every module; here it is an explicit dataclass handed
to :class:`srack_tpu.patch.Patch` and the render entry points.

Additions over the reference (build-side, see SURVEY.md §5 "Config"):

* ``precision`` — ``"exact"`` mirrors the reference's per-module dtypes
  (f64 oscillator phase / f64 freeverb core, f32 control voltages), intended
  for CPU oracle validation with ``jax_enable_x64``.  ``"fast"`` is the TPU
  performance mode: f32 everywhere, with oscillator phase kept in uint32
  fixed point (exact modular arithmetic -> zero long-render drift, unlike a
  raw f32 accumulator).
* ``buffer_feedback`` — when True, broken feedback edges read the value from
  ``block_size`` samples ago (the reference's previous-*buffer* semantics,
  src/synth.rs:168-192 + buffer persistence); when False (default) feedback
  reads the previous *sample*, which is the strictly-tighter fidelity a
  single fused per-sample program makes possible.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    sample_rate: int = 48000
    block_size: int = 1024
    channels: int = 2
    precision: Literal["exact", "fast"] = "fast"
    buffer_feedback: bool = False

    def __post_init__(self) -> None:
        if self.sample_rate <= 0:
            raise ValueError("sample_rate must be positive")
        if self.block_size <= 0:
            raise ValueError("block_size must be positive")
        if self.channels <= 0:
            raise ValueError("channels must be positive")
        if self.precision not in ("exact", "fast"):
            raise ValueError(f"unknown precision {self.precision!r}")

    @property
    def exact(self) -> bool:
        return self.precision == "exact"
