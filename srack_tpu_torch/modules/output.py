"""Output sink module (counterpart: ``srack_tpu/modules/output.py``).

One input per channel.  The compiler treats the Output module as the
program's return value: its resolved per-sample inputs become the
``[channels, n]`` render result (an unconnected channel is 0.0).
"""

from __future__ import annotations

from ..config import AudioConfig
from .base import ModuleDef, in_or


def _make(cfg: AudioConfig):
    return ("output", cfg.channels), {}


def _n_in(cfg: AudioConfig, statics) -> int:
    return statics[1]


def _init_state(cfg: AudioConfig, statics, device=None):
    return {}


def _step(cfg: AudioConfig, statics, params, state, ins, x=None):
    return state, tuple(in_or(v, 0.0) for v in ins)


OUTPUT = ModuleDef(
    type_name="Output",
    make=_make,
    num_inputs=_n_in,
    num_outputs=lambda cfg, s: 0,
    input_labels=lambda cfg, s: (None,) * s[1],
    output_labels=lambda cfg, s: (),
    init_state=_init_state,
    step=_step,
    cuda_fn="srk_output",
    cuda_adj="srk_output_adj",
)
