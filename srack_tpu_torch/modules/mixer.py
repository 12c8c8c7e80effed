"""4-input mono mixer with per-channel gains (counterpart:
``srack_tpu/modules/mixer.py``).

out = sum over *connected* inputs of in_i * gain_i.
"""

from __future__ import annotations

import torch

from ..config import AudioConfig
from .base import CV_DTYPE, ModuleDef


def _make(cfg: AudioConfig, gains=(1.0, 1.0, 1.0, 1.0), gain=None):
    """``gain``, the param's own name, may stand for ``gains``: a patch can
    be built from its modules' param names, as for every other type."""
    gains = tuple(float(g) for g in (gains if gain is None else gain))
    return ("mixer", len(gains)), {"gain": torch.tensor(gains, dtype=CV_DTYPE)}


def _n_in(cfg: AudioConfig, statics) -> int:
    return statics[1]


def _in_labels(cfg: AudioConfig, statics):
    return (None,) * statics[1]


def _init_state(cfg: AudioConfig, statics, device=None):
    return {}


def _step(cfg: AudioConfig, statics, params, state, ins, x=None):
    out = torch.zeros((), dtype=CV_DTYPE)
    for i, signal in enumerate(ins):
        if signal is not None:
            out = out + signal * params["gain"][..., i]
    return state, (out,)


MONO_MIXER = ModuleDef(
    type_name="Mono Mixer",
    make=_make,
    num_inputs=_n_in,
    num_outputs=lambda cfg, s: 1,
    input_labels=_in_labels,
    output_labels=lambda cfg, s: (None,),
    init_state=_init_state,
    step=_step,
    cuda_fn="srk_mono_mixer",
    cuda_adj="srk_mono_mixer_adj",
)
