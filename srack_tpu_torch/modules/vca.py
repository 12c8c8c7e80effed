"""Voltage-controlled amplifier (counterpart: ``srack_tpu/modules/vca.py``).

out = audio * cv gated on cv > 0 (ungated when ``negative`` is set); if
either input is unconnected the output is silence.
"""

from __future__ import annotations

import torch

from ..config import AudioConfig
from .base import CV_DTYPE, ModuleDef, const_ports


def _make(cfg: AudioConfig, negative: bool = False):
    return ("vca", bool(negative)), {}


def _init_state(cfg: AudioConfig, statics, device=None):
    return {}


def _step(cfg: AudioConfig, statics, params, state, ins, x=None):
    (_, negative) = statics
    audio, control = ins
    if audio is None or control is None:
        return state, (torch.zeros((), dtype=CV_DTYPE),)
    if negative:
        out = audio * control
    else:
        out = torch.where(control > 0.0, audio * control, 0.0)
    return state, (out,)


_nin, _inlabels = const_ports(2, ("Audio", "CV"))
_nout, _outlabels = const_ports(1, (None,))

VCA = ModuleDef(
    type_name="VCA",
    make=_make,
    num_inputs=_nin,
    num_outputs=_nout,
    input_labels=_inlabels,
    output_labels=_outlabels,
    init_state=_init_state,
    step=_step,
    cuda_fn="srk_vca",
    cuda_adj="srk_vca_adj",
)
