"""External input (driver) module (counterpart:
``srack_tpu/modules/input.py``).

An Input module emits a per-sample array handed to the render entry point
as ``drivers={handle: array}`` (gate and CV lanes, MIDI-derived control,
conditioning signals); with no driver bound it emits its constant
``value`` param.
"""

from __future__ import annotations

from ..config import AudioConfig
from .base import CV_DTYPE, ModuleDef, const_ports, cv


def _make(cfg: AudioConfig, value: float = 0.0):
    return ("input",), {"value": cv(value)}


def _init_state(cfg: AudioConfig, statics, device=None):
    return {}


def _step(cfg: AudioConfig, statics, params, state, ins, x=None):
    if x is None:
        return state, (params["value"],)
    return state, (x.to(CV_DTYPE),)


_nin, _inlabels = const_ports(0, ())
_nout, _outlabels = const_ports(1, (None,))

INPUT = ModuleDef(
    type_name="Input",
    make=_make,
    num_inputs=_nin,
    num_outputs=_nout,
    input_labels=_inlabels,
    output_labels=_outlabels,
    init_state=_init_state,
    step=_step,
    cuda_fn="srk_input",
    cuda_adj="srk_input_adj",
)
