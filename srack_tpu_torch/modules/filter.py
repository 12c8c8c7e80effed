"""Moog-style 4-pole ladder filter (counterpart: ``srack_tpu/modules/filter.py``).

The musicdsp "Moog VCF variation 1": coefficients from the normalised cutoff
and resonance, four cascaded one-pole stages, a cubic soft-clip on the last
stage, and the stage vector clamped to [-1, 1].  Outputs: 0 = lowpass,
1 = bandpass, 2 = highpass.  Effective cutoff = clamp(freq + cv * exp_amt,
0, 0.9), res clamped to [0, 1].  All math is f32.
"""

from __future__ import annotations

import torch

from ..config import AudioConfig
from ..ops.basic import clip
from .base import CV_DTYPE, ModuleDef, const_ports, cv, in_or


def _make(cfg: AudioConfig, freq: float = 0.2, res: float = 0.5, exp_amt: float = 0.5):
    return ("moog",), {"freq": cv(freq), "res": cv(res), "exp_amt": cv(exp_amt)}


def _init_state(cfg: AudioConfig, statics, device=None):
    return {"b": torch.zeros((5,), dtype=CV_DTYPE, device=device)}


def moog_coefs(frequency, res):
    """Coefficients from normalised cutoff + resonance."""
    q0 = 1.0 - frequency
    p = frequency + 0.8 * frequency * q0
    f = p * 2.0 - 1.0
    q = res * (1.0 + 0.5 * q0 * (1.0 - q0 + 5.6 * q0 * q0))
    return p, f, q


def moog_stage(b, audio, p, f, q):
    """One sample of the ladder core.  ``b`` is the stage vector, its 5
    stages on the last axis.  Returns (new_b, lp, hp, bp)."""
    b0, b1, b2, b3, b4 = b.unbind(-1)
    x = audio - q * b4
    nb1 = (x + b0) * p - b1 * f
    nb2 = (nb1 + b1) * p - b2 * f
    nb3 = (nb2 + b2) * p - b3 * f
    nb4 = (nb3 + b3) * p - b4 * f
    nb4 = nb4 - nb4 * nb4 * nb4 * 0.166667
    nb0 = x
    stages = torch.broadcast_tensors(nb0, nb1, nb2, nb3, nb4)
    new_b = clip(torch.stack(stages, dim=-1), -1.0, 1.0)
    lp = new_b[..., 4]
    hp = x - new_b[..., 4]
    bp = 3.0 * (new_b[..., 3] - new_b[..., 4])
    return new_b, lp, hp, bp


def _derive(cfg: AudioConfig, statics, params, connected):
    res = clip(params["res"], 0.0, 1.0)
    out = {"res_clip": res}
    if len(connected) < 2 or not connected[1]:
        # CV unconnected: the whole coefficient chain is loop-invariant
        frequency = clip(params["freq"], 0.0, 0.9)
        p, f, q = moog_coefs(frequency, res)
        out.update({"moog_p": p, "moog_f": f, "moog_q": q})
    return out


def _step(cfg: AudioConfig, statics, params, state, ins, x=None):
    audio = in_or(ins[0], 0.0)
    if ins[1] is None and "moog_p" in params:
        p, f, q = params["moog_p"], params["moog_f"], params["moog_q"]
    else:
        cv_in = in_or(ins[1], 0.0)
        res = params.get("res_clip")
        if res is None:
            res = clip(params["res"], 0.0, 1.0)
        frequency = clip(params["freq"] + cv_in * params["exp_amt"],
                         0.0, 0.9)
        p, f, q = moog_coefs(frequency, res)
    new_b, lp, hp, bp = moog_stage(state["b"], audio, p, f, q)
    return {"b": new_b}, (lp, bp, hp)


_nin, _inlabels = const_ports(2, ("Audio", "CV"))
_nout, _outlabels = const_ports(3, (None, None, None))

MOOG_FILTER = ModuleDef(
    type_name="Moog Filter",
    make=_make,
    num_inputs=_nin,
    num_outputs=_nout,
    input_labels=_inlabels,
    output_labels=_outlabels,
    init_state=_init_state,
    step=_step,
    derive=_derive,
    cuda_fn="srk_moog_filter",
    cuda_adj="srk_moog_filter_adj",
)
