"""Math (Add / Subtract / Multiply) and Non-Linear (signed power) modules
(counterpart: ``srack_tpu/modules/math.py``).

An unconnected In1 falls back to 0.0 and an unconnected In2 to the
``constant`` param.  Non-Linear is ``a > 0 ? a^b : -((-a)^b)``.
"""

from __future__ import annotations

import torch

from ..config import AudioConfig
from .base import ModuleDef, const_ports, cv, in_or

_OPS = ("Add", "Subtract", "Multiply")


def _math_make_for(op: str):
    def make(cfg: AudioConfig, constant: float = 0.0):
        return ("math", op), {"constant": cv(constant)}
    return make


def _math_init_state(cfg: AudioConfig, statics, device=None):
    return {}


def _math_step(cfg: AudioConfig, statics, params, state, ins, x=None):
    (_, op) = statics
    a = in_or(ins[0], 0.0)
    b = params["constant"] if ins[1] is None else ins[1]
    if op == "Add":
        out = a + b
    elif op == "Subtract":
        out = a - b
    elif op == "Multiply":
        out = a * b
    else:  # pragma: no cover
        raise ValueError(f"unknown math op {op!r}")
    return state, (out,)


_nin2, _inlabels2 = const_ports(2, ("In1", "In2"))
_nout1, _outlabels1 = const_ports(1, (None,))


def math_module_def(op: str) -> ModuleDef:
    if op not in _OPS:
        raise ValueError(f"unknown math op {op!r}")
    return ModuleDef(
        type_name=op,
        make=_math_make_for(op),
        num_inputs=_nin2,
        num_outputs=_nout1,
        input_labels=_inlabels2,
        output_labels=_outlabels1,
        init_state=_math_init_state,
        step=_math_step,
        # stateless: an automated constant is a [V, n] lane elementwise
        auto_block_params=frozenset({"constant"}),
        cuda_fn=f"srk_{op.lower()}",
        cuda_adj=f"srk_{op.lower()}_adj",
    )


ADD = math_module_def("Add")
SUBTRACT = math_module_def("Subtract")
MULTIPLY = math_module_def("Multiply")


def _nl_make(cfg: AudioConfig, constant: float = 1.0):
    return ("nonlinear",), {"constant": cv(constant)}


def signed_pow(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a > 0 ? a^b : -((-a)^b)``; powf(0, 0) is 1, so a == 0 gives -1."""
    return torch.where(a > 0.0, torch.pow(a, b), -torch.pow(-a, b))


def _nl_step(cfg: AudioConfig, statics, params, state, ins, x=None):
    a = in_or(ins[0], 0.0)
    b = params["constant"] if ins[1] is None else ins[1]
    return state, (signed_pow(a, b),)


NON_LINEAR = ModuleDef(
    type_name="Non-Linear",
    make=_nl_make,
    num_inputs=_nin2,
    num_outputs=_nout1,
    input_labels=_inlabels2,
    output_labels=_outlabels1,
    init_state=_math_init_state,
    step=_nl_step,
    auto_block_params=frozenset({"constant"}),
    cuda_fn="srk_non_linear",
    cuda_adj="srk_non_linear_adj",
)
