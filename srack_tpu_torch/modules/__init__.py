"""The DSP module library and catalog (counterpart:
``srack_tpu/modules/__init__.py``).

Every module type of the JAX package's catalog: slices 1 and 2 of the
port hold those of the fused engine, slice 3a adds the Freeverb and slice
3b the Sample player.
"""

from .base import CV_DTYPE, ModuleDef
from .oscillator import OSCILLATOR, NOISE
from .filter import MOOG_FILTER
from .adsr import ADSR
from .vca import VCA
from .mixer import MONO_MIXER
from .math import ADD, SUBTRACT, MULTIPLY, NON_LINEAR
from .sequencer import GRID_SEQUENCER, PATTERN_SEQUENCER
from .input import INPUT
from .output import OUTPUT
from .freeverb import FREEVERB
from .sample import SAMPLE

# Creatable module types, in the reference catalog's order.
CATALOG: dict[str, ModuleDef] = {
    d.type_name: d
    for d in (
        OSCILLATOR,
        NOISE,
        GRID_SEQUENCER,
        PATTERN_SEQUENCER,
        ADSR,
        VCA,
        MOOG_FILTER,
        MONO_MIXER,
        SAMPLE,
        ADD,
        SUBTRACT,
        MULTIPLY,
        NON_LINEAR,
        FREEVERB,
        OUTPUT,
        INPUT,
    )
}

# Types of the reference catalog that the port does not carry yet.
NOT_PORTED = frozenset()

# Catalog entries present at import time; :func:`unregister` refuses to
# remove these.
_BUILTIN_TYPES = frozenset(CATALOG)


def register(mdef: ModuleDef, *, replace: bool = False) -> ModuleDef:
    """Add a user-defined module type to the catalog.

    Once registered, the type is creatable with ``Patch.add(name)`` and runs
    on the scan engine; it runs in the fused CUDA kernel only when it names
    a device function (``ModuleDef.cuda_fn``) that ``csrc/modules.cuh``
    defines.  Returns ``mdef``.
    """
    if not isinstance(mdef, ModuleDef):
        raise TypeError(f"expected a ModuleDef, got {type(mdef).__name__}")
    if not mdef.type_name or not isinstance(mdef.type_name, str):
        raise ValueError("ModuleDef.type_name must be a non-empty string")
    for attr in ("make", "num_inputs", "num_outputs", "input_labels",
                 "output_labels", "init_state", "step"):
        if not callable(getattr(mdef, attr, None)):
            raise ValueError(f"ModuleDef.{attr} must be callable")
    if mdef.type_name in _BUILTIN_TYPES:
        raise ValueError(
            f"cannot replace built-in module type {mdef.type_name!r}")
    if mdef.type_name in CATALOG and not replace:
        raise ValueError(
            f"module type {mdef.type_name!r} is already registered "
            "(pass replace=True to override a custom type)")
    CATALOG[mdef.type_name] = mdef
    return mdef


def unregister(type_name: str) -> None:
    """Remove a previously :func:`register`-ed custom module type."""
    if type_name in _BUILTIN_TYPES:
        raise ValueError(f"cannot unregister built-in type {type_name!r}")
    if type_name not in CATALOG:
        raise KeyError(f"module type {type_name!r} is not registered")
    del CATALOG[type_name]


__all__ = [
    "CATALOG",
    "CV_DTYPE",
    "NOT_PORTED",
    "ModuleDef",
    "register",
    "unregister",
    "OSCILLATOR",
    "NOISE",
    "MOOG_FILTER",
    "ADSR",
    "VCA",
    "MONO_MIXER",
    "ADD",
    "SUBTRACT",
    "MULTIPLY",
    "NON_LINEAR",
    "GRID_SEQUENCER",
    "PATTERN_SEQUENCER",
    "INPUT",
    "OUTPUT",
    "FREEVERB",
    "SAMPLE",
]
