"""The plain reference of a configuration: its patch run module by module
over whole signals of many voices at once, in an order where every module
follows its inputs.

The configurations hold no feedback cycle, so each module's whole signal
can be made before the modules it feeds.  ``render(desc, params, n,
prec, voices)`` returns the voices' ``[v, channels, n]`` float32 numpy
array.  A configuration that names ``"graph"`` as its reference is
checked by this walk over ``modules.MODULES``.

A reference file of its own (``reference/<name>.py``, named by a
configuration) extends the walk without a copy: a table of its module
types' functions and input labels, and a ``render`` that calls this one
with ``modules=`` and ``inputs=``, e.g. ``{**MODULES, "Noise": noise}``
and ``{**INPUTS, "Noise": ()}``.  A module function takes ``(prec,
params, ins, v, n, sr, **statics)`` as ``modules.py`` describes, and one
that declares a ``voices`` keyword is also given the voices' rows in
their render (``check.Item.voices``: ``{"row": [v], "render_voices":
[v]}`` int64 arrays), e.g. to draw the noise that the voice at row ``g``
of the program's render heard; it is None where the caller has none.
A walk of another shape (a cycle, one sample at a time) or another
precision is a file of its own, not an edit here.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from .modules import MODULES
from .precision import PRECISIONS

# the input labels of each module type, by port index
INPUTS = {"Oscillator": ("CV", "Sync"), "Multiply": ("In1", "In2"),
          "VCA": ("Audio", "CV"), "Moog Filter": ("Audio", "CV"),
          "ADSR": ("Gate",), "Freeverb": ("Left", "Right")}


def order(desc) -> list:
    """The modules in an order where each follows every module it reads."""
    done, out = set(), []
    pending = list(desc.modules)
    while pending:
        for m in pending:
            srcs = {src for src, _ in desc.inputs_of(m["name"]).values()}
            if srcs <= done:
                out.append(m)
                done.add(m["name"])
                pending.remove(m)
                break
        else:
            raise ValueError(f"{desc.name}: the patch has a cycle")
    return out


def render(desc, params: dict, n: int, prec="f32", voices=None, *,
           modules=MODULES, inputs=INPUTS) -> np.ndarray:
    """``v`` voices of ``desc`` for ``n`` samples from the initial state,
    with ``params`` ``{module: {param: [v] array}}``: a ``[v, channels,
    n]`` float32 numpy array.  ``modules`` and ``inputs`` map each module
    type to its function and its input labels by port index; ``voices``
    reaches only the functions that declare it."""
    prec = PRECISIONS[prec] if isinstance(prec, str) else prec
    sr = desc.sample_rate
    v = len(next(a for pd in params.values() for a in pd.values()))
    sig = {}
    for m in order(desc):
        name, t = m["name"], m["type"]
        ins = {}
        for port, (src, sp) in desc.inputs_of(name).items():
            label = inputs[t][port] if isinstance(port, int) else port
            ins[label] = sig[(src, sp)]
        fn = modules[t]
        kw = dict(m.get("statics", {}))
        if "voices" in inspect.signature(fn).parameters:
            kw["voices"] = voices
        outs = fn(prec, params.get(name, {}), ins, v, n, sr, **kw)
        for port, x in outs.items():
            sig[(name, port)] = x
    chans = []
    feeds = desc.inputs_of("output")
    for c in range(desc.channels):
        x = sig[feeds[c]] if c in feeds else torch.zeros(v, n)
        chans.append(torch.broadcast_to(x, (v, n)).to(torch.float32).numpy())
    return np.stack(chans, 1)
