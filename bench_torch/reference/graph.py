"""The plain reference of a configuration: its patch run module by module
over whole signals of many voices at once, in an order where every module
follows its inputs.

The configurations hold no feedback cycle, so each module's whole signal
can be made before the modules it feeds.  ``render(desc, params, n,
prec)`` returns the voices' ``[v, channels, n]`` float32 numpy array.
"""

from __future__ import annotations

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


def render(desc, params: dict, n: int, prec="f32") -> np.ndarray:
    """``v`` voices of ``desc`` for ``n`` samples from the initial state,
    with ``params`` ``{module: {param: [v] array}}``: a ``[v, channels,
    n]`` float32 numpy array."""
    prec = PRECISIONS[prec] if isinstance(prec, str) else prec
    sr = desc.sample_rate
    v = len(next(a for pd in params.values() for a in pd.values()))
    sig = {}
    for m in order(desc):
        name, t = m["name"], m["type"]
        ins = {}
        for port, (src, sp) in desc.inputs_of(name).items():
            label = INPUTS[t][port] if isinstance(port, int) else port
            ins[label] = sig[(src, sp)]
        outs = MODULES[t](prec, params.get(name, {}), ins, v, n, sr,
                          **m.get("statics", {}))
        for port, x in outs.items():
            sig[(name, port)] = x
    chans = []
    feeds = desc.inputs_of("output")
    for c in range(desc.channels):
        x = sig[feeds[c]] if c in feeds else torch.zeros(v, n)
        chans.append(torch.broadcast_to(x, (v, n)).to(torch.float32).numpy())
    return np.stack(chans, 1)
