"""The yardstick of the roofline shares: the work a kernel's call needs,
from the patch description and the shapes alone, and the card's peaks.

The operation counts are frozen here (``OPS``, ``ADJOINT_OPS``), at the
counts the program gave its device functions (``csrc/modules.cuh``) and
adjoints (``csrc/modules_adj.cuh``) at commit 59a1174: one each add, sub,
mul, div, compare, select, min/max, abs, negation and int<->float
conversion on the path a sample takes.  A later edit of a device function
does not move them; ``check.py`` shows that they equal the program's own
counts at that commit.

The bound of a call is the larger of its f32 operations over the f32 peak
and its bytes, each read or written once, over the memory bandwidth.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

# f32 operations per sample of a module's step, by type: a base count and
# what a connected input or a static adds.  ``cv``: the pitch or cutoff
# input is connected; ``sync``: the Oscillator's Sync input is connected.
OPS = {
    "Oscillator": {"base": 15, "sync": 2, "antialiasing": 22, "cv": 30},
    "Moog Filter": {"base": 35, "cv": 17},
    "ADSR": {"base": 20},
    "VCA": {"base": 3, "negative": -2},
    "Mono Mixer": {"per_input": 2},
    "Add": {"base": 1}, "Subtract": {"base": 1}, "Multiply": {"base": 1},
    "Non-Linear": {"base": 23},
    "Grid Sequencer": {"base": 8},
    "Pattern Sequencer": {"base": 19},
    "Input": {"base": 0}, "Noise": {"base": 0}, "Output": {"base": 0},
}

# f32 operations per sample of a module's adjoint (its derivative's own;
# the primal values it needs are the recomputed step's)
ADJOINT_OPS = {
    "Oscillator": {"base": 17, "sync": 1, "antialiasing": 30, "cv": 25},
    "Moog Filter": {"base": 102, "cv": 37},
    "ADSR": {"base": 27},
    "VCA": {"base": 5},
    "Mono Mixer": {"per_input": 4},
    "Multiply": {"base": 4}, "Add": {"base": 2}, "Subtract": {"base": 2},
    "Non-Linear": {"base": 60},
    "Grid Sequencer": {"base": 8},
    "Pattern Sequencer": {"base": 4},
    "Output": {"per_input": 4},
    "Input": {"base": 1}, "Noise": {"base": 0},
}

# words of state per voice, by type (Freeverb: its lines, see below)
STATE_WORDS = {"Oscillator": 3, "Moog Filter": 5, "ADSR": 6}

# Freeverb (K8): f32 operations per voice-sample: 16 combs x 6, 8
# allpasses x 3, the input gain 2, the stereo mix 10
FREEVERB_OPS = 16 * 6 + 8 * 3 + 2 + 10
COMBS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
ALLPASSES = (556, 441, 341, 225)
SPREAD = 23

# the module types with a device function: what the fused kernel (K1) and
# the serial stage (K3) run
DEVICE_TYPES = set(OPS)


def _count(table, desc, m) -> int:
    row = table.get(m["type"])
    if row is None:
        raise KeyError(f"no operation count for {m['type']!r}")
    ins = desc.inputs_of(m["name"])
    statics = m.get("statics", {})
    if m["type"] == "VCA" and not ({"Audio", "CV"} <= set(ins)):
        return 0
    ops = row.get("base", 0) + row.get("per_input", 0) * len(ins)
    if "CV" in ins:
        ops += row.get("cv", 0)
    if "Sync" in ins:
        ops += row.get("sync", 0)
    for key in ("antialiasing", "negative"):
        if statics.get(key, key == "antialiasing"):
            ops += row.get(key, 0)
    return ops


def step_ops(desc, m) -> int:
    """f32 operations per sample of module ``m``'s step."""
    return _count(OPS, desc, m)


def adjoint_ops(desc, m) -> int:
    """f32 operations per sample of module ``m``'s adjoint."""
    return _count(ADJOINT_OPS, desc, m)


def _param_words(modules) -> int:
    return sum(len(m.get("params", {})) for m in modules)


def _state_words(modules) -> int:
    return sum(STATE_WORDS.get(m["type"], 0) for m in modules)


def bound_ms(nbytes: float, ops: float) -> tuple:
    """``(ms, "bytes" | "operations")``: the least time of a call."""
    t_b = nbytes / PEAKS["bytes_per_s"]
    t_o = ops / PEAKS["f32_flops"]
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def stage_modules(desc) -> list:
    """The modules a fused kernel or serial stage runs: those with a
    device function."""
    return [m for m in desc.modules if m["type"] in DEVICE_TYPES]


def fused_work(desc, v: int, n: int) -> tuple:
    """``(bytes, ops)`` of one fused render (K1): params and state in,
    state and audio out; every module's step for every voice-sample."""
    mods = stage_modules(desc)
    words = _param_words(mods) + 2 * _state_words(mods) + desc.channels * n
    ops = sum(step_ops(desc, m) for m in mods) * v * n
    return 4 * v * words, ops


def stage_work(desc, v: int, n: int) -> tuple:
    """``(bytes, ops)`` of one serial-stage run (K3): as :func:`fused_work`,
    but its outputs are the wires that leave the stage."""
    mods = stage_modules(desc)
    names = {m["name"] for m in mods}
    out_wires = {src for m in desc.modules if m["name"] not in names
                 for src in desc.inputs_of(m["name"]).values()
                 if src[0] in names}
    out_wires |= {src for src in desc.inputs_of("output").values()
                  if src[0] in names}
    words = _param_words(mods) + 2 * _state_words(mods) + len(out_wires) * n
    ops = sum(step_ops(desc, m) for m in mods) * v * n
    return 4 * v * words, ops


def freeverb_lengths(sr: int) -> list:
    return [max(1, (t + extra) * sr // 44100)
            for extra in (0, SPREAD) for t in COMBS + ALLPASSES]


def freeverb_work(desc, m, v: int, n: int) -> tuple:
    """``(bytes, ops)`` of one Freeverb render (K8): its distinct input
    wires and its outputs read or written once, the lines and the 16
    filter states in and out."""
    ins = len(set(desc.inputs_of(m["name"]).values()))
    outs = len({src for mm in [*desc.modules, {"name": "output"}]
                for src in desc.inputs_of(mm["name"]).values()
                if src[0] == m["name"]})
    lines = sum(freeverb_lengths(desc.sample_rate))
    nbytes = 4 * v * ((ins + outs) * n + 2 * (lines + 16))
    return nbytes, FREEVERB_OPS * v * n


def vjp_work(desc, v: int, n: int, which: str) -> tuple:
    """``(bytes, ops)`` of K10.  ``"fwd"``: a fused render.  ``"bwd"``: one
    recompute of every step plus every adjoint per voice-sample; params
    and state in, the audio's cotangent in, the params' and initial
    state's cotangents out."""
    if which == "fwd":
        return fused_work(desc, v, n)
    mods = stage_modules(desc)
    out = {"type": "Output", "name": "output"}
    ops = (sum(step_ops(desc, m) + adjoint_ops(desc, m) for m in mods)
           + adjoint_ops(desc, out)) * v * n
    words = (2 * _param_words(mods) + 2 * _state_words(mods)
             + desc.channels * n)
    return 4 * v * words, ops
