"""The plain reference of a patch with feedback cycles: s-rack's engine run
a block at a time.

s-rack (``src/synth.rs:97-218``, ``plan_execution`` and ``is_loop``) orders
a patch by deleting a back edge of every cycle, then runs each module in
that order over a buffer of ``block_size`` samples.  A module reads its
sources' buffers as they stand when it runs, so an input whose source runs
at or after it reads that source's previous block, zeros in the first
block (:func:`cycle_break`, :func:`late_wires`).

The walk renders ``n / block`` blocks.  Within a block the modules run in
the plan's order on ``[v, block]`` slices, each keeping its state from one
block to the next: stateful block forms of the Oscillator (with a pitch
CV, i.e. FM), the Multiply, the Mono Mixer and the Moog Filter, in the
program's f32 operation order, built on the helpers of ``modules.py``.
A cross-FM pair is chaotic, so an ulp anywhere grows to a different
sound over seconds: the forms follow the program's fixed-point phase and
its operations one by one.  Nothing here imports the program.

``render(desc, params, n, prec, voices)`` is the check's entry; ``lag``
(the feedback's delay in samples, a block unless a test says otherwise)
is for the tests' deliberately wrong references.
"""

from __future__ import annotations

import numpy as np
import torch

from .modules import blep, exp2, sinpi, to_fixed
from .precision import PRECISIONS

# each module type's input labels and output labels, by port index (the
# Mono Mixer's and the Output's ports are their indices)
INPUTS = {"Oscillator": ("CV", "Sync"), "Multiply": ("In1", "In2"),
          "Moog Filter": ("Audio", "CV"), "Mono Mixer": (0, 1, 2, 3),
          "Output": (0, 1)}
OUTPUTS = {"Oscillator": ("Sine", "Square", "Sawtooth"),
           "Multiply": (0,), "Moog Filter": (0, 1, 2), "Mono Mixer": (0,)}


def _type(desc, name: str) -> str:
    if name == "output":
        return "Output"
    return next(m["type"] for m in desc.modules if m["name"] == name)


def _index(labels, port) -> int:
    return port if isinstance(port, int) else labels.index(port)


def _sources(desc, name: str) -> list:
    """The modules a module reads, in the order of its input ports."""
    labels = INPUTS[_type(desc, name)]
    ins = desc.inputs_of(name)
    return [ins[p][0] for p in sorted(ins, key=lambda p: _index(labels, p))]


def _loop_holder(module: str, deps: dict):
    """``is_loop``: a breadth-first search back from ``module`` through
    the sources; the first module found that reads ``module``, or None."""
    queue, seen = [module], set()
    while True:
        current = next((m for m in queue if m not in seen), None)
        if current is None:
            return None
        seen.add(current)
        for src in deps[current]:
            if src == module:
                return current
        queue.extend(deps[current])


def cycle_break(desc) -> tuple:
    """``(plan, broken)``: the order s-rack runs the modules in (the Output
    named ``"output"``) and the edges it deletes, each ``(source, sink)``.

    1. Each module's sources, in its input ports' order, duplicates kept.
    2. Depth first from the module list, the Output first (it stands first
       in the list, made with the rack, and is searched from first): at
       each module reached, while ``is_loop`` finds a module that reads
       it around a cycle, every read of it by that module is deleted.
    3. Over and over, the first module of the list whose remaining sources
       have all run runs next."""
    names = ["output"] + [m["name"] for m in desc.modules]
    deps = {name: _sources(desc, name) for name in names}
    broken = set()
    todo, reached = names + ["output"], set()
    while todo:
        module = todo.pop()
        if module in reached:
            continue
        reached.add(module)
        todo.extend(deps[module])
        holder = _loop_holder(module, deps)
        while holder is not None:
            deps[holder] = [d for d in deps[holder] if d != module]
            broken.add((module, holder))
            holder = _loop_holder(module, deps)
    plan = []
    while len(plan) < len(names):
        plan.append(next(m for m in names if m not in plan
                         and all(d in plan for d in deps[m])))
    return plan, broken


def _wire(desc, src: str, port) -> tuple:
    """A source port as ``(module, output index)``."""
    return src, _index(OUTPUTS[_type(desc, src)], port)


def late_wires(desc) -> list:
    """The wires read a block late, ``(module, output index)``, once
    each: those whose source runs at or after a module that reads them.
    The program keeps one block of each in its feedback ring."""
    plan, _ = cycle_break(desc)
    at = {m: i for i, m in enumerate(plan)}
    wires = {_wire(desc, src, sp) for sink in plan
             for src, sp in desc.inputs_of(sink).values()
             if at[src] >= at[sink]}
    return sorted(wires)


def _column(prec, a) -> torch.Tensor:
    """A per-voice param ``[v]`` (or ``[v, k]``) as ``[v, 1]`` (``[v, k]``)
    of ``prec.dtype``."""
    a = np.asarray(a, dtype=np.float32)
    a = a.reshape(-1, 1) if a.ndim == 1 else a
    return torch.from_numpy(np.ascontiguousarray(a)).to(prec.dtype)


class Oscillator:
    """The phase an int32 fixed-point accumulator carried from block to
    block; a sample's waves are those of the phase before its increment,
    whose rate follows the CV sample by sample (``CV + val`` octaves)."""

    def __init__(self, prec, params, v, sr, antialiasing=True):
        self.prec, self.v, self.sr = prec, v, sr
        self.val = _column(prec, params["val"])
        self.antialiasing = antialiasing
        self.pos = torch.zeros((v, 1), dtype=torch.int64)

    def __call__(self, ins, m):
        if "Sync" in ins:
            raise NotImplementedError("the reference has no Sync input")
        octs = self.val if "CV" not in ins else ins["CV"] + self.val
        delta = exp2(self.prec, octs) * (440.0 / self.sr)
        dfix = to_fixed(delta).to(torch.int64).expand(self.v, m)
        delta = delta.expand(self.v, m)
        incl = self.pos + torch.cumsum(dfix, -1)
        pos = ((incl - dfix + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)
        self.pos = incl[:, -1:] % 2 ** 32
        s = pos.to(self.prec.dtype) * (1.0 / 2147483648.0)
        sine = sinpi(s)
        square = torch.where(pos >= 0, -1.0, 1.0).to(self.prec.dtype)
        saw = s + square
        if self.antialiasing:
            inv2dt = 0.5 / delta
            b0 = blep(s * inv2dt)
            bh = blep(saw * inv2dt)
            square = square - (b0 - bh)
            saw = saw - b0
        return {0: sine, "Sine": sine, 1: square, "Square": square,
                2: saw, "Sawtooth": saw}


class Multiply:
    """``In1 * In2``; an unconnected In1 is 0, an unconnected In2 the
    ``constant``."""

    def __init__(self, prec, params, v, sr):
        self.prec, self.v = prec, v
        self.constant = _column(prec, params["constant"])

    def __call__(self, ins, m):
        a = ins.get("In1", torch.zeros((self.v, m), dtype=self.prec.dtype))
        b = ins.get("In2", self.constant)
        return {0: torch.broadcast_to(a * b, (self.v, m))}


class MonoMixer:
    """From 0, each connected input times its gain added, by port."""

    def __init__(self, prec, params, v, sr):
        self.prec, self.v = prec, v
        self.gain = _column(prec, params["gain"])

    def __call__(self, ins, m):
        acc = torch.zeros((self.v, m), dtype=self.prec.dtype)
        for i in sorted(ins):
            acc = acc + ins[i] * self.gain[:, i:i + 1]
        return {0: acc}


class MoogFilter:
    """The musicdsp ladder one sample at a time, every voice at once, each
    op rounded by ``prec.r``, its five stages carried from block to block:
    the step of ``modules.moog_filter``, which runs a whole signal from
    rest.  A step's signals sit as rows of one ``[10, v]`` buffer, ``(n3,
    n4, n1, n2, x, b3, b4, b1, b2, b0)``; two buffers take turns as this
    step's and the last."""

    def __init__(self, prec, params, v, sr):
        R, C = prec.r, prec.const
        one, zero = C(1.0), C(0.0)
        freq = np.minimum(np.maximum(prec.array(params["freq"]), zero),
                          C(0.9))
        res = np.minimum(np.maximum(prec.array(params["res"]), zero), one)
        q0 = R(one - freq)
        self.p = R(freq + R(R(C(0.8) * freq) * q0))
        self.f = R(R(self.p * C(2.0)) - one)
        self.q = R(res * R(one + R(R(C(0.5) * q0)
                                   * R(R(one - q0) + R(R(C(5.6) * q0) * q0)))))
        self.prec, self.v = prec, v
        bufs = []
        for _ in range(2):
            z = np.zeros((10, v), np.float32)
            bufs.append((z, z[:5], z[5:], z[4:7], z[5:9], *z))
        self.last, self.this = bufs

    def __call__(self, ins, m):
        if "CV" in ins:
            raise NotImplementedError("the reference has no cutoff CV input")
        prec, v = self.prec, self.v
        R, C = prec.r, prec.const
        one, lo, c = C(1.0), C(-1.0), C(0.166667)
        p, f, q = self.p, self.f, self.q
        audio = (np.ascontiguousarray(prec.numpy(
            torch.broadcast_to(ins["Audio"], (v, m))).T)
            if "Audio" in ins else np.zeros((m, v), np.float32))
        kept = np.empty((m, 3, v), np.float32)
        u = np.empty(v, np.float32)
        bf = np.empty((4, v), np.float32)
        bf3, bf4, bf1, bf2 = bf
        add, mul, sub = np.add, np.multiply, np.subtract
        last, this = self.last, self.this
        for t in range(m):
            (_, ns, _, _, _, n3, n4, n1, n2, x, _, _, _, _, _) = this
            (_, _, _, _, b_f, _, _, _, _, _, b3, b4, b1, b2, b0) = last
            R(mul(q, b4, out=u))
            R(sub(audio[t], u, out=x))
            R(mul(b_f, f, out=bf))
            R(add(x, b0, out=u))
            R(mul(u, p, out=u))
            R(sub(u, bf1, out=n1))
            R(add(n1, b1, out=u))
            R(mul(u, p, out=u))
            R(sub(u, bf2, out=n2))
            R(add(n2, b2, out=u))
            R(mul(u, p, out=u))
            R(sub(u, bf3, out=n3))
            R(add(n3, b3, out=u))
            R(mul(u, p, out=u))
            R(sub(u, bf4, out=n4))
            R(mul(n4, n4, out=u))
            R(mul(u, n4, out=u))
            R(mul(u, c, out=u))
            R(sub(n4, u, out=n4))
            out = this[2]
            np.minimum(np.maximum(ns, lo, out=out), one, out=out)
            kept[t] = this[3]
            last, this = this, last
        self.last, self.this = last, this
        xs, b3s, b4s = kept[:, 0], kept[:, 1], kept[:, 2]
        hp = R(xs - b4s)
        bp = R(C(3.0) * R(b3s - b4s))
        lp, bp, hp = (prec.signal(a.T) for a in (b4s, bp, hp))
        return {0: lp, 1: bp, 2: hp}


MODULES = {"Oscillator": Oscillator, "Multiply": Multiply,
           "Mono Mixer": MonoMixer, "Moog Filter": MoogFilter}


def render(desc, params: dict, n: int, prec="f32", voices=None, *,
           lag: int = None) -> np.ndarray:
    """``v`` voices of ``desc`` for ``n`` samples (whole blocks) from the
    initial state, with ``params`` ``{module: {param: [v] array}}``: a
    ``[v, channels, n]`` float32 numpy array.  A wire read late carries
    ``lag`` samples of delay (a block, s-rack's; at least a block).
    ``voices`` is not needed: no module here is keyed by its row."""
    prec = PRECISIONS[prec] if isinstance(prec, str) else prec
    block = desc.block_size
    lag = block if lag is None else int(lag)
    if n % block or lag < block:
        raise ValueError(f"{desc.name}: n={n} and lag={lag} need whole "
                         f"blocks of {block}, and a lag of one at least")
    v = len(next(a for pd in params.values() for a in pd.values()))
    plan, _ = cycle_break(desc)
    at = {m: i for i, m in enumerate(plan)}
    units = {m["name"]: MODULES[m["type"]](
        prec, params.get(m["name"], {}), v, desc.sample_rate,
        **m.get("statics", {})) for m in desc.modules}
    reads = {}   # module -> [(input label, wire, read a block late)]
    for name in plan:
        labels = INPUTS[_type(desc, name)]
        reads[name] = [(labels[_index(labels, port)], _wire(desc, src, sp),
                        at[src] >= at[name])
                       for port, (src, sp) in desc.inputs_of(name).items()]
    # each late wire's last ``lag`` samples, its oldest first
    history = {w: torch.zeros((v, lag), dtype=prec.dtype)
               for w in late_wires(desc)}
    out = np.zeros((v, desc.channels, n), np.float32)
    for s in range(0, n, block):
        sig = {}
        for name in plan:
            ins = {label: (history[w][:, :block] if late else sig[w])
                   for label, w, late in reads[name]}
            if name == "output":
                for c, x in ins.items():
                    out[:, c, s:s + block] = prec.numpy(
                        torch.broadcast_to(x, (v, block)))
                continue
            outs = units[name](ins, block)
            labels = OUTPUTS[_type(desc, name)]
            for port, x in outs.items():
                sig[(name, _index(labels, port))] = x
        for w, h in history.items():
            history[w] = torch.cat(
                [h[:, block:], torch.broadcast_to(sig[w], (v, block))], 1)
    return out
