"""A configuration file as a patch: its description, the port's Patch built
from it, and the traffic's per-voice params drawn from the seed.

The configuration file (``configs/<name>.json``) lists every module with
every param and static it is run with, and every connection, so the
benchmark's patch does not change when the program's presets do.  The
params drawn for the voices are plain numpy arrays keyed by module name;
the program gets them as torch leaves keyed by module id, the reference
as they are.

Its keys: ``name``; ``audio`` (the program's ``AudioConfig``); ``modules``
(each ``{"name", "type", "params", "statics"}``); ``connections`` (each
``[source, source port, sink, sink port]``, the Output's sink named
``"output"``); and ``reference``, the plain reference that checks it: the
name of a file ``reference/<reference>.py`` that exports ``render(desc,
params, n, prec, voices)``.  That returns the ``[v, channels, n]`` float32
numpy audio of ``v`` voices for ``n`` samples from the initial state, with
``params`` ``{module: {param: [v] array}}``, ``prec`` a name in
``reference.precision.PRECISIONS`` and ``voices`` the voices' rows in
their render (``check.Item.voices``) or None.  A configuration whose patch
the walk of ``reference/graph.py`` renders names ``"graph"``; one that
needs module types, a walk or a precision it lacks names a file of its
own.  Further keys (``source``, ``assumed``, ...) document the file.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


class PatchDesc:
    """A configuration file's patch: modules in order, wiring, audio."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.name = spec["name"]
        self.audio = dict(spec["audio"])
        self.modules = list(spec["modules"])
        self.connections = [tuple(c) for c in spec["connections"]]
        self.channels = int(self.audio["channels"])
        self.sample_rate = int(self.audio["sample_rate"])
        self.block_size = int(self.audio["block_size"])
        self.reference = spec.get("reference")
        if not (isinstance(self.reference, str)
                and _NAME.fullmatch(self.reference)
                and (ROOT / "reference" / f"{self.reference}.py").is_file()):
            raise ValueError(
                f"configuration {self.name!r}: its reference "
                f"{self.reference!r} names no file reference/<name>.py "
                f"under {ROOT.name}/")

    @classmethod
    def load(cls, name: str) -> "PatchDesc":
        return cls(load_json("configs", name))

    def inputs_of(self, name: str) -> dict:
        """``{sink port: (source module, source port)}`` of a module (the
        Output's sink is named ``"output"``)."""
        return {c[3]: (c[0], c[1]) for c in self.connections if c[2] == name}

    def build(self, stt):
        """The port's Patch, built module by module from the description.
        Returns ``(patch, ids)`` with ``ids`` module name -> module id."""
        cfg = stt.AudioConfig(**self.audio)
        patch = stt.Patch(cfg)
        ids = {"output": patch.output.id}
        for m in self.modules:
            kw = dict(m.get("params", {}))
            kw.update(m.get("statics", {}))
            ids[m["name"]] = patch.add(m["type"], name=m["name"], **kw).id
        for src, sp, sink, kp in self.connections:
            patch.connect(ids[src], sp, ids[sink], kp)
        base = patch.params()
        for m in self.modules:
            for k, v in m.get("params", {}).items():
                got = base[ids[m["name"]]][k].numpy()
                if not np.array_equal(got, np.asarray(v, dtype=got.dtype)):
                    raise ValueError(f"{m['name']}.{k}: the patch holds "
                                     f"{got}, the configuration {v}")
        return patch, ids

    def base_params(self) -> dict:
        """``{module: {param: scalar}}`` as the configuration states them,
        each at the type the program keeps it in (f32, or bool)."""
        out = {}
        for m in self.modules:
            out[m["name"]] = {
                k: (np.bool_(v) if isinstance(v, bool) else np.float32(v))
                for k, v in m.get("params", {}).items()}
        return out


def draw_farm_params(desc: PatchDesc, n_voices: int, seed: int) -> dict:
    """Per-voice params ``{module: {param: [n_voices] array}}``: random
    notes, cutoffs, resonances and envelope times over the patch.

    A copy of the program's ``presets.farm_params`` (the same numpy draws in
    the same order, rounded to the same float32 values): voice by voice,
    module by module in the patch's order, an Oscillator whose name lacks
    ``"clock"`` gets ``val + U(-1, 1)``, a Moog Filter ``freq ~ U(0.1,
    0.8)``, ``res ~ U(0, 0.9)``, an ADSR its four times and level.
    """
    rng = np.random.default_rng(seed)
    base = desc.base_params()
    cols = {m: {k: [] for k in pd} for m, pd in base.items()}
    f32 = np.float32
    for _ in range(n_voices):
        for m in desc.modules:
            name, t = m["name"], m["type"]
            pd = dict(base[name])
            if t == "Oscillator" and "clock" not in name:
                pd["val"] = f32(pd["val"]) + f32(rng.uniform(-1.0, 1.0))
            elif t == "Moog Filter":
                pd["freq"] = f32(rng.uniform(0.1, 0.8))
                pd["res"] = f32(rng.uniform(0.0, 0.9))
            elif t == "ADSR":
                pd["a_sec"] = f32(rng.uniform(0.001, 0.1))
                pd["d_sec"] = f32(rng.uniform(0.01, 0.3))
                pd["s_val"] = f32(rng.uniform(0.1, 0.9))
                pd["r_sec"] = f32(rng.uniform(0.01, 0.3))
            for k, v in pd.items():
                cols[name][k].append(v)
    return {m: {k: np.stack(vs).astype(np.asarray(base[m][k]).dtype)
                for k, vs in pd.items()}
            for m, pd in cols.items()}


PARAM_RULES = {"farm_params": draw_farm_params}


def voices_of(params: dict, idx) -> dict:
    """The params of the voices ``idx`` (a list of indices)."""
    return {m: {k: a[idx] for k, a in pd.items()} for m, pd in params.items()}


def program_params(params: dict, ids: dict, patch, device) -> dict:
    """The drawn params as the program takes them: torch leaves keyed by
    module id, on ``device``; modules without params get the patch's own
    (empty) dicts."""
    import torch
    out = {mid: {} for mid in patch.params()}
    for name, pd in params.items():
        out[ids[name]] = {k: torch.from_numpy(np.ascontiguousarray(a)).to(
            device) for k, a in pd.items()}
    return out


def sub_seed(seed: int, *path: int) -> int:
    """A seed for one part of a run, drawn from the run's seed: the same
    ``seed`` and ``path`` always give the same value."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *path])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))
