"""Native patch persistence (JSON) and state snapshots (counterpart:
``srack_tpu/io/patchfile.py``).

The reference's only persistence is the ``.srk`` MessagePack patch file
(see io/srk.py for that interop).  The native format here is versioned
JSON with the same information model -- modules (type, statics, params) +
connection quads (src_id, src_port, sink_id, sink_port) -- plus the audio
config, and a separate binary state snapshot (the scan-carry pytree) so
long renders can checkpoint and resume (SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..config import AudioConfig
from ..patch import Patch, ModuleInstance
from ..modules import CATALOG

FORMAT_VERSION = 1


def _tuplify(x):
    return [_tuplify(i) for i in x] if isinstance(x, (tuple, list)) else x


def _untuplify(x):
    return tuple(_untuplify(i) for i in x) if isinstance(x, list) else x


def _host(t) -> np.ndarray:
    """A leaf as a numpy array (a tensor on any device)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def save_patch(patch: Patch, path=None) -> str:
    """Serialize a patch (topology + params) to versioned JSON."""
    doc = {
        "format": "srack_tpu.patch",
        "version": FORMAT_VERSION,
        "config": dataclasses.asdict(patch.config),
        "modules": [
            {
                "id": inst.id,
                "type": inst.mdef.type_name,
                "name": inst.name,
                "statics": _tuplify(inst.statics),
                "params": {
                    k: {"dtype": str(_host(v).dtype),
                        "value": _host(v).tolist()}
                    for k, v in inst.params.items()
                },
            }
            for inst in patch
        ],
        "connections": [list(q) for q in patch.connections()],
        "output": patch.output.id if patch.output else None,
    }
    text = json.dumps(doc, indent=1)
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


def load_patch(source) -> Patch:
    """Load a patch saved by :func:`save_patch`.

    Version migrations hook in here (the reference's enum-variant
    migrations, synth.rs:326-348, are the model); only version 1 exists.
    """
    if isinstance(source, str) and source.lstrip().startswith("{"):
        doc = json.loads(source)
    else:
        with open(source) as f:
            doc = json.load(f)
    if doc.get("format") != "srack_tpu.patch":
        raise ValueError("not a srack_tpu patch file")
    if doc["version"] > FORMAT_VERSION:
        raise ValueError(f"patch file version {doc['version']} is newer "
                         f"than supported ({FORMAT_VERSION})")

    cfg = AudioConfig(**doc["config"])
    patch = Patch(cfg, auto_output=False)
    max_counter = 0
    for m in doc["modules"]:
        if m["type"] not in CATALOG:
            raise ValueError(
                f"patch file uses unknown module type {m['type']!r}; "
                "custom types must be registered "
                "(srack_tpu_torch.register_module) before loading")
        mdef = CATALOG[m["type"]]
        params = {
            k: torch.from_numpy(np.asarray(spec["value"],
                                           dtype=spec["dtype"]))
            for k, spec in m["params"].items()
        }
        statics = _untuplify(m["statics"])
        n_in = mdef.num_inputs(cfg, statics)
        inst = ModuleInstance(
            id=m["id"], mdef=mdef, statics=statics, params=params,
            inputs=[None] * n_in, name=m.get("name"))
        patch._modules[m["id"]] = inst
        if m["id"].startswith("m") and m["id"][1:].isdigit():
            max_counter = max(max_counter, int(m["id"][1:]) + 1)
        if m["type"] == "Output":
            patch.output = patch.handle(m["id"])
    patch._counter = max_counter
    for (src, sport, sink, sport2) in doc["connections"]:
        patch[sink].inputs[sport2] = (src, sport)
    return patch


# -- state snapshots ---------------------------------------------------------

def _flatten_paths(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = json.dumps(k) if not isinstance(k, str) else k
            out.update(_flatten_paths(v, f"{prefix}/{key}"))
    else:
        out[prefix] = _host(tree)
    return out


def save_state(path, state) -> None:
    """Checkpoint a render state tree (npz; leaves on any device, f64
    leaves kept f64).  Resuming a batch render
    from the last completed block's carry is the failure-recovery story
    (SURVEY.md §5): re-render only what was lost."""
    flat = _flatten_paths(state)
    np.savez_compressed(path, **flat)


def load_state(path, like) -> dict:
    """Load a snapshot into the structure of ``like`` (e.g.
    ``compiled.init_state()`` or a batched version of it): each leaf takes
    the dtype and device of ``like``'s leaf, so an exact patch's f64
    leaves (the Oscillator's phase, the Freeverb's core) come back f64."""
    data = np.load(path, allow_pickle=False)
    flat_like = _flatten_paths(like)
    missing = set(flat_like) - set(data.files)
    if missing:
        raise ValueError(f"snapshot missing state entries: {sorted(missing)}")

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                key = json.dumps(k) if not isinstance(k, str) else k
                out[k] = rebuild(v, f"{prefix}/{key}")
            return out
        leaf = torch.from_numpy(np.asarray(data[prefix]))
        want = torch.as_tensor(tree)
        if leaf.shape != want.shape:
            raise ValueError(
                f"snapshot entry {prefix} has shape {tuple(leaf.shape)}, "
                f"expected {tuple(want.shape)}")
        return leaf.to(device=want.device, dtype=want.dtype)

    return rebuild(like)
