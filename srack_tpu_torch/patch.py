"""Patch IR and builder API (counterpart: ``srack_tpu/patch.py``).

A :class:`Patch` is plain data -- ordered module instances (type, statics,
params) plus connection quads -- which the compiler lowers to one program.
Builder methods mirror the reference workspace API: ``add``, ``connect``
(an already-connected input is replaced), ``disconnect``,
``disconnect_all`` and ``delete_module``.  Exactly one Output module is
auto-created per patch.

Module ids are deterministic (``m{n}``), so a patch built the same way in
this package and in ``srack_tpu`` gets the same ids, and params and state
carry across by id (``interop.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from .config import AudioConfig
from .modules import CATALOG, NOT_PORTED, ModuleDef


@dataclasses.dataclass
class ModuleInstance:
    id: str
    mdef: ModuleDef
    statics: Any
    params: dict
    # one slot per input port: None or (src_id, src_port)
    inputs: list
    name: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ModuleHandle:
    """Lightweight reference to a module in a patch."""
    id: str
    type_name: str

    def __str__(self) -> str:
        return self.id


ModuleRef = Union[ModuleHandle, str]


def _mid(ref: ModuleRef) -> str:
    return ref.id if isinstance(ref, ModuleHandle) else ref


class Patch:
    """A modular-synth patch: module instances + connections."""

    def __init__(self, config: AudioConfig | None = None, *, auto_output: bool = True):
        self.config = config or AudioConfig()
        self._modules: dict[str, ModuleInstance] = {}
        self._counter = 0
        self.output: Optional[ModuleHandle] = None
        if auto_output:
            self.output = self.add("Output")

    # -- construction -------------------------------------------------------

    def add(self, type_name: str, *, name: Optional[str] = None,
            **kwargs) -> ModuleHandle:
        if type_name in NOT_PORTED and type_name not in CATALOG:
            raise KeyError(
                f"module type {type_name!r} is not ported to srack_tpu_torch "
                "yet; ROADMAP.md lists the slice that brings it")
        if type_name not in CATALOG:
            raise KeyError(
                f"unknown module type {type_name!r}; catalog: {sorted(CATALOG)}")
        if type_name == "Output" and self.output is not None:
            raise ValueError("patch already has an Output module")
        mdef = CATALOG[type_name]
        statics, params = mdef.make(self.config, **kwargs)
        mid = f"m{self._counter}"
        self._counter += 1
        n_in = mdef.num_inputs(self.config, statics)
        inst = ModuleInstance(
            id=mid, mdef=mdef, statics=statics, params=params,
            inputs=[None] * n_in, name=name)
        self._modules[mid] = inst
        handle = ModuleHandle(mid, type_name)
        if type_name == "Output":
            self.output = handle
        return handle

    add_module = add

    def connect(self, src: ModuleRef, src_port, sink: ModuleRef, sink_port) -> None:
        src_i = self[src]
        sink_i = self[sink]
        spi = src_i.mdef.port_index(self.config, src_i.statics, src_port, output=True)
        sip = sink_i.mdef.port_index(self.config, sink_i.statics, sink_port, output=False)
        sink_i.inputs[sip] = (src_i.id, spi)

    def disconnect(self, sink: ModuleRef, sink_port) -> None:
        sink_i = self[sink]
        sip = sink_i.mdef.port_index(self.config, sink_i.statics, sink_port, output=False)
        sink_i.inputs[sip] = None

    def disconnect_all(self, module: ModuleRef) -> None:
        self[module].inputs = [None] * len(self[module].inputs)

    def disconnect_output(self, src: ModuleRef, src_port) -> None:
        """Disconnect every sink fed by ``src``'s output port.

        The reference's right-click-an-output gesture (ui.rs:552-567):
        walks all modules and clears any input wired to (src, port).
        """
        src_i = self[src]
        spi = src_i.mdef.port_index(self.config, src_i.statics, src_port,
                                    output=True)
        for inst in self._modules.values():
            inst.inputs = [
                None if c == (src_i.id, spi) else c for c in inst.inputs
            ]

    def delete_module(self, module: ModuleRef) -> None:
        mid = _mid(module)
        if self.output is not None and self.output.id == mid:
            raise ValueError("the Output module cannot be deleted")
        del self._modules[mid]
        for inst in self._modules.values():
            inst.inputs = [
                None if (c is not None and c[0] == mid) else c
                for c in inst.inputs
            ]

    def set_audio_config(self, config: AudioConfig) -> None:
        """Change the audio configuration.

        Mirrors the reference's ``set_audio_config`` push into every module
        (synth.rs:261): most modules only resize transient buffers (a no-op
        here -- buffers are SSA values), but the Output module recreates its
        per-channel inputs *disconnected* (output.rs:39-44), which this
        reproduces.  Renders after the change use the new sample rate /
        block size; compiled programs are cached per config so this never
        corrupts an existing executable.
        """
        self.config = config
        for inst in self._modules.values():
            if inst.mdef.type_name == "Output":
                inst.statics = ("output", config.channels)
                inst.inputs = [None] * config.channels

    # -- access -------------------------------------------------------------

    def __getitem__(self, ref: ModuleRef) -> ModuleInstance:
        return self._modules[_mid(ref)]

    def __contains__(self, ref: ModuleRef) -> bool:
        return _mid(ref) in self._modules

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)

    @property
    def module_ids(self) -> list[str]:
        return list(self._modules)

    def handle(self, mid: str) -> ModuleHandle:
        return ModuleHandle(mid, self._modules[mid].mdef.type_name)

    def connections(self) -> list[tuple]:
        """All edges as (src_id, src_port, sink_id, sink_port) quads,
        the reference FileFormat's connection schema (ui.rs:578-586)."""
        quads = []
        for inst in self._modules.values():
            for sink_port, conn in enumerate(inst.inputs):
                if conn is not None:
                    quads.append((conn[0], conn[1], inst.id, sink_port))
        return quads

    # -- params -------------------------------------------------------------

    def set_params(self, module: ModuleRef, **kwargs) -> None:
        """Update slider-style parameters; never triggers a recompile."""
        inst = self[module]
        for k, v in kwargs.items():
            if k not in inst.params:
                raise KeyError(
                    f"{inst.mdef.type_name} has no param {k!r}; "
                    f"params: {sorted(inst.params)}")
            leaf = inst.params[k]
            inst.params[k] = torch.as_tensor(v, dtype=leaf.dtype).reshape(leaf.shape)

    def params(self) -> dict:
        """The full params pytree keyed by module id."""
        return {mid: dict(inst.params) for mid, inst in self._modules.items()}

    # -- identity -----------------------------------------------------------

    def topology_key(self) -> tuple:
        """Hashable key identifying the *compiled program*: module types,
        statics and wiring (but not params).  Patches with equal keys share
        a compiled executable (SURVEY.md §7 hard part e).

        The key carries ``id(mdef)`` alongside the type name so a custom
        type re-registered via ``modules.register(..., replace=True)`` (or
        unregister + register) compiles fresh instead of hitting a cache
        entry built from the old implementation.  ``id`` is safe here: any
        cached CompiledPatch keeps its instances' ModuleDef objects alive,
        so a *different* def can never be allocated at a cached def's id.
        """
        mods = tuple(
            (mid, inst.mdef.type_name, id(inst.mdef), inst.statics,
             tuple(inst.inputs[i] for i in range(len(inst.inputs))))
            for mid, inst in self._modules.items()
        )
        return (self.config, mods)
