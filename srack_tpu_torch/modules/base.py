"""Module contract for the PyTorch port (counterpart: ``srack_tpu/modules/base.py``).

A module *type* is pure data plus pure functions on tensors:

* ``make``        -- construction: kwargs -> (statics, params)
* ``init_state``  -- the per-voice state dict, made on a given device
* ``step``        -- per-sample transition:
                     (cfg, statics, params, state, ins, x) -> (state, outs)
                     where ``x`` is this sample of the module's hoisted lane
                     (Noise draws, an Input driver) or None

Every function is elementwise over any leading voice axis, so one ``step``
serves a single voice (0-d tensors) and a batch (``[V]`` tensors) alike;
vector leaves (the Moog stage vector, the mixer gains) keep their own axis
last.  Unconnected inputs arrive as ``None`` and each ``step`` reproduces
the reference's fallback for them.

``cuda_fn`` names the module's device function in ``csrc/modules.cuh``:
the fused CUDA kernel (``ops/fused.py``) emits one call to it per module
per sample.  ``None`` means the type is not kernel-eligible and patches
holding it run on the scan engine only.

``cuda_adj`` names the adjoint of that device function in
``csrc/modules_adj.cuh``, which the backward kernel of the fused VJP (K10,
``ops/fused_vjp.py``) calls once per module per sample in reverse plan
order.  ``None`` means the type has no K10 path: a patch holding it
differentiates through the scan engine.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

from ..config import AudioConfig

CV_DTYPE = torch.float32

Params = dict
State = dict
Statics = Any  # hashable
Ins = Sequence[Optional[torch.Tensor]]
Outs = tuple


@dataclasses.dataclass(frozen=True)
class ModuleDef:
    """A module type: pure construction + state-transition functions."""

    type_name: str
    # (cfg, **kwargs) -> (statics, params)
    make: Callable[..., tuple]
    # (cfg, statics) -> int
    num_inputs: Callable[[AudioConfig, Statics], int]
    num_outputs: Callable[[AudioConfig, Statics], int]
    # (cfg, statics) -> tuple of Optional[str]
    input_labels: Callable[[AudioConfig, Statics], tuple]
    output_labels: Callable[[AudioConfig, Statics], tuple]
    # (cfg, statics, device=None) -> State, every leaf made on ``device``
    init_state: Callable[..., State]
    # (cfg, statics, params, state, ins, x) -> (state, outs)
    step: Callable[..., tuple]
    # Per-render derived params, computed once outside the sample loop and
    # merged into params: (cfg, statics, params, connected) -> dict
    derive: Optional[Callable[..., dict]] = None
    # Step variant for engines that are never differentiated: bit-identical
    # primal outputs and state, without gradient-only ops
    step_nograd: Optional[Callable[..., tuple]] = None
    # Name of the device function in csrc/modules.cuh (None: scan only)
    cuda_fn: Optional[str] = None
    # Name of its adjoint in csrc/modules_adj.cuh (None: no K10 path)
    cuda_adj: Optional[str] = None
    # Hoisted per-sample source, drawn once per render outside the sample
    # loop: (cfg, statics, params, generator, n) -> [..., n] lane, which
    # the step receives sample by sample as ``x``
    make_xs: Optional[Callable[..., torch.Tensor]] = None
    # Params read only on the host (to make lanes), never by a kernel
    host_params: frozenset = frozenset()
    # Whole-block form for the block engine, over ``[V, n]`` rows:
    # (cfg, statics, params, state, ins, x, n[, outs_used]) -> (state, outs)
    # with ins and outs ``[V, n]`` (an input may be None) and per-voice
    # params ``[V]`` (an automated one a ``[V, n]`` lane)
    block: Optional[Callable[..., tuple]] = None
    # Params whose per-sample automation the block engine can run without
    # putting the module into its serial stage: the module is stateless or
    # its ``block`` takes ``[V, n]`` lanes for them
    auto_block_params: frozenset = frozenset()
    # ``block`` takes ``outs_used`` (one bool per output port: does any
    # wire, probe or output channel read it?) and may skip dead outputs'
    # work, returning placeholders for them
    block_outs_hint: bool = False
    # ``step`` writes its state tensors in place (Freeverb's delay lines);
    # an engine clones such a module's state once per render
    step_in_place: bool = False

    def port_index(self, cfg: AudioConfig, statics: Statics, port, *, output: bool) -> int:
        """Resolve a port given by index or label to an index."""
        labels = (self.output_labels if output else self.input_labels)(cfg, statics)
        n = (self.num_outputs if output else self.num_inputs)(cfg, statics)
        if isinstance(port, str):
            matches = [i for i, l in enumerate(labels) if l == port]
            if not matches:
                raise KeyError(
                    f"{self.type_name} has no {'output' if output else 'input'} "
                    f"named {port!r}; labels are {labels}"
                )
            return matches[0]
        idx = int(port)
        if not 0 <= idx < n:
            raise IndexError(
                f"{self.type_name} {'output' if output else 'input'} index {idx} "
                f"out of range (0..{n - 1})"
            )
        return idx


def const_ports(n: int, labels: tuple) -> tuple:
    """Helpers for modules whose port count doesn't depend on cfg/statics."""
    if len(labels) != n:
        raise ValueError(f"{len(labels)} labels for {n} ports")
    return (lambda cfg, s: n), (lambda cfg, s: labels)


def cv(value, device=None) -> torch.Tensor:
    return torch.as_tensor(value, dtype=CV_DTYPE, device=device)


def in_or(x: Optional[torch.Tensor], fallback,
          like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference's unconnected-input fallback (``match buf { None => ... }``),
    on the device of ``like`` when given (ops such as ``logical_and`` do
    not mix a CPU scalar with CUDA tensors)."""
    if x is None:
        return cv(fallback, None if like is None else like.device)
    return x
