"""Carry params and state between the JAX package and this one.

Both packages key params as ``{mid: {name: leaf}}`` and state as
``{"states": {mid: {name: leaf}}, "fb": {(src, port): leaf}}``, with the
same module ids for a patch built the same way.  These helpers move such
trees across as numpy arrays: ``np.asarray`` of a JAX tree goes in, and
:func:`to_numpy` of a torch tree comes out.  Bool leaves stay bool (a
Sample's ``playing`` and ``gate_last``), int32 stays int32 (its
``length``), f64 stays f64 (exact precision's Oscillator phase and
Freeverb core), and a Sample's ``samples`` table is ``[K]`` (batched: ``[V,
K]``) in both.  In buffer-feedback mode an ``fb`` leaf is ``[block]``
(batched: ``[V, block]``) in both packages.  :func:`train_from_numpy`
carries a JAX ``SoundMatcher`` state's trainable and frozen params across.
"""

from __future__ import annotations

import numpy as np
import torch

from .compiler import tree_map


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: dict, device="cpu") -> dict:
    """``{mid: {name: array}}`` -> the same tree of tensors on ``device``."""
    return tree_map(lambda a: _tensor(a, device), tree)


def state_from_numpy(tree: dict, device="cpu") -> dict:
    """A render state ``{"states": ..., "fb": {(src, port): array}}`` of
    arrays -> the same tree of tensors on ``device``."""
    return {"states": tree_map(lambda a: _tensor(a, device), tree["states"]),
            "fb": {tuple(k): _tensor(a, device)
                   for k, a in tree["fb"].items()}}


def drivers_from_numpy(drivers: dict, device="cpu") -> dict:
    """Driver or automation lanes (``[n]`` shared or ``[V, n]`` per voice)
    keyed by module, module id or ``(module, param)`` -> the same keys with
    float32 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(
        device) for k, a in drivers.items()}


def train_from_numpy(train: dict, frozen: dict, device="cpu"):
    """A JAX ``SoundMatcher`` state's ``train`` and ``frozen`` trees (numpy
    arrays) -> ``(train, frozen)`` for the port's trainer: the trainable
    leaves as leaf tensors that require gradients, the frozen ones as
    plain tensors, on ``device``.  The optimizer state is not carried:
    the port's optimizer starts from the same zero moments as
    ``optax.adam``'s."""
    train = tree_map(lambda a: _tensor(a, device).requires_grad_(True), train)
    return train, params_from_numpy(frozen, device)


def to_numpy(tree):
    """A tree of tensors (params, state or audio) -> numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
