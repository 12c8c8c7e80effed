"""Differentiable sound matching (counterpart: ``srack_tpu/utils/train.py``).

Fits a patch's params to target audio by gradient descent through the
render.  :func:`batched_train_step` is the training step: params shared by
every voice of a batch, one target per voice, the per-voice losses
mean-reduced.  With ``fast=True`` it differentiates through
``CompiledPatch.grad_render_fn``, which on the card runs kernel K10 (a CUDA
forward and a CUDA backward) for the patches it takes.

Optimizers are ``torch.optim`` ones, given as a factory of the trainable
leaves (``functools.partial(torch.optim.Adam, lr=1e-3)``); Adam there is
``optax.adam``'s rule (bias-corrected moments, ``eps`` = 1e-8 outside the
square root).  With ``mesh=`` the step splits the voices over a mesh's
slots and sums the gradients (``parallel``).  The entry points run on the
CUDA card unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from ..compiler import (CompiledPatch, compile_patch, resolve_device,
                        tree_leaves, tree_map)
from ..ops.basic import fold_in
from ..parallel.distributed import all_reduce_sum
from ..parallel.mesh import shard_bounds
from ..patch import Patch
from .losses import multiscale_spectral_loss, waveform_l2


def _split(params: dict, trainable=None):
    """``(train, frozen)``: the float leaves that ``trainable(mid, name)``
    accepts (every float leaf by default), and the rest.  Every module id
    is in both trees."""
    train = {mid: {} for mid in params}
    frozen = {mid: {} for mid in params}
    for mid, pd in params.items():
        for name, leaf in pd.items():
            ok = leaf.is_floating_point() and (
                trainable is None or trainable(mid, name))
            (train if ok else frozen)[mid][name] = leaf
    return train, frozen


def _merge(train: dict, frozen: dict) -> dict:
    out = {mid: {} for mid in frozen}
    for src in (frozen, train):
        for mid, pd in src.items():
            out.setdefault(mid, {}).update(pd)
    return out


@dataclasses.dataclass
class SoundMatcher:
    """Optimises (a subset of) a patch's params against target audio, one
    unbatched render per step through the scan engine.

    ``optimizer``: a factory ``leaves -> torch.optim.Optimizer`` (Adam with
    lr 1e-2 by default).  ``trainable``: a predicate ``(module_id,
    param_name) -> bool`` choosing the leaves that get gradients (every
    float param by default).  ``device``: the CUDA card by default."""

    patch: Patch
    n_samples: int
    loss_fn: Callable = multiscale_spectral_loss
    optimizer: Optional[Callable] = None
    trainable: Optional[Callable[[str, str], bool]] = None
    device: Any = None

    def __post_init__(self):
        self.compiled: CompiledPatch = compile_patch(self.patch)
        self.device = resolve_device(self.device)
        if self.optimizer is None:
            self.optimizer = functools.partial(torch.optim.Adam, lr=1e-2)

    def init(self, params: Optional[dict] = None) -> dict:
        """The train state ``{"train", "frozen", "opt"}`` from ``params``
        (the patch's defaults if None), on the matcher's device."""
        if params is None:
            params = self.compiled.default_params
        params = tree_map(lambda a: torch.as_tensor(a).to(self.device),
                          params)
        train, frozen = _split(params, self.trainable)
        train = tree_map(lambda a: a.detach().clone().requires_grad_(True),
                         train)
        return {"train": train, "frozen": frozen,
                "opt": self.optimizer(tree_leaves(train))}

    def step(self, train_state: dict, target, key: Optional[int] = None,
             drivers: Optional[dict] = None):
        """One optimisation step, in place.  Returns ``(train_state,
        loss)``."""
        opt = train_state["opt"]
        opt.zero_grad(set_to_none=True)
        audio, _, _ = self.compiled.render(
            self.n_samples, params=self.params(train_state), key=key,
            drivers=drivers, engine="scan", device=self.device)
        loss = self.loss_fn(audio, torch.as_tensor(target).to(self.device))
        loss.backward()
        opt.step()
        return train_state, loss.detach()

    def params(self, train_state: dict) -> dict:
        return _merge(train_state["train"], train_state["frozen"])


def batched_train_step(compiled: CompiledPatch, optimizer: Callable,
                       n_samples: int, loss_fn: Callable = waveform_l2,
                       fast: bool = False, mesh=None, packed: bool = False,
                       device=None):
    """A *batched* training step: ``step(train, frozen, opt, targets
    [V, C, n], key) -> (train, opt, loss)``.

    The trainable params ``train`` (leaf tensors on ``device``, as
    ``SoundMatcher.init`` makes them) are shared by every voice, broadcast
    over V with ``expand``; ``frozen`` holds the other params.  ``opt`` is
    the optimizer ``optimizer(leaves of train)`` makes, or None to make it
    now.  ``key`` (an int) seeds the Noise lanes.
    The per-voice losses ``loss_fn(audio[v], targets[v])`` are
    mean-reduced (summed, then divided by V).  ``fast=True`` renders through
    ``compiled.grad_render_fn`` (kernel K10 on the card for the patches it
    takes); ``fast=False`` through the scan engine under autograd.

    ``mesh`` (``parallel.Mesh``): data parallelism over its slots.  Each
    slot of this process renders its contiguous block of voices on its
    device (voice ``j`` of a block drawing the Noise row of its index in
    the whole batch) and takes the sum of its voices' losses over the
    whole V; one backward sums the shared params' gradients from every
    slot into the params' device, and on a mesh built over the process
    group one ``all_reduce`` of the flattened gradients sums them across
    ranks before the one optimizer step.  ``packed=True`` is the TPU
    kernels' tiled layout, which the port has not: it raises
    ``NotImplementedError``."""
    if packed:
        raise NotImplementedError(
            "packed=True is the TPU kernels' [n, C, tiles, 8, 128] layout; "
            "the port renders [V, C, n] and has no packed form")
    device = resolve_device(device)
    n = int(n_samples)
    grad_render = compiled.grad_render_fn(n, batched=True) if fast else None

    def render(params: dict, v: int, key: int, dev, voice0: int):
        params_b = tree_map(lambda a: a.to(dev).expand((v,) + a.shape),
                            params)
        state = tree_map(lambda a: a.expand((v,) + a.shape),
                         compiled.init_state(dev))
        if fast:
            audio, _, _ = grad_render(params_b, state, key, {}, voice0)
        else:
            xs = compiled._make_xs(params_b, key, n, {}, voice0)
            audio, _, _ = compiled._run(params_b, state, xs, n, True)
        return audio

    def step(train: dict, frozen: dict, opt, targets, key: int = 0):
        targets = torch.as_tensor(targets).to(device)
        if opt is None:
            opt = optimizer(tree_leaves(train))
        opt.zero_grad(set_to_none=True)
        frozen = tree_map(lambda a: torch.as_tensor(a).to(device), frozen)
        params = _merge(train, frozen)
        v = targets.shape[0]
        # (device, first voice, end) of each block this process renders
        if mesh is None:
            blocks = [(device, 0, v)]
        else:
            bounds = shard_bounds(v, mesh)
            blocks = [(mesh.devices.flat[s],) + bounds[s]
                      for s in mesh.local_slots()]
        loss = None
        for dev, start, stop in blocks:
            audio = render(params, stop - start, int(key), dev, start)
            part = torch.func.vmap(loss_fn)(
                audio, targets[start:stop].to(dev)).sum().to(device)
            loss = part if loss is None else loss + part
        loss = loss / v
        loss.backward()
        loss = loss.detach()
        if mesh is not None and mesh.ranks is not None:
            _all_reduce_grads(tree_leaves(train))
            loss = all_reduce_sum(loss.clone())
        opt.step()
        return train, opt, loss

    return step


def _all_reduce_grads(leaves: list) -> None:
    """Sum the leaves' gradients over the process group: one
    ``all_reduce`` of them flattened into one vector."""
    with_grad = [t for t in leaves if t.grad is not None]
    if not with_grad:
        return
    flat = torch.cat([t.grad.reshape(-1) for t in with_grad])
    all_reduce_sum(flat)
    at = 0
    for t in with_grad:
        t.grad.copy_(flat[at:at + t.numel()].view_as(t.grad))
        at += t.numel()


def multi_train_step(compiled: CompiledPatch, optimizer: Callable,
                     n_samples: int, n_steps: int,
                     loss_fn: Callable = waveform_l2, fast: bool = False,
                     mesh=None, packed: bool = False, device=None):
    """``n_steps`` steps of :func:`batched_train_step` against fixed
    targets: ``run(train, frozen, opt, targets, key) -> (train, opt,
    losses [n_steps])``.  A Python loop; step ``i`` draws its noise from
    ``fold_in(key, i)``, so each step sees fresh Noise lanes."""
    one = batched_train_step(compiled, optimizer, n_samples,
                             loss_fn=loss_fn, fast=fast, mesh=mesh,
                             packed=packed, device=device)

    def run(train: dict, frozen: dict, opt, targets, key: int = 0):
        losses = []
        for i in range(int(n_steps)):
            train, opt, loss = one(train, frozen, opt, targets,
                                   fold_in(key, i))
            losses.append(loss)
        return train, opt, torch.stack(losses)

    return run

