"""Render entry points (counterpart: ``srack_tpu/engine.py``).

* :func:`render` -- offline render of a patch.
* :func:`render_batch` -- V voices of one topology in parallel, from params
  stacked along a leading voice axis; on a CUDA device this runs the fused
  kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .compiler import compile_patch, tree_map
from .patch import Patch


def render(patch: Patch, n_samples: int, *, params: Optional[dict] = None,
           state: Optional[dict] = None, engine: str = "auto", device=None):
    """Render ``n_samples`` of a patch offline.

    Returns ``(audio, probes, final_state)``; ``audio`` is ``[channels, n]``
    float32 and ``probes`` is ``{}``.
    """
    return compile_patch(patch).render(n_samples, params=params, state=state,
                                       engine=engine, device=device)


def render_batch(patch: Patch, n_samples: int, *, params: dict,
                 state: Optional[dict] = None, engine: str = "auto",
                 device=None):
    """Render a batch of voices of one topology in parallel.

    ``params`` carries a leading voice axis on every leaf (see
    :func:`stack_params` / :func:`replicate_params`).  Returns audio of
    shape ``[voices, channels, n]``.
    """
    return compile_patch(patch).render(n_samples, params=params, state=state,
                                       batched=True, engine=engine,
                                       device=device)


def _stack(trees: Sequence):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack([torch.as_tensor(t) for t in trees])


def stack_params(param_list: Sequence[dict]) -> dict:
    """Stack per-voice param dicts (same topology) along a leading axis."""
    return _stack(list(param_list))


def replicate_params(params: dict, n: int) -> dict:
    """Broadcast one param dict to ``n`` identical voices."""
    return tree_map(lambda a: a.expand((n,) + a.shape).contiguous(), params)
