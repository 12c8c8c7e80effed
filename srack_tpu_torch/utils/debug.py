"""Numerical-health guards (counterpart: ``srack_tpu/utils/debug.py``).

The failure modes of a render are NaN/Inf blowups and silent rebuilds.

* :func:`check_finite` -- a render that raises on NaN/Inf, naming the
  offending module wires (a probe on every port);
* :func:`quarantine_batch` -- per-voice isolation for render farms: a NaN
  voice is zeroed and flagged instead of poisoning the mix bus;
* :func:`recompile_guard` -- a context manager that raises if a new plan
  is compiled (a miss of ``compile_patch``'s cache), nvcc runs or a kernel
  library is loaded inside it.
"""

from __future__ import annotations

import contextlib

import torch


class NonFiniteAudio(RuntimeError):
    pass


def check_finite(patch, n_samples: int, **kwargs):
    """Render with a probe on every output port and raise naming every
    module wire that goes non-finite.  ``kwargs`` go to
    ``CompiledPatch.render`` (``device="cpu"`` on a machine without a
    card; probes run on the scan and block engines)."""
    from ..compiler import compile_patch

    probes = []
    for inst in patch:
        n_out = inst.mdef.num_outputs(patch.config, inst.statics)
        probes.extend((inst.id, p) for p in range(n_out))
    compiled = compile_patch(patch, probes=probes)
    audio, probe_vals, state = compiled.render(n_samples, **kwargs)
    bad = []
    for key, arr in probe_vals.items():
        finite = torch.isfinite(arr).reshape(-1)
        if not bool(finite.all()):
            bad.append((key, int(torch.argmin(finite.to(torch.uint8)))))
    if bad:
        desc = ", ".join(f"{k} (first at flat index {i})" for k, i in bad)
        raise NonFiniteAudio(f"non-finite samples on wires: {desc}")
    if not bool(torch.isfinite(audio).all()):
        raise NonFiniteAudio("non-finite samples in output")
    return audio, probe_vals, state


def quarantine_batch(audio: torch.Tensor):
    """Zero the non-finite voices of a ``[V, C, n]`` batch.  Returns
    ``(clean_audio, ok_mask[V])``: one diverging voice must not kill a
    dataset job."""
    finite = torch.isfinite(audio).all(dim=2).all(dim=1)
    clean = torch.where(finite[:, None, None], torch.nan_to_num(audio),
                        torch.zeros((), dtype=audio.dtype,
                                    device=audio.device))
    return clean, finite


def _events() -> dict:
    from ..compiler import _COMPILE_CACHE
    from ..ops.cuda_lib import EVENTS
    return {"compiled plan": _COMPILE_CACHE.misses, **EVENTS}


@contextlib.contextmanager
def recompile_guard():
    """Raise ``AssertionError`` if anything is compiled, built or loaded
    inside the block: a new compiled plan, an nvcc build, the load of a
    kernel library.  Param edits and repeated renders of one topology
    reuse the compiled plan and its built kernels."""
    before = _events()
    yield
    new = {k: v - before[k] for k, v in _events().items() if v > before[k]}
    if new:
        raise AssertionError(
            f"unexpected recompilation inside recompile_guard: {new}")
