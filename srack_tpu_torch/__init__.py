"""srack_tpu_torch -- the PyTorch and CUDA port of srack_tpu.

Patch graphs of oscillators, noise, sequencers, filters, envelopes, mixers,
math, sample players, reverb and external inputs compile into one
per-sample step.  On the CPU the scan engine runs that step in a loop;
renders on a CUDA device run a hand-written CUDA kernel generated from
the plan, a pipeline of stage warps per 32 voices (in buffer-feedback
mode, its delayed-feedback twin).  A patch that kernel cannot take (one with a
Freeverb or a Sample) runs on the block engine (``engine="block"``):
whole-block module forms around a per-sample serial stage, on the stage,
row-scan, row-gather, Sample-player, Freeverb and ring-alignment kernels.
Every
render is differentiable: ``CompiledPatch.grad_render_fn`` runs the fused
VJP kernel (a CUDA forward and a CUDA backward) on the card for the patches
the fused kernel takes, and ``utils.train`` fits params to target audio.
``parallel`` splits a farm's voices, or a training step's, over a mesh of
cards (or of processes, on ``torch.distributed``), with a mix bus; ``io``
reads and writes WAV, MIDI, the reference's ``.srk`` patch files, JSON
patches and state snapshots; ``play`` streams a patch in real time with
underrun accounting; ``python -m srack_tpu_torch`` is the command line
(``render``, ``midi``, ``info``, ``modules``, ``presets``).
Entry points render on the card unless given ``device="cpu"``.  ``srack_tpu``
(JAX) is the reference this package is tested against; this package
imports neither it nor jax.

Quick start::

    import srack_tpu_torch as stt

    cfg = stt.AudioConfig(sample_rate=48000, channels=1)
    patch = stt.presets.subtractive_voice(cfg)
    params = stt.presets.farm_params(patch, 1024)
    audio, _, state = stt.render_batch(patch, 48000, params=params)
"""

from .config import AudioConfig
from .patch import Patch, ModuleHandle
from .planner import plan_execution
from .compiler import CompiledPatch, compile_patch, migrate_state
from .engine import (render, render_batch, render_long, render_many,
                     render_stream, stack_params, replicate_params)
from .modules import CATALOG, ModuleDef
from .modules import register as register_module
from .modules import unregister as unregister_module
from .rt import PlayStats, paced_consume, play
from . import block_engine, interop, io, parallel, presets, utils

__version__ = "0.5.0"

__all__ = [
    "AudioConfig",
    "Patch",
    "ModuleHandle",
    "plan_execution",
    "CompiledPatch",
    "compile_patch",
    "migrate_state",
    "render",
    "render_batch",
    "render_long",
    "render_many",
    "render_stream",
    "stack_params",
    "replicate_params",
    "CATALOG",
    "ModuleDef",
    "register_module",
    "unregister_module",
    "PlayStats",
    "paced_consume",
    "play",
    "block_engine",
    "interop",
    "io",
    "parallel",
    "presets",
    "utils",
]
