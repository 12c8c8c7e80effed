#!/usr/bin/env python3
"""Smoke run of srack_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own lines with its seconds:

1. the device: a CUDA card is required; prints its name and power limit
   (nvidia-smi) and turns TF32 off;
2. the build: builds, all at once (one nvcc per source, started together),
   the fused voice kernel K1 (nvcc, sm_90a) for subtractive_voice,
   sine_patch, feedback_patch, kernel_check_patch, sequencer_patch and
   lane_check_patch (with its Noise, Input-driver and automation lanes),
   and the buffer-feedback kernel K2 for feedback_patch with
   buffer_feedback=True, all at 48 kHz, from the sources in this checkout;
   prints each build's ptxas registers and spills;
3. kernel vs plain version on the card, 1,024 voices of farm_params:
   each K1 patch at n = 1024 and n = 1023 (lane_check_patch with Noise
   lanes from the generator, random Input-driver lanes and one automation
   lane) and K2 on feedback_patch, block 1,024, at n = 2048 and n = 3072,
   through the kernel and through the scan engine (the kernels' plain
   version); audio within 1e-5, int32 and bool state bit-exact, float
   state (K2's final fb ring included) within 1e-5; K1, K2 (block 66) and
   K10's forward at 1,000 voices (a ragged last CTA for the store warp)
   and n with and without a part last chunk, audio bit for bit (K1's
   final float state too, K2's within 1e-5);
4. the main path at full size: compile_patch(subtractive_voice(cfg))
   .render(480000, params=farm_params(patch, 1024), batched=True,
   device="cuda") with engine="auto" -- 1,024 voices x 10 s at 48 kHz;
   requires K1's launch count to move, finite audio, peak <= 1.002, and
   the first 1,024 samples equal to phase 3's plain render; times one
   render with CUDA events after a warm-up;
5. the farm: 16,384 voices x 192,000 samples (4 s) through the same path;
6. the plain versions' times at phase 3's shapes;
7. the sequencer at full width: stt.render_batch(sequencer_patch(cfg),
   480000, params=farm_params(patch, 1024)) on the default device --
   requires K1's launch count to move, finite audio, peak <= 1.002; timed;
8. buffer feedback at full width: stt.render_batch(feedback_patch(cfg with
   buffer_feedback=True, block 1,024), 491520, params=farm_params(patch,
   1024)) -- requires K2's launch count to move, finite audio, peak <=
   1.002, and a ring of a block a feedback key (``ring_words``); timed;
9. the block engine's main path: stt.render_batch(reverb_patch(cfg),
   480000, params=farm_params(patch, 1024)), stereo, on the default
   device -- requires the serial-stage kernel K3, the Freeverb kernel K8
   and the ring-alignment kernel K9 to launch, finite audio, peak <=
   1.002; timed (the median of 5 renders: the block engine's host-side
   work swings between renders), and each kernel timed alone
   at its shapes there; its
   warm-up render holds K8 against its plain version on the very inputs
   the render gives it, [1,024, 480,000];
10. block_check_patch (mono, automated room_size and wet) the same way,
   which also requires the row-scan kernel K4 (the VCO's whole-block
   phase) to launch; its warm-up render holds K8 and each K4 call (int32
   sum, fills, f32 sum over [1,024, 480,000]) against their plain
   versions.
11. drums: stt.render_batch(drum_machine(cfg), 480000,
   params=farm_params(patch, 1024)), mono, on the default device --
   requires K3 and the Sample-player kernel K7 to launch (and, from
   slice 11, the Noise-lane kernel), finite audio, peak <= 1.002; timed,
   each kernel timed alone at its shapes there;
12. sampler: sampler_kit the same way (three 48,000-frame Samples: K3
   once, K7 three times); prints the device memory peak;
13. kit check: kit_check_patch the same way, which also requires K4 and
   the row-gather kernel K5 (the sequencers' whole-block forms) to
   launch.  The warm-up render of each of 11-13 holds every K7 call
   against its unfused form (K4's scans and the row gather's long entry
   K6) bit for bit and every K5 call against torch.gather, at the shapes
   the main path gives them.
14. train: bench.py's training config (bench.py:205-262) through
   ``srack_tpu_torch.utils.train`` on the default device: subtractive_voice
   at 48 kHz, 1,024 voices x 48,000 samples, Adam (lr 1e-3), waveform_l2
   against silent targets, ``batched_train_step(fast=True)``: one warm-up
   step, whose K10 forward audio must equal K1's render of the same params
   bit for bit, then 3 timed steps, each required to launch exactly one
   K10 forward and one K10 backward and no other kernel (the scan engine
   is fenced off), then a 32-step ``multi_train_step``; the last loss must
   be below the first.  Prints ms/step, samples/s through forward and
   backward, and K10's two kernels timed alone beside their bounds.

Phase 2 also builds K3 for the stages of reverb_patch and
block_check_patch, K4, K8 and K9; phase 3 holds each against its plain
version at 1,024 voices: K3 (the stage's torch loop) at n = 1024 and 1023,
K4's kinds on [1,024, 48,000] random rows, K9 on every line length of a
48 kHz Freeverb (rings to the Freeverb kernel's lines, back, and rings to
rings), K8 (through its wrapper) at n = 2048 and 2047 and with automated
room_size and wet, and the whole block engine against the scan engine on
both patches at n = 1024 (audio within 5e-6, two halves with the state
carried equal to one render).  For slice 3b phase 2 also builds K3 for
the stages of drum_machine, sampler_kit and kit_check_patch (at 48 kHz,
and at 4,800 Hz for phase 3, with feedback_patch and drum_machine in
buffer mode), the row gather (K5, and K6 as its second entry) and K7;
phase 3 holds K5 and K6 against the plain gather on [1,024, 48,000]
(exact), K7 against its unfused form (bit-exact) and its plain version
at n = 2048 and 2047 for tables of 400, 4,000 and 48,000 frames, and the
block engine against the scan engine at 4,800 Hz, n = 2,048, on the three
kit patches and, in buffer mode (block 256), on feedback_patch and
drum_machine.  Phase 6 times the new kernels, their plain
versions and, for K4 and K9, the one PyTorch call that computes the same
function; K8 is timed through its wrapper, as its plain version does the
same work, and as its launch alone.

For slice 5 phase 2 builds the fused VJP K10, its forward
(``fused_vjp_fwd``) and its backward (``fused_vjp_bwd``), for five patches
at 4,800 Hz (the subtractive voice with a fast gate clock, the JAX tests'
gradient patch, feedback_patch, lane_check_patch with its lanes,
kernel_check_patch) and for phase 14's subtractive voice at 48 kHz;
phase 3 holds K10 against its plain version, autograd through the scan
engine, at 1,024 voices and n = 512 on the five patches and on phase 14's
build (its gate clock started at random phases so that envelopes run):
the audio bit for bit, every float param's and initial float state's
cotangent within ``1e-8 + 1e-4 * max|ref|``; phase 6 times both kernels
and both halves of the plain version on phase 14's build.  The backward
at phase 14's full length is not held to the plain version: autograd
through the scan engine takes ~9 ms per sample at 1,024 voices, over
seven minutes for 48,000 samples.

For slice 6 K1 and K3 run their plan as a pipeline of stage warps
(``srack_tpu_torch/ops/partition.py``, ``ops/fused.py``): phase 2 logs
each build's stages (G), chunk (T) and shared memory, and also builds the
one-thread twin (G = 1) of the headline's and the sequencer's K1 and of
each block cell's K3, and the headline's K1 and the kit check's K3 at
chunks of 16, 64 and 128; phase 3 requires the split K1 (6 patches) and
K3 (5 stages) to equal their plain versions bit for bit;

15. a/b: each split kernel against its one-thread twin at full width in
   one call, in turns (G = 1, split, split, G = 1): K1 on the headline
   (1,024 x 480,000), the farm (16,384 x 192,000) and the sequencer
   (1,024 x 480,000) from farm_params and the initial state, K3 on the
   stage of each block cell (1,024 x 480,000, random input lanes): audio
   or stage outputs and final state equal bit for bit; both times logged
   with registers, T, G and shared memory; the headline, the farm and the
   kit check's stage also at the other chunk lengths;
16. one voice: stt.render(subtractive_voice, 48,000) on the card with the
   scan engine fenced off must launch K1 once and nothing else (timed);
   its first 4,800 samples equal the scan engine's unbatched render on
   the card bit for bit, and the render takes under 1 % of the scan
   engine's time for 1 s (from its per-sample cost there); render_stream
   without voices= (4 blocks), render_long(batched=False) (4 segments)
   and a one-patch render_many launch K1 once per block, segment or call
   and equal the render; reverb_patch the same way through the block
   engine (K3, K8, K9).

For slice 7 K8 has a second entry (``srack_tpu_torch/csrc/freeverb.cu``):
one CTA per voice with the voice's lines in shared memory, chunks of T
samples read in parallel and the combs' one-poles in one writer warp a
chunk behind; the per-sample kernel stays as its twin (``freeverb_twin``).
K2 runs as a pipeline of stage warps like K1 (its feedback ring read by
the stage that reads each key, written by its source's).  Phase 2 builds
both twins (K2's as ``fused_voice_buffer_g1``) and logs K8's T, shared
memory and CTAs per SM; phase 3 holds the new K8 against block_plain at
n = 2048 and 2047 with and without automated room_size and wet, and the
split K2 against the scan engine; phases 8, 9, 10 and 16 must launch the
new kernels and not the twins (each twin counts as another kernel);
phases 9 and 10 time K8's wrapper apart (lanes, allocations, K9 in,
K8, K9 out, the rest) on the arguments the render gives it; phase 15 holds
the split K2 against its twin on the buffer cell and the new K8 against
its twin on the very operands the reverb and block-check renders give it
([1,024, 480,000], caught at the launch), bit for bit, both timed in one
call, and requires K8 to beat its twin.  To keep the script's time, phase
3 holds K1, K3 and the block engine to the scan engine at n = 1024 and
1023 (before: 2048 and 2047; K2, K7 and K8 keep their lengths).

For slice 8 K10's backward (``fused_vjp_bwd``) runs as a reverse
pipeline of sweep stage warps fed by replay warps
(``srack_tpu_torch/ops/fused.py::_generate_bwd_pipeline``), the
one-thread kernel staying as its twin (``fused_vjp_bwd_twin``); K7 reads
its lanes as 2-D views of any strides through tiles of voices staged in
shared memory (``csrc/sample_play.cu``, entry ``srk_sample_play``).
Phase 2 builds the backward's twin and logs each K10 build's sweep
stages, replay warps and sub-chunk; phase 3 requires every K10 case to
take the split backward and holds K7 from transposed views too; phase 14
must launch the split backward and never its twin; phases 11-13 time K7
on the render's own operands (the stage's transposed gate, no copy);
phase 15 holds the split backward to its twin at 1,024 x 48,000, bit for
bit, both timed in one call, and times K7 on the operands of every
Sample launch of the drums, sampler and kit-check renders, on the first
at every tile shape, each equal to the main path's shape bit for bit.

K10's forward (``fused_vjp_fwd``) also runs on K1's stage-warp
pipeline, each stage warp storing its own checkpoint rows
(``srack_tpu_torch/ops/fused.py::_generate_pipeline`` with ``t_chunk``),
the one-thread forward staying as its twin (``fused_vjp_fwd_twin``); K9
(``csrc/ring_align.cu``) moves the lines through a shared-memory tile of
32 voices x P positions (entry ``srk_ring_align_tile``).  Phase 2 builds
the forward's twin and the training voice's forward at chunks of 64 and
128, and logs each K10 forward's stages, chunk and shared memory and
K9's tile; phase 3 requires every K10 case to take the split forward;
phase 14 must launch ``fused_vjp_fwd`` and never its twin; phases 6, 9
and 10 time K9's launch alone (its arguments made once); phase 15 holds
the split forward to its twin at 1,024 x 48,000 (farm_params and phase
14's params: audio, final state and checkpoints bit for bit, also at T =
64 and 128), the pair timed in one call, and K9 to the plain gather on
the operands of both K9 calls of the reverb and block-check renders (bit
for bit at every tile length of ``K9_TILES``, each timed).

For slice 10, exact precision (``AudioConfig(precision="exact")``): f64
builds of K3 (``serial_stage_f64``: a stage with f64 leaves, the exact
Oscillator's phase in double rows), K4 (``row_scan_f64``: entries
``srk_scan_{sum,max,fill}_f64``), K8 (``freeverb_f64`` and its twin
``freeverb_twin_f64``: the Freeverb's f64 core) and K9 (``ring_align_f64``:
8-byte elements), each with a launch count of its own.  Phase 2 builds the exact stages' K3 (48 kHz and 4,800 Hz)
and finds the fixed sources' f64 entries in their libraries; phase 3
holds K4 f64 (sum within 1e-12 relative, max and fills exact), K9 f64
(exact), K8 f64 through its wrapper (2e-5, n = 2048 and 2047,
with and without automation) and its twin (bit for bit), the exact
stages' K3 (outputs within 1e-6, f64 state within 1e-12) and the exact
block engine against the exact scan engine at 4,800 Hz (subtractive_voice,
feedback_patch, reverb_patch and the three kits, the Sample on K7; within
5e-6);

17. exact: three main paths through ``render_batch`` (engine auto, the
   scan engine fenced off), 1,024 voices x 480,000 samples at 48 kHz:
   subtractive_voice with ``segment=96000`` (bench.py's exact rung: the
   f64 Oscillator block forms on K4's f64 sum, K3 for the Moog and ADSR),
   reverb_patch, stereo, the same segments (plus K9 f64, K8 f64, K9 f64)
   and feedback_patch unsegmented (K3 f64: both f64 Oscillators in the
   stage): each must launch its f64 builds and nothing else, give finite
   audio with peak <= 1.002, and 1,024 samples from random f64 phases
   within 5e-6 of the exact scan engine on the card; each is timed (CUDA
   events, after a warm-up) with its memory peak and each kernel alone at
   its shapes, its fast render's first 48,000 samples are compared with
   the exact ones (reported), and a segmented path also tries one
   unsegmented render (fits or not); then one unbatched exact voice
   through ``render`` (1 s) and ``render_stream`` (4 blocks), and
   ``tests/test_precision.py``'s sine fast against exact within 1e-3.

For slice 11 (the farm on torch.distributed, io, the CLI, play and
profiling) phase 2 also builds K3 of the .srk fixture's stage, K1 of the
midi command's gate/CV voice and the Noise-lane kernel
(``srack_tpu_torch/csrc/noise_lanes.cu``, the Noise module's
counter-based draw; it ports no Pallas kernel, the JAX package drawing
with jax.random in XLA).  Phase 11 must launch it, its warm-up holds it
bit for bit to its plain version at the render's shape, and the split
times it alone;

18. farm: ``parallel.render_farm`` of the farm cell (subtractive_voice,
   16,384 voices x 192,000 samples, farm_params seed 0) on a one-rank NCCL
   mesh (``init_distributed`` with a world of 1: NCCL takes one rank per
   card) and on a mesh of four slots on cuda:0, per voice and with
   ``mixdown=True``: the audio equal to ``compile_patch(...).render(
   batched=True)`` bit for bit, the mix within V 2^-24 max|audio| of the
   voices summed in float64, K1 once per slot and the scan engine never;
   drum_machine (1,024 x 48,000, key 5) on the four slots equal to one
   local render bit for bit (the Noise lanes keyed by the global voice),
   K3, K7 and the Noise-lane kernel once per slot; ``batched_train_step(mesh=, fast=True)`` at
   phase 14's config on both meshes against the unsharded step: the loss
   and every param leaf within 1e-6 relative, the gradients within 1e-4
   of their largest, one K10 forward and one backward per slot; and
   ``render_many(mesh=)`` of six patches in three topologies equal to
   ``render_many`` without a mesh bit for bit; each render and the
   ``all_reduce`` of the mix bus timed;
19. io: the ``.srk`` fixture (``tests/data/reference_all_modules.srk``)
   read with ``io.read_srk`` and rendered 1 s at 1,024 voices (its engine
   and kernels logged), its first 1,024 samples within 5e-6 of the scan
   engine on the card; an exact reverb_patch through ``save_patch`` /
   ``load_patch`` and ``save_state`` / ``load_state`` (the f64 leaves back
   as f64 on cuda; the resumed render equal to the one from the state it
   saved bit for bit and to the unbroken render within 5e-6); the CLI in
   this process (``render subtractive``, ``render reverb``, ``render
   subtractive --precision exact``, 10 s each; ``render`` of the fixture;
   ``midi`` of a chord file the phase builds from bytes), each WAV's PCM
   equal to its render's at 16 bits, launches counted; ``play`` of
   subtractive_voice for 5 s into the null sink, one voice and 1,024
   voices (blocks, underruns and worst headroom reported); ``timed_render``
   of the headline and a ``torch.profiler`` trace of the reverb render
   (``utils.profiling.trace``, written to chiprun_out/trace/), summed into
   its top 10 device ops and its device idle gaps.

For slice 12, K4 (``csrc/row_scan.cu``) is a pipelined kernel: each
thread's elements are prefetched with cp.async into a ring of 2-4 chunk
stages in shared memory, the CTA scan takes two barriers a chunk, and
an entry's 16-byte variant (``*_vec``) or its one-element variant (no
suffix) is picked by the wrapper.  A render's initial state is made on
its device (``init_state(device)``).  Phase 2 logs each pipelined build's
registers, spills, stack frame, ring bytes and CTAs per SM (the occupancy
query); phase 3 holds every kind and dtype (sum and max of f32, int32 and
f64, fills of 1-4 arrays of each, affine) to its plain version at
[1,024, 48,000] (the 16-byte variant) and [1,024, 47,999] (the
one-element one), each launch's entry checked, and times each dtype's sum
through both variants and torch.cumsum; phase 19 traces the reverb render
twice, its state built on the host as before and made by the render on
the card (host-to-device copies, pageable ones, idle share), and holds ``init_state("cuda")`` of every patch the phases render (fast
and exact, both feedback modes, the .srk fixture) to the host build bit
for bit, broadcast over 1,024 voices.

Each main path (phases 4, 5, 7-14, 16-19) runs with the launch counts
set to 0 just before it and read just after.  Any failure raises and exits
non-zero.  The line before the last is a JSON record of the kernels; the
last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SR = 48000
VOICES = 1024
CHECK_NS = (2048, 2047)
# the lengths at which phase 3 holds K1, K3 and the block engine to the scan
# engine: a whole number of chunks and one sample short of it; the scan
# engine's ~3-12 ms per sample at 1,024 voices set the script's time
PLAIN_NS = (1024, 1023)
BUFFER_BLOCK = 1024
BUFFER_CHECK_NS = (2048, 3072)
HEADLINE_N = 480000
FARM_VOICES, FARM_N = 16384, 192000
BUFFER_N = 491520  # 480 blocks of 1,024, 10.24 s
ATOL = 1e-5  # fused-vs-scan audio tolerance of the JAX package's tests
PEAK_MAX = 1.002
PEAK = {}  # device memory peaks of the last main path: warm-up, render
RENDER_MS = []  # each timed render of the last main path, ms
BLOCK_RENDERS = 5  # phases 9 and 10 time this many renders: their
                   # host-side rest swings from render to render
# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores,
# and device memory bandwidth
PEAK_F32 = 67e12
PEAK_F64 = 34e12    # f64 outside the tensor cores (exact precision's work)
PEAK_BYTES = 3.35e12
F64 = torch.float64


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, repeats: int = 1, warmup: int = 0) -> float:
    """Mean device time of ``fn()`` over a run of ``repeats`` calls, in ms,
    after ``warmup`` untimed calls (which leave the caching allocator
    holding the outputs' memory): CUDA events around the whole run,
    Python's garbage collector held off inside it."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    gc.collect()
    gc.disable()
    try:
        torch.cuda.synchronize()
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        gc.enable()
    return start.elapsed_time(end) / repeats


def ptxas(kernel) -> str:
    return " | ".join(ln.strip() for ln in kernel.build_log.splitlines()
                      if "registers" in ln or "spill" in ln)


def registers(kernel) -> int:
    """The registers per thread ptxas reports for the kernel's build."""
    import re
    found = re.findall(r"Used (\d+) registers", kernel.build_log)
    return int(found[0]) if found else -1


def pipeline(kernel) -> str:
    """How a K1 or K3 build runs its plan: its stages (G), chunk (T) and
    shared memory, or one thread per voice."""
    part = getattr(kernel, "partition", None)
    if part is None:
        return ""
    if part.n_stages == 1:
        return ", G=1: one thread per voice"
    store = (" and a store warp" if kernel.warps > part.n_stages
             else "")
    return (f", G={part.n_stages} stages of {list(part.costs)} ops"
            f"{store}, T={kernel.chunk} in groups of U={kernel.group}, "
            f"{kernel.smem_bytes} B shared memory, "
            f"{len(part.wires)} cross-stage wires")


def module_ops(compiled, mid) -> int:
    """f32 operations per sample of a module's device function, read off
    ``csrc/modules.cuh`` (``srack_tpu_torch.ops.partition.module_ops``, by
    which the partition of K1 and K3 weighs its stages).  Counted for the
    bounds."""
    from srack_tpu_torch.ops.partition import module_ops as ops
    return ops(compiled, mid)


def bound(compiled, kernel, v: int, n: int, lanes=()) -> tuple:
    """The least time the card could take for one render: the larger of
    the bytes moved once (params and state in, lanes in, audio and state
    out, K2's fb ring in and out) over device bandwidth and the f32
    operations over the f32 peak.  Returns ``(ms, "bytes"|"operations",
    bytes, ops)``."""
    lay = kernel.layout
    rows = lay.n_pf + lay.n_pi + 2 * (lay.n_sf + lay.n_si)
    nbytes = 4 * v * (rows + len(lanes) * n + compiled.cfg.channels * n)
    if compiled.cfg.buffer_feedback:
        nbytes += 2 * 4 * v * len(compiled.fb_keys) * compiled.cfg.block_size
    per_sample = sum(module_ops(compiled, m) for m in compiled.plan)
    ops = per_sample * v * n
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, nbytes, ops


def _log_bound(phase, name, case, v, n, ms) -> None:
    _, compiled, kernel = case
    b_ms, b_by, nbytes, ops = bound(compiled, kernel, v, n, kernel.lanes)
    log(f"[{phase}] bound of {name} V={v} n={n}: {nbytes} bytes, {ops} f32 "
        f"operations -> {b_ms:.4f} ms ({b_by}); the render takes "
        f"{ms / b_ms:.1f}x its bound ({100 * b_ms / ms:.2f} %)")


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device: this smoke run needs "
          "one card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[1 device] torch %s, CUDA %s, %d card(s): %s"
        % (torch.__version__, torch.version.cuda, torch.cuda.device_count(),
           torch.cuda.get_device_name(0)))
    log(card)
    log("[1 device] TF32 off for matmul and cuDNN")
    return card


def _lane_drivers(stt, patch, compiled, v, n, seed=0):
    """lane_check_patch's driver and automation lanes on the card: random
    step pulses on the gate Input and a pitch lane on the VCO's val."""
    rng = np.random.default_rng(seed)
    ids = {inst.name: inst.id for inst in patch}
    gate = (rng.uniform(size=(v, n)) < 0.02).astype(np.float32)
    pitch = rng.uniform(-1.5, 0.5, (v, n)).astype(np.float32)
    return {ids["gate"]: torch.from_numpy(gate).cuda(),
            compiled._auto_key(ids["vco"], "val"):
                torch.from_numpy(pitch).cuda()}


def phase_build(stt):
    cfg1 = stt.AudioConfig(sample_rate=SR, channels=1)
    lane_patch, autos = stt.presets.lane_check_patch(
        stt.AudioConfig(sample_rate=SR, channels=2))
    cases = {
        "subtractive_voice": (stt.presets.subtractive_voice(cfg1), ()),
        "sine_patch": (stt.presets.sine_patch(cfg1), ()),
        "feedback_patch": (stt.presets.feedback_patch(cfg1), ()),
        "kernel_check_patch": (stt.presets.kernel_check_patch(
            stt.AudioConfig(sample_rate=SR, channels=3)), ()),
        "sequencer_patch": (stt.presets.sequencer_patch(cfg1), ()),
        "lane_check_patch": (lane_patch, autos),
        "feedback_buffer": (stt.presets.feedback_patch(stt.AudioConfig(
            sample_rate=SR, block_size=BUFFER_BLOCK, channels=1,
            buffer_feedback=True)), ()),
    }
    kernels = {}
    for name, (patch, automation) in cases.items():
        compiled = stt.compile_patch(patch, automation=automation)
        lanes = ()
        if name == "lane_check_patch":
            ids = {inst.name: inst.id for inst in patch}
            lanes = (ids["gate"], ids["noise"],
                     compiled._auto_key(ids["vco"], "val"))
        kernels[name] = (patch, compiled, compiled.fused(lanes))
    jobs = {name: k for name, (_, _, k) in kernels.items()}
    jobs.update(block_kernels(stt))
    jobs.update(vjp_kernels(stt))
    jobs.update(ab_kernels(kernels))
    jobs.update(exact_kernels(stt))
    jobs.update(slice11_kernels(stt))
    jobs.update(ragged_kernels(stt))

    def build(name):
        t0 = time.perf_counter()
        jobs[name].build()
        return name, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        for name, secs in pool.map(build, jobs):
            kernel = jobs[name]
            log(f"[2 build] {name} ({kernel.name}{pipeline(kernel)}): nvcc "
                f"sm_90a built in {secs:.2f} s; {ptxas(kernel)}")
    # K6 is the second entry of K5's source, K8's twin the second entry of
    # K8's: each build is found by hash
    from srack_tpu_torch.ops.gather_kernel import ROW_GATHER_LONG
    ROW_GATHER_LONG.build()
    log(f"[2 build] row_gather_long: the library of row_gather "
        f"(csrc/row_gather.cu, entries srk_gather_long_*)")
    k8_shape(stt)
    k9_shape(stt)
    exact_shapes(stt)
    k4_shape(stt)
    return kernels


def k8_shape(stt) -> dict:
    """Build K8's twin (the second entry of K8's source, found by hash)
    and record the shared-memory K8's shape at 48 kHz in ``K8_SHAPE``:
    rows, T, shared memory and the CTAs an SM holds (the card's occupancy
    query)."""
    from srack_tpu_torch.ops import freeverb_kernel as fvk
    fvk.FREEVERB_TWIN.build()
    lens = fvk.all_lengths(stt.AudioConfig(sample_rate=SR))
    tile = fvk.tile_for(lens)
    ctas = ctypes.c_int(-1)
    fn = fvk.FREEVERB.build().srk_freeverb_ctas_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], \
        ctypes.c_int
    check(fn(sum(lens), tile, ctypes.byref(ctas)) == 0,
          "K8's occupancy query failed")
    K8_SHAPE.update(rows=sum(lens), tile=tile, ctas_per_sm=ctas.value,
                    smem_bytes=fvk.tile_bytes(lens, tile))
    log(f"[2 build] freeverb_twin: the library of freeverb (csrc/"
        f"freeverb.cu, entry srk_freeverb_twin); freeverb at {SR} Hz: one "
        f"CTA of 160 threads per voice, T={tile}, {K8_SHAPE['smem_bytes']} B"
        f" shared memory, {ctas.value} CTAs per SM; ptxas: "
        f"{ptxas(fvk.FREEVERB)}")
    return K8_SHAPE


def k9_shape(stt) -> dict:
    """Record K9's tile shape at 48 kHz in ``K9_SHAPE``: voices and
    positions a tile, warps a CTA, shared memory, and the CTAs of one
    launch over the 24 lines of 1,024 voices."""
    from srack_tpu_torch.ops import freeverb_kernel as fvk
    from srack_tpu_torch.ops.ring_roll import RING_ALIGN
    lens = fvk.all_lengths(stt.AudioConfig(sample_rate=SR))
    p = RING_ALIGN.tile
    tiles = sum(-(-x // p) for x in lens)
    K9_SHAPE.update(voices=32, positions=p, warps=8,
                    smem_bytes=4 * 32 * (p + 1),
                    ctas=tiles * -(-VOICES // 32))
    log(f"[2 build] ring_align: tiles of 32 voices x {p} positions, one CTA of 8 warps each, "
        f"{K9_SHAPE['smem_bytes']} B shared memory, {K9_SHAPE['ctas']} CTAs "
        f"for the 24 lines of {VOICES} voices at {SR} Hz; ptxas: "
        f"{ptxas(RING_ALIGN)}")
    return K9_SHAPE


def _state_diff(got: dict, want: dict, where: str) -> float:
    """Largest float-state difference; int32 and bool state must match."""
    worst = 0.0
    for path_key in ("states", "fb"):
        check(set(got[path_key]) == set(want[path_key]),
              f"{where}: {path_key} keys differ")
        for mid, sub in want[path_key].items():
            leaves = sub.items() if isinstance(sub, dict) else [(None, sub)]
            for key, w in leaves:
                g = got[path_key][mid] if key is None else \
                    got[path_key][mid][key]
                name = f"{where} {path_key}.{mid}.{key}"
                check(g.shape == w.shape and g.dtype == w.dtype,
                      f"{name}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
                if w.dtype in (torch.int32, torch.bool):
                    check(torch.equal(g, w), f"{name}: not bit-exact")
                else:
                    d = (g - w).abs().max().item() if w.numel() else 0.0
                    check(d <= ATOL, f"{name}: float state off by {d}")
                    worst = max(worst, d)
    return worst


def _inputs(stt, name, patch, compiled, n):
    params = stt.compiler.tree_map(
        lambda a: a.cuda(), stt.presets.farm_params(patch, VOICES))
    state = stt.compiler.tree_map(
        lambda a: a.expand((VOICES,) + a.shape).contiguous().cuda(),
        compiled.init_state())
    drivers = (_lane_drivers(stt, patch, compiled, VOICES, n)
               if name == "lane_check_patch" else {})
    xs = compiled._make_xs(params, 0, n, drivers)
    return params, state, xs


def phase_compare(stt, kernels):
    """Kernels vs their plain version on the card, same inputs."""
    errs = {"fused_voice": 0.0, "fused_voice_buffer": 0.0}
    keep = {}
    for name, (patch, compiled, kernel) in kernels.items():
        ns = BUFFER_CHECK_NS if kernel.buffer else PLAIN_NS
        for n in ns:
            t0 = time.perf_counter()
            params, state, xs = _inputs(stt, name, patch, compiled, n)
            audio_k, final_k = kernel.render(params, state, n, xs)
            torch.cuda.synchronize()
            with torch.no_grad():
                audio_p, final_p = compiled.render_scan(
                    params, state, n, batched=True, nograd=True, xs=xs)
            torch.cuda.synchronize()
            check(audio_k.shape == audio_p.shape,
                  f"{name} n={n}: audio {audio_k.shape} vs {audio_p.shape}")
            check(bool(torch.isfinite(audio_p).all()),
                  f"{name} n={n}: plain version not finite")
            err = (audio_k - audio_p).abs().max().item()
            check(err <= ATOL, f"{name} n={n}: audio off by {err}")
            serr = _state_diff(final_k, final_p, f"{name} n={n}")
            exact = torch.equal(audio_k, audio_p)
            # K1, split into stages or not, runs the scan engine's
            # arithmetic: bit for bit
            check(kernel.buffer or (exact and serr == 0.0),
                  f"{name} n={n}: K1 not bit-exact (audio {err}, float "
                  f"state {serr})")
            lanes = f", lanes {sorted(xs)}" if xs else ""
            fb = (f", final fb ring [{len(compiled.fb_keys)} x {VOICES} x "
                  f"{compiled.cfg.block_size}] compared as state"
                  if kernel.buffer else "")
            log(f"[3 compare] {name} ({kernel.name}{pipeline(kernel)}) "
                f"V={VOICES} n={n}: max "
                f"|audio| err {err:.3e} (bit-exact: {exact}), max "
                f"float-state err {serr:.3e}, int32/bool state bit-exact"
                f"{lanes}{fb}; {time.perf_counter() - t0:.1f} s")
            errs[kernel.name] = max(errs[kernel.name], err)
            if n == ns[0] and name in ("subtractive_voice",
                                       "feedback_buffer"):
                keep[kernel.name] = {"params": params, "state": state,
                                     "n": n, "audio_plain": audio_p,
                                     "kernel": kernel, "compiled": compiled}
    return errs, keep


def _times(keep: dict) -> dict:
    """Kernel (mean of 5) and plain-version times at phase 3's shape."""
    out = {}
    for name, k in keep.items():
        p, s, n, kernel = k["params"], k["state"], k["n"], k["kernel"]
        kernel_ms = cuda_ms(lambda: kernel.render(p, s, n), repeats=5)
        with torch.no_grad():
            plain_ms = cuda_ms(lambda: k["compiled"].render_scan(
                p, s, n, batched=True, nograd=True))
        out[name] = (kernel_ms, plain_ms)
    return out


def _counters(kernels):
    """Every kernel wrapper with a launch count: the fused kernels of phase
    2's cases, the serial-stage kernels and the fixed sources."""
    from srack_tpu_torch.ops.freeverb_kernel import FREEVERB, FREEVERB_TWIN
    from srack_tpu_torch.ops.gather_kernel import ROW_GATHER, ROW_GATHER_LONG
    from srack_tpu_torch.ops.noise_kernel import NOISE_LANES
    from srack_tpu_torch.ops.ring_roll import RING_ALIGN
    from srack_tpu_torch.ops.sample_kernel import SAMPLE_PLAY
    from srack_tpu_torch.ops.scan_kernel import ROW_SCAN
    out = [kernel for _, _, kernel in kernels.values()]
    out += [lib for _, _, k in VJP.values() for lib in (k.fwd, k.bwd)]
    # phase 15's K10 builds, the twins named apart
    out += [lib for k in VJP_AB.values() for lib in (k.fwd, k.bwd)]
    out += list(STAGES.values()) + list(CHECK_STAGES.values()) + [
        ROW_SCAN, FREEVERB, FREEVERB_TWIN, RING_ALIGN, ROW_GATHER,
        ROW_GATHER_LONG, SAMPLE_PLAY, NOISE_LANES]
    # slice 10: exact precision's stages and the f64 builds
    out += list(EXACT_STAGES.values()) + f64_libs()
    # the one-thread twins of phase 15, named apart: a main path that
    # launched one would count as another kernel
    out += [one for _, one in AB.values()]
    # every kernel of a compiled plan still in the compile cache (phases
    # 18-19 compile patches of their own, e.g. the .srk fixture's)
    from srack_tpu_torch.compiler import _COMPILE_CACHE
    for compiled in _COMPILE_CACHE.values():
        out += list(compiled._fused.values())
        out += [lib for k in compiled._fused_vjp.values()
                for lib in (k.fwd, k.bwd)]
        if compiled._block_prog is not None:
            out += list(compiled._block_prog._stage_kernels.values())
    # cases of one compiled plan share its wrappers: count each once
    return list({id(k): k for k in out}.values())


def _timed_main(kernels, render, names, warmup_within=None, renders=1):
    """Warm up (inside the context manager ``warmup_within``, if given),
    then ``renders`` renders, each timed with CUDA events, with every
    kernel's launch count set to 0 just before them and read just after.
    Every kernel in ``names`` must have launched, the same number of times
    in each render, and no other.  Returns ``(audio, ms, {name: launches
    per render})``, ``ms`` the median render (each render's time in
    ``RENDER_MS``)."""
    names = (names,) if isinstance(names, str) else tuple(names)
    with warmup_within or contextlib.nullcontext():
        audio, _, _ = render()
    del audio
    torch.cuda.synchronize()
    out = {}
    counters = _counters(kernels)
    for kernel in counters:
        kernel.launches = 0
    PEAK["warm-up"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    RENDER_MS[:] = [cuda_ms(lambda: out.update(r=render()))
                    for _ in range(renders)]
    ms = float(np.median(RENDER_MS))
    PEAK["render"] = torch.cuda.max_memory_allocated()
    counts = {}
    for kernel in counters:
        counts[kernel.name] = counts.get(kernel.name, 0) + kernel.launches
    launches = {name: counts.pop(name) for name in names}
    for name, k in launches.items():
        check(k >= 1 and k % renders == 0, f"the main path launched {name} "
              f"{k} times in {renders} renders")
        launches[name] = k // renders
    check(not any(counts.values()),
          f"the main path launched other kernels: {counts}")
    if len(names) == 1:
        return out["r"][0], ms, launches[names[0]]
    return out["r"][0], ms, launches


def _check_audio(audio, shape, what):
    check(tuple(audio.shape) == shape, f"{what} audio shape "
          f"{tuple(audio.shape)}")
    check(bool(torch.isfinite(audio).all()), f"{what} audio not finite")
    peak = audio.abs().max().item()
    check(peak <= PEAK_MAX, f"{what} output clips: peak {peak}")
    return peak


def phase_main(stt, kernels, card, keep):
    patch = kernels["subtractive_voice"][0]
    params = stt.presets.farm_params(patch, VOICES)
    audio, ms, launches = _timed_main(
        kernels, lambda: stt.compile_patch(patch).render(
            HEADLINE_N, params=params, batched=True, device="cuda"),
        "fused_voice")
    peak = _check_audio(audio, (VOICES, 1, HEADLINE_N), "headline")
    n0 = keep["n"]
    prefix_err = (audio[:, :, :n0] - keep["audio_plain"]).abs().max().item()
    check(prefix_err <= ATOL,
          f"headline's first {n0} samples off the plain version by "
          f"{prefix_err}")
    rate = VOICES * HEADLINE_N / (ms / 1e3)
    _log_bound("4 main", "subtractive_voice", kernels["subtractive_voice"],
               VOICES, HEADLINE_N, ms)
    log(f"[4 main] subtractive_voice V={VOICES} n={HEADLINE_N} "
        f"engine=auto -> fused_voice, {launches} launches; {ms:.3f} "
        f"ms/render, {rate / 1e9:.4f} G samples/s, aggregate real-time "
        f"{rate / SR:.0f}x, peak {peak:.5f}, first {n0} samples within "
        f"{prefix_err:.3e} of the plain version [{card}]")
    del audio
    torch.cuda.empty_cache()
    return launches, ms


def phase_farm(stt, kernels, card):
    patch = kernels["subtractive_voice"][0]
    params = stt.presets.farm_params(patch, FARM_VOICES)
    audio, ms, launches = _timed_main(
        kernels, lambda: stt.compile_patch(patch).render(
            FARM_N, params=params, batched=True, device="cuda"),
        "fused_voice")
    peak = _check_audio(audio, (FARM_VOICES, 1, FARM_N), "farm")
    rate = FARM_VOICES * FARM_N / (ms / 1e3)
    _log_bound("5 farm", "subtractive_voice", kernels["subtractive_voice"],
               FARM_VOICES, FARM_N, ms)
    log(f"[5 farm] subtractive_voice V={FARM_VOICES} n={FARM_N}: "
        f"{launches} launches; {ms:.3f} ms/render, {rate / 1e9:.4f} G "
        f"samples/s, aggregate real-time {rate / SR:.0f}x, peak "
        f"{peak:.5f} [{card}]")
    del audio
    torch.cuda.empty_cache()


def phase_sequencer(stt, kernels, card):
    patch, compiled, kernel = kernels["sequencer_patch"]
    params = stt.presets.farm_params(patch, VOICES)
    audio, ms, launches = _timed_main(
        kernels, lambda: stt.render_batch(patch, HEADLINE_N, params=params),
        "fused_voice")
    check(audio.device.type == "cuda", "render_batch did not default to "
          "the card")
    peak = _check_audio(audio, (VOICES, 1, HEADLINE_N), "sequencer")
    rate = VOICES * HEADLINE_N / (ms / 1e3)
    ns = ms * 1e6 / HEADLINE_N
    _log_bound("7 sequencer", "sequencer_patch", kernels["sequencer_patch"],
               VOICES, HEADLINE_N, ms)
    log(f"[7 sequencer] sequencer_patch ({len(compiled.plan)} modules) "
        f"V={VOICES} n={HEADLINE_N} via render_batch (default device) -> "
        f"fused_voice, {launches} launches; {ms:.3f} ms/render, "
        f"{rate / 1e9:.4f} G samples/s, aggregate real-time "
        f"{rate / SR:.0f}x, {ns:.1f} ns per sample per thread, peak "
        f"{peak:.5f}; ptxas: {ptxas(kernel)} [{card}]")
    del audio
    torch.cuda.empty_cache()
    return launches, ms


def phase_buffer(stt, kernels, card):
    patch, compiled, kernel = kernels["feedback_buffer"]
    params = stt.presets.farm_params(patch, VOICES)
    audio, ms, launches = _timed_main(
        kernels, lambda: stt.render_batch(patch, BUFFER_N, params=params),
        "fused_voice_buffer")
    peak = _check_audio(audio, (VOICES, 1, BUFFER_N), "buffer feedback")
    rate = VOICES * BUFFER_N / (ms / 1e3)
    _log_bound("8 buffer", "feedback_buffer", kernels["feedback_buffer"],
               VOICES, BUFFER_N, ms)
    check(kernel.partition.n_stages > 1, "K2 runs one thread per voice")
    check(kernel.ring_words == len(compiled.fb_keys) * BUFFER_BLOCK,
          f"K2's ring holds {kernel.ring_words} words a voice")
    log(f"[8 buffer] feedback_patch buffer_feedback=True block="
        f"{BUFFER_BLOCK} V={VOICES} n={BUFFER_N} via render_batch -> "
        f"fused_voice_buffer{pipeline(kernel)}, {launches} launches (the "
        f"one-thread twin none); {ms:.3f} ms/render, "
        f"{rate / 1e9:.4f} G samples/s, aggregate real-time "
        f"{rate / SR:.0f}x, {ms * 1e6 / BUFFER_N:.1f} ns per sample per "
        f"thread, peak {peak:.5f}, ring_words {kernel.ring_words}; ptxas: "
        f"{ptxas(kernel)} [{card}]")
    del audio
    torch.cuda.empty_cache()
    return launches, ms

# -- slice 3a: the block engine and its kernels K3, K4, K8, K9 ---------------

SCAN_ROWS, SCAN_N = 1024, 48000
BLOCK_ATOL = 5e-6   # block-vs-scan audio (tests/test_block_engine.py)
SCAN_TOL = {"sum": 2e-4, "affine": 3e-4}  # tests/test_scan_kernel.py
FV_TOL = 2e-5       # K8 vs its chunked plain version
F64_SUM_TOL = 1e-12  # K4's f64 sum vs its log-doubling form, abs + rel
# tests/test_freeverb_kernel.py; f32 operations per voice-sample of K8:
# 16 combs x 6, 8 allpasses x 3, the input gain 2, the stereo mix 10
FV_OPS = 16 * 6 + 8 * 3 + 2 + 10
STAGES = {}         # case -> the StageKernel (K3) of its serial stage
K8_SHAPE = {}       # the shared-memory K8 at 48 kHz: rows, T, CTAs per SM
K8_WRAPPER = {}     # cell -> K8's wrapper timed apart (phases 9, 10)
K9_SHAPE = {}       # K9's tile at 48 kHz: voices, positions, warps, CTAs


def _cuda(stt, tree):
    return stt.compiler.tree_map(lambda a: a.cuda(), tree)


def block_cases(stt):
    """The block engine's patches at 48 kHz, compiled: reverb_patch
    (stereo), block_check_patch (mono, with its two automated Freeverb
    params) and, from slice 3b, drum_machine, sampler_kit and
    kit_check_patch (mono)."""
    reverb = stt.presets.reverb_patch(stt.AudioConfig(sample_rate=SR,
                                                      channels=2))
    check_patch, autos = stt.presets.block_check_patch(
        stt.AudioConfig(sample_rate=SR, channels=1))
    cases = {"reverb_patch": (reverb, stt.compile_patch(reverb)),
             "block_check_patch": (check_patch, stt.compile_patch(
                 check_patch, automation=autos))}
    for name in KIT_NAMES:
        patch = getattr(stt.presets, name)(stt.AudioConfig(sample_rate=SR,
                                                           channels=1))
        cases[name] = (patch, stt.compile_patch(patch))
    return cases


def stage_lane_keys(prog) -> list:
    """The lanes a render gives the stage kernel: its input wires, in
    buffer mode its delayed wires, and the hoisted lanes (Noise) of its
    modules; the patches here automate no stage module."""
    from srack_tpu_torch.block_engine import wire_key
    return ([wire_key(w) for w in prog.stage_in]
            + [wire_key(("fb",) + k) for k in prog.stage_fb_in]
            + [m for m in prog.stage_plan
               if prog.compiled.instances[m][0].make_xs is not None])


def block_kernels(stt) -> dict:
    """The block engine's kernels for phase 2's build: K3 for each case's
    stage at 48 kHz (registered in ``STAGES``) and for phase 3's 4,800 Hz
    comparisons (``CHECK_STAGES``), K4, K8, K9, K5 and K7."""
    from srack_tpu_torch.ops.freeverb_kernel import FREEVERB
    from srack_tpu_torch.ops.gather_kernel import ROW_GATHER
    from srack_tpu_torch.ops.ring_roll import RING_ALIGN
    from srack_tpu_torch.ops.sample_kernel import SAMPLE_PLAY
    from srack_tpu_torch.ops.scan_kernel import ROW_SCAN
    jobs = {}
    for name, (_, compiled) in block_cases(stt).items():
        prog = compiled.block_program()
        STAGES[name] = prog.stage_kernel(stage_lane_keys(prog))
        jobs[f"{name} stage"] = STAGES[name]
    for key, (_, compiled) in kit_check_cases(stt).items():
        prog = compiled.block_program()
        CHECK_STAGES[key] = prog.stage_kernel(stage_lane_keys(prog))
        jobs[f"{key[0]} {key[1]} {KIT_SR} Hz stage"] = CHECK_STAGES[key]
    jobs.update(row_scan=ROW_SCAN, freeverb=FREEVERB, ring_align=RING_ALIGN,
                row_gather=ROW_GATHER, sample_play=SAMPLE_PLAY)
    return jobs


def _random_state(stt, compiled, v, seed):
    """The initial state of V voices with every oscillator at a random
    phase, every Freeverb's lines, write indices and filter states random
    (the voices sound from the first sample, and K9 rotates), every
    sequencer at a random step and every Sample at a random whole-frame
    position, playing or not."""
    rng = np.random.default_rng(seed)
    state = stt.compiler.tree_map(
        lambda a: a.expand((v,) + a.shape).contiguous(),
        compiled.init_state())
    for mid, (mdef, _, _) in compiled.instances.items():
        sd = state["states"][mid]
        if mdef.type_name == "Oscillator" and sd["pos"].dtype == F64:
            sd["pos"] = torch.from_numpy(rng.uniform(0.0, 1.0, v))
        elif mdef.type_name == "Oscillator":
            sd["pos"] = torch.from_numpy(rng.integers(
                -2 ** 31, 2 ** 31 - 1, v, dtype=np.int64).astype(np.int32))
        elif mdef.type_name == "Freeverb":
            for k in list(sd):
                if k.endswith("_idx"):
                    sd[k] = torch.from_numpy(rng.integers(
                        0, sd[k[:-4]].shape[-1], v).astype(np.int32))
                else:
                    sd[k] = torch.from_numpy((rng.standard_normal(
                        tuple(sd[k].shape)) * 0.05).astype(
                            np.float64 if sd[k].dtype == F64
                            else np.float32))
        elif mdef.type_name.endswith("Sequencer"):
            steps = int(compiled.default_params[mid]["n_steps"])
            sd["current_step"] = torch.from_numpy(
                rng.integers(0, steps, v).astype(np.int32))
        elif mdef.type_name == "Sample":
            # whole frames: the scan engine's running sum and the block
            # form's prefix sum then agree exactly
            length = int(compiled.default_params[mid]["length"])
            sd["pos"] = torch.from_numpy(
                rng.integers(0, length, v).astype(np.float32))
            sd["playing"] = torch.from_numpy(rng.uniform(size=v) < 0.5)
            sd["gate_last"] = torch.from_numpy(rng.uniform(size=v) < 0.5)
    return _cuda(stt, state)


def _stage_inputs(stt, name, n, seed):
    patch, compiled = block_cases(stt)[name]
    prog = compiled.block_program()
    rng = np.random.default_rng(seed)
    params = _cuda(stt, stt.presets.farm_params(patch, VOICES))
    state = _random_state(stt, compiled, VOICES, seed)
    stage_state = {"states": {m: state["states"][m]
                              for m in prog.stage_plan},
                   "fb": state["fb"]}
    lanes = {k: torch.from_numpy(rng.uniform(
        -1, 1, (VOICES, n)).astype(np.float32)).cuda()
        for k in STAGES[name].lanes}
    derived = compiled.derived_params(params)
    plain_params = {m: derived[m] for m in prog.stage_plan}
    return prog, params, stage_state, lanes, plain_params


def compare_stage(stt, name, n):
    """K3 against the stage's torch loop, same inputs: stage outputs within
    1e-5 (expected bit-exact), int32/bool state bit-exact, float state
    within 1e-5."""
    t0 = time.perf_counter()
    prog, params, stage_state, lanes, plain_params = _stage_inputs(
        stt, name, n, n)
    kernel = STAGES[name]
    outs_k, final_k = kernel.run(params, stage_state, lanes, n)
    torch.cuda.synchronize()
    with torch.no_grad():
        outs_p, final_p = prog.stage_plain(plain_params, stage_state, lanes,
                                           n)
    torch.cuda.synchronize()
    err, exact = 0.0, True
    for w in prog.stage_out:
        check(bool(torch.isfinite(outs_p[w]).all()),
              f"{name} stage plain version not finite")
        err = max(err, (outs_k[w] - outs_p[w]).abs().max().item())
        exact = exact and torch.equal(outs_k[w], outs_p[w])
    check(err <= ATOL, f"{name} stage n={n}: outputs off by {err}")
    serr = _state_diff(final_k, final_p, f"{name} stage n={n}")
    check(exact and serr == 0.0, f"{name} stage n={n}: K3 not bit-exact "
          f"(outputs {err}, float state {serr})")
    log(f"[3 compare] {name} stage ({kernel.name}{pipeline(kernel)}, "
        f"{len(prog.stage_plan)} modules, {len(lanes)} input wires, "
        f"{len(prog.stage_out)} output wires) V={VOICES} n={n}: max |out| "
        f"err {err:.3e} (bit-exact: "
        f"{exact}), max float-state err {serr:.3e}, int32/bool state "
        f"bit-exact; {time.perf_counter() - t0:.1f} s")
    return err


def _scan_inputs():
    rng = np.random.default_rng(0)
    shape = (SCAN_ROWS, SCAN_N)

    def dev(a):
        return torch.from_numpy(a).cuda()
    return {
        "xf": dev(rng.standard_normal(shape).astype(np.float32)),
        "xi": dev(rng.integers(-2 ** 31, 2 ** 31 - 1, shape,
                               dtype=np.int64).astype(np.int32)),
        "yf": dev(rng.standard_normal(shape).astype(np.float32)),
        "mask": dev(rng.uniform(size=shape) < 1e-3),
        "a": dev(rng.uniform(0.99, 1.0, shape).astype(np.float32)),
        "b": dev(rng.standard_normal(shape).astype(np.float32)),
    }


def compare_scans():
    """K4, each kind on [1,024, 48,000] random rows (48 chunks of 1,024 per
    row, so the carried prefix is used): int32 sum, both maxes and the
    fills exact (the fills where a value is defined), f32 sum within
    2e-4 and affine within 3e-4 (abs + rel)."""
    from srack_tpu_torch.ops import basic
    from srack_tpu_torch.ops.scan_kernel import ROW_SCAN
    t0 = time.perf_counter()
    x = _scan_inputs()
    worst = 0.0
    cases = [("sum f32", lambda: ROW_SCAN.run("sum", (x["xf"],)),
              lambda: (basic.cumsum_plain(x["xf"]),), SCAN_TOL["sum"]),
             ("sum i32", lambda: ROW_SCAN.run("sum", (x["xi"],)),
              lambda: (basic.cumsum_plain(x["xi"]),), 0),
             ("max f32", lambda: ROW_SCAN.run("max", (x["xf"],)),
              lambda: (basic.cummax_plain(x["xf"]),), 0),
             ("max i32", lambda: ROW_SCAN.run("max", (x["xi"],)),
              lambda: (basic.cummax_plain(x["xi"]),), 0),
             ("affine f32", lambda: ROW_SCAN.run("affine", (x["a"], x["b"])),
              lambda: basic.affine_scan_plain(x["a"], x["b"]),
              SCAN_TOL["affine"])]
    for what, kern, plain, tol in cases:
        got, want = kern(), plain()
        for g, w in zip(got, want):
            if tol:
                d = (g - w).abs()
                bad = (d > tol + tol * w.abs()).sum().item()
                check(bad == 0, f"K4 {what}: {bad} elements off")
                err = d.max().item()
                worst = max(worst, err)
            else:
                check(torch.equal(g, w), f"K4 {what}: not exact")
                err = 0.0
        log(f"[3 compare] row_scan {what} [{SCAN_ROWS}, {SCAN_N}]: max abs "
            f"err {err:.3e} (tolerance "
            f"{f'{tol} abs + {tol} rel' if tol else 'exact'})")
    for what, vals in (("fill f32 x2", (x["xf"], x["yf"])),
                       ("fill i32 x1", (x["xi"],))):
        got, ok = ROW_SCAN.fill(vals, x["mask"])
        want, want_ok = basic.forward_fill_multi_plain(vals, x["mask"])
        check(torch.equal(ok, want_ok), f"K4 {what}: validity differs")
        for g, w in zip(got, want):
            check(torch.equal(g[ok], w[ok]), f"K4 {what}: not exact")
        log(f"[3 compare] row_scan {what} [{SCAN_ROWS}, {SCAN_N}]: exact "
            f"where a value is defined ({ok.float().mean().item():.4f} of "
            f"the elements)")
    log(f"[3 compare] row_scan: {time.perf_counter() - t0:.1f} s")
    return worst, x


def _ring_inputs(stt, f64=False):
    """The 24 rings [1,024, L_j] of a 48 kHz Freeverb and their write
    indices [24, 1,024], random (``f64``: the rings as doubles)."""
    from srack_tpu_torch.ops.freeverb_kernel import all_lengths
    rng = np.random.default_rng(1)
    lens = all_lengths(stt.AudioConfig(sample_rate=SR))
    rings = [torch.from_numpy(rng.standard_normal((VOICES, n)).astype(
        np.float64 if f64 else np.float32)).cuda() for n in lens]
    idx = torch.from_numpy(np.stack([rng.integers(0, n, VOICES)
                                     for n in lens]).astype(np.int32)).cuda()
    return lens, rings, idx


def ring_to_lines(rings, lens, idx):
    """K9 as the Freeverb wrapper calls it on entry: the rings in time
    order, written as [L_j, V] lines (the build of the rings' dtype).
    Returns the lines."""
    from srack_tpu_torch.ops.ring_roll import ring_align_for
    lines = [torch.empty((n, VOICES), dtype=rings[0].dtype, device="cuda")
             for n in lens]
    ring_align_for(rings[0].dtype).move(rings, lines, lens, VOICES, idx=idx,
                                        dst_lines=True)
    return lines


def k9_call(kernel, src, dst, lens, v, **kw):
    """One K9 launch (``kernel``: an entry of ``ops/ring_roll.py``) with its
    arguments made once, for timing the kernel without the wrapper's
    per-call host work; ``src`` and ``dst`` must outlive it."""
    call = kernel.call(src, dst, lens, v, **kw)
    return lambda: kernel.launch(*call)


def compare_ring(stt, f64=False):
    """K9 on every line length of a 48 kHz Freeverb, [1,024, L] each, one
    launch for all 24 lines: rings to the Freeverb kernel's [L, V] lines
    with random write indices (the wrapper's entry), lines back to rings
    with a shift per line (its exit), and rings to rings: exact against
    the plain gather (and transpose).  ``f64``: K9's f64 build on f64
    rings."""
    from srack_tpu_torch.ops.ring_roll import ring_align_for, ring_align_plain
    lens, rings, idx = _ring_inputs(stt, f64)
    RING_ALIGN = ring_align_for(rings[0].dtype)
    lines = ring_to_lines(rings, lens, idx)
    for j, (line, r) in enumerate(zip(lines, rings)):
        check(torch.equal(line, ring_align_plain(r, idx[j]).T),
              f"K9 rings -> lines differs from its plain version, line {j}")
    shifts = [int(s) for s in np.random.default_rng(2).integers(0, 5000, 24)]
    back = [torch.empty_like(r) for r in rings]
    RING_ALIGN.move(lines, back, lens, VOICES, shifts=shifts, src_lines=True)
    for j, (b, line, s) in enumerate(zip(back, lines, shifts)):
        check(torch.equal(b, ring_align_plain(
            line.T, torch.full((VOICES,), s, device="cuda"))),
            f"K9 lines -> rings differs from its plain version, line {j}")
    RING_ALIGN.move(rings, back, lens, VOICES, idx=idx)
    for j, (b, r) in enumerate(zip(back, rings)):
        check(torch.equal(b, ring_align_plain(r, idx[j])),
              f"K9 rings -> rings differs from its plain version, line {j}")
    log(f"[3 compare] {RING_ALIGN.name}: 24 lines x {VOICES} voices, "
        f"lengths {min(lens)}..{max(lens)}, {rings[0].dtype}, rings -> "
        f"lines, lines -> rings, rings -> rings: exact")
    return 0.0


def _freeverb_inputs(stt, n, automated, seed, exact=False):
    from srack_tpu_torch.modules import freeverb as fv
    cfg = stt.AudioConfig(sample_rate=SR, channels=2,
                          precision="exact" if exact else "fast")
    core = np.float64 if exact else np.float32
    rng = np.random.default_rng(seed)
    v = VOICES
    state = {}
    for k, length in zip(fv.LINE_KEYS, sum(fv.line_lengths(SR), ())):
        state[k] = (rng.standard_normal((v, length)) * 0.1).astype(core)
        state[f"{k}_idx"] = rng.integers(0, length, v).astype(np.int32)
    for k in fv.FS_KEYS:
        state[k] = (rng.standard_normal(v) * 0.1).astype(core)
    _, p0 = fv.FREEVERB.make(cfg, room_size=0.7, dampening=0.4, wet=0.3,
                             dry=0.2)
    params = {k: a.expand(v).clone().numpy() for k, a in p0.items()}
    params["room_size"] = rng.uniform(0.3, 0.9, v).astype(np.float32)
    if automated:
        params["room_size"] = rng.uniform(0.3, 0.9, (v, n)).astype(
            np.float32)
        params["wet"] = rng.uniform(0.1, 0.5, (v, n)).astype(np.float32)
    lanes = [(rng.standard_normal((v, n)) * 0.3).astype(np.float32)
             for _ in range(2)]

    def dev(tree):
        return {k: torch.from_numpy(a).cuda() for k, a in tree.items()}
    return (cfg, fv.block_gains(dev(params), v, F64 if exact else
                                torch.float32), dev(state),
            *[torch.from_numpy(a).cuda() for a in lanes])


def compare_freeverb(stt, n, automated, exact=False):
    """K8 through its wrapper (K9 on entry and exit; at 48 kHz the
    shared-memory entry, not the twin) against the chunked plain version,
    from random rings with non-zero write indices and random filter
    states: audio, final filter states and lines (both in time order,
    write index 0) within 2e-5 (abs + rel).  ``exact``: the f64 core, on
    K8's and K9's f64 builds, against the f64 plain version."""
    from srack_tpu_torch.modules import freeverb as fv
    from srack_tpu_torch.ops import freeverb_kernel as fvk
    t0 = time.perf_counter()
    cfg, gains, state, l_in, r_in = _freeverb_inputs(stt, n, automated, n,
                                                     exact)
    tiled, twin = ((fvk.FREEVERB_F64, fvk.FREEVERB_TWIN_F64) if exact
                   else (fvk.FREEVERB, fvk.FREEVERB_TWIN))
    launched = (tiled.launches, twin.launches)
    st_k, outs_k = fvk.render(cfg, l_in, r_in, False, gains, state, n)
    check((tiled.launches - launched[0],
           twin.launches - launched[1]) == (1, 0),
          "K8's wrapper did not launch the shared-memory entry once")
    torch.cuda.synchronize()
    st_p, outs_p = fv.block_plain(l_in, r_in, gains, state, n)
    torch.cuda.synchronize()
    err = 0.0
    pairs = list(zip(outs_k, outs_p)) + [(st_k[k], st_p[k]) for k in st_p]
    for g, w in pairs:
        if w.dtype == torch.int32:
            check(torch.equal(g, w), "K8: write indices differ")
            continue
        d = (g - w).abs()
        check(bool((d <= FV_TOL + FV_TOL * w.abs()).all()),
              f"K8 n={n}: off by {d.max().item()}")
        err = max(err, d.max().item())
    log(f"[3 compare] {tiled.name} V={VOICES} n={n}"
        f"{' automated room_size and wet' if automated else ''}: max abs "
        f"err {err:.3e} (audio, 16 filter states, 24 lines); "
        f"{time.perf_counter() - t0:.1f} s")
    return err


def _canonical(stt, compiled, state):
    """A state with every Freeverb ring in time order (write index 0), so
    that the scan engine's rings and the block engine's compare."""
    from srack_tpu_torch.modules.freeverb import LINE_KEYS
    from srack_tpu_torch.ops.ring_roll import ring_align_plain
    out = {"states": {}, "fb": state["fb"]}
    for mid, sd in state["states"].items():
        sd = dict(sd)
        if compiled.instances[mid][0].type_name == "Freeverb":
            for k in LINE_KEYS:
                sd[k] = ring_align_plain(sd[k], sd[f"{k}_idx"])
                sd[f"{k}_idx"] = torch.zeros_like(sd[f"{k}_idx"])
        out["states"][mid] = sd
    return out


def compare_block_engine(stt, name, n, voices):
    """The whole block engine (K3, K8, K9 and, for block_check_patch, K4)
    against the scan engine on the card, from a random state: audio within
    5e-6; a render in two halves with the state carried equals one render
    within 5e-6 (tests/test_block_engine.py's continuity check); the
    final states agree (rings in time order): int32/bool exact but the
    Sync edge state of an oscillator whose Sync is unconnected (the step
    writes False, the block form keeps it; it is never read), the float
    phase shadow pos_g within rtol 1e-4 (an f32 sum in another order), other
    float state within 1e-5."""
    t0 = time.perf_counter()
    patch, compiled = block_cases(stt)[name]
    params = _cuda(stt, stt.presets.farm_params(patch, voices))
    state = _random_state(stt, compiled, voices, 7)
    audio_b, _, final_b = compiled.render(n, params=params, state=state,
                                          batched=True, engine="block",
                                          device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        audio_s, final_s = compiled.render_scan(params, state, n,
                                                batched=True, nograd=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(bool(torch.isfinite(audio_s).all()), f"{name}: scan not finite")
    err = (audio_b - audio_s).abs().max().item()
    check(err <= BLOCK_ATOL, f"{name} block vs scan: audio off by {err}")
    half = n // 2
    a1, _, s1 = compiled.render(half, params=params, state=state,
                                batched=True, engine="block", device="cuda")
    a2, _, _ = compiled.render(n - half, params=params, state=s1,
                               batched=True, engine="block", device="cuda")
    cont = (torch.cat([a1, a2], dim=-1) - audio_b).abs().max().item()
    check(cont <= BLOCK_ATOL, f"{name}: halves off one render by {cont}")
    got, want = (_canonical(stt, compiled, final_b),
                 _canonical(stt, compiled, final_s))
    serr = 0.0
    for mid, sd in want["states"].items():
        mdef, _, inputs = compiled.instances[mid]
        for k, w in sd.items():
            g = got["states"][mid][k]
            where = f"{name} state {mid}.{k}"
            check(g.shape == w.shape and g.dtype == w.dtype, where)
            if w.dtype in (torch.int32, torch.bool):
                if k == "sync_last" and inputs[1] is None:
                    continue
                check(torch.equal(g, w), f"{where}: not exact")
            elif k == "pos_g":
                d = (g - w).abs()
                check(bool((d <= 1e-4 * w.abs() + 1e-6).all()),
                      f"{where}: off by {d.max().item()}")
            else:
                d = (g - w).abs().max().item() if w.numel() else 0.0
                check(d <= ATOL, f"{where}: off by {d}")
                serr = max(serr, d)
    log(f"[3 compare] {name} block engine vs scan engine V={voices} n={n}: "
        f"max |audio| err {err:.3e} (bit-exact: "
        f"{torch.equal(audio_b, audio_s)}), halves vs one render "
        f"{cont:.3e}, max float-state err {serr:.3e} (pos_g within rtol "
        f"1e-4); block {t1 - t0:.1f} s, scan {t2 - t1:.1f} s, "
        f"{time.perf_counter() - t0:.1f} s in all")
    return err


def phase_compare_block(stt):
    """Phase 3 for the slice's kernels; returns the largest error of each
    and what the timing needs."""
    errs = {}
    # slice 3b's stages at n = 1,024 only: their 4,800 Hz twins run again
    # in phase 3's block-vs-scan checks
    errs["serial_stage"] = max(
        compare_stage(stt, name, n) for name in STAGES
        for n in (PLAIN_NS[:1] if name in KIT_NAMES else PLAIN_NS))
    errs["row_scan"], scan_x = compare_scans()
    errs["ring_align"] = compare_ring(stt)
    errs["freeverb"] = max(compare_freeverb(stt, n, automated)
                           for n in CHECK_NS for automated in (False, True))
    for name in ("reverb_patch", "block_check_patch"):
        compare_block_engine(stt, name, PLAIN_NS[0], VOICES)
    return errs, scan_x


def stage_bound(compiled, kernel, v, n):
    """K3's bound for one run: params and state in, state out, input and
    output wires; the stage modules' f32 operations."""
    lay = kernel.layout
    rows = lay.n_pf + lay.n_pi + 2 * (lay.n_sf + lay.n_si)
    wires = len(kernel.lanes) + len(kernel.program.stage_out)
    nbytes = 4 * v * (rows + wires * n)
    ops = sum(module_ops(compiled, m) for m in kernel.program.stage_plan) \
        * v * n
    return _bound(nbytes, ops)


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, nbytes, ops


def freeverb_bound(lens, v, n, lanes_in, lanes_out):
    """K8's bound for one render: its input and output lanes, the lines
    and filter states in and out, once each; FV_OPS per voice-sample."""
    nbytes = 4 * v * ((lanes_in + lanes_out) * n + 2 * (sum(lens) + 16))
    return _bound(nbytes, FV_OPS * v * n)


def k8_call(cfg, l_in, r_in, gains, fs, lines, n, skip_r=False):
    """The launch of the K8 entry the wrapper picks, with its operands made
    once, for timing the kernel without the wrapper's per-call host work.
    Returns ``(call, keep)``: ``keep`` holds the tensors the launch points
    into."""
    from srack_tpu_torch.ops import freeverb_kernel as fvk
    lens = fvk.all_lengths(cfg)
    kernel = fvk.kernel_for(lens, fs.dtype)
    tables = fvk.line_tables(lens, fs.device)
    args, argtypes, keep, _, _ = kernel.entry_args(
        cfg, l_in, r_in, gains, fs, lines, n, skip_r, tables)
    return (lambda: kernel.launch(kernel.entry, argtypes, args, fs.device),
            keep)


def block_times(stt, scan_x):
    """The slice's kernels and their plain versions (and, where one
    PyTorch call computes the same function, that call) at phase 3's
    shapes."""
    from srack_tpu_torch.modules import freeverb as fv
    from srack_tpu_torch.ops import basic, freeverb_kernel as fvk
    from srack_tpu_torch.ops.ring_roll import RING_ALIGN, ring_align_plain
    from srack_tpu_torch.ops.scan_kernel import ROW_SCAN
    out = {}
    n = CHECK_NS[0]
    name = "reverb_patch"
    prog, params, stage_state, lanes, plain_params = _stage_inputs(
        stt, name, n, n)
    kernel = STAGES[name]
    k_ms = cuda_ms(lambda: kernel.run(params, stage_state, lanes, n),
                   repeats=20)
    with torch.no_grad():
        p_ms = cuda_ms(lambda: prog.stage_plain(plain_params, stage_state,
                                                lanes, n))
    out["serial_stage"] = (k_ms, p_ms, None,
                           stage_bound(prog.compiled, kernel, VOICES, n),
                           f"{name} stage V={VOICES} n={n}")
    xf = scan_x["xf"]
    out["row_scan"] = (
        cuda_ms(lambda: ROW_SCAN.run("sum", (xf,)), repeats=20, warmup=1),
        cuda_ms(lambda: basic.cumsum_plain(xf), repeats=3),
        cuda_ms(lambda: torch.cumsum(xf, dim=-1), repeats=20),
        _bound(8 * xf.numel(), xf.numel()),
        f"f32 sum [{SCAN_ROWS}, {SCAN_N}] (library: torch.cumsum)")
    lens, rings, idx = _ring_inputs(stt)
    # out[i, v] = ring[v, (idx[v] + i) % L]: one gather of the transposed
    # ring per line
    gidx = [((idx[j].to(torch.int64)
              + torch.arange(length, device="cuda").unsqueeze(-1)) % length)
            for j, length in enumerate(lens)]
    lines = [torch.empty((n, VOICES), device="cuda") for n in lens]
    out["ring_align"] = (
        cuda_ms(k9_call(RING_ALIGN, rings, lines, lens, VOICES, idx=idx,
                        dst_lines=True), repeats=20, warmup=1),
        cuda_ms(lambda: [ring_align_plain(r, idx[j]).T.contiguous()
                         for j, r in enumerate(rings)], repeats=5),
        cuda_ms(lambda: [torch.gather(r.T, 0, g)
                         for r, g in zip(rings, gidx)], repeats=20),
        _bound(8 * VOICES * sum(lens) + 4 * idx.numel(), 0),
        f"24 lines x {VOICES} voices, rings -> lines, the launch alone "
        f"(library: torch.gather)")
    del lines
    cfg, gains, state, l_in, r_in = _freeverb_inputs(stt, n, False, n)
    lines = torch.cat([state[k].T for k in fv.LINE_KEYS]).contiguous()
    fs = torch.stack([state[k] for k in fv.FS_KEYS], dim=1).contiguous()
    call, keep = k8_call(cfg, l_in, r_in, gains, fs, lines, n)
    launch_ms = cuda_ms(call, repeats=20, warmup=1)
    # the wrapper and the plain version do the same work: both take the
    # rings with their write indices and return them in time order
    out["freeverb"] = (
        cuda_ms(lambda: fvk.render(cfg, l_in, r_in, False, gains, state,
                                   n), repeats=20, warmup=1),
        cuda_ms(lambda: fv.block_plain(l_in, r_in, gains, state, n),
                repeats=3),
        None, freeverb_bound(lens, VOICES, n, 2, 2),
        f"V={VOICES} n={n}, stereo in, the wrapper (K9 in, K8, K9 out)")
    log(f"[6 plain] freeverb V={VOICES} n={n}: K8's launch alone "
        f"{launch_ms:.3f} ms, the wrapper {out['freeverb'][0]:.3f} ms")
    return out, launch_ms


def _split(stt, name, patch, params, n, automation, total_ms, card):
    """Each kernel of one full-width block render timed alone at its
    shapes there: K3 on the stage, K9 (one launch, the wrapper makes two),
    K8, and the rest (block phases, transposes, the wrapper) as the
    difference."""
    from srack_tpu_torch.block_engine import wire_key
    from srack_tpu_torch.modules import freeverb as fv
    from srack_tpu_torch.ops.freeverb_kernel import all_lengths
    compiled = block_cases(stt)[name][1]
    prog = compiled.block_program()
    kernel = STAGES[name]
    p = _cuda(stt, params)
    state = _cuda(stt, stt.compiler.tree_map(
        lambda a: a.expand((VOICES,) + a.shape).contiguous(),
        compiled.init_state()))
    stage_state = {"states": {m: state["states"][m]
                              for m in prog.stage_plan}, "fb": state["fb"]}
    lanes = {wire_key(w): torch.zeros((VOICES, n), device="cuda")
             for w in prog.stage_in}
    k3_ms = cuda_ms(lambda: kernel.run(p, stage_state, lanes, n), warmup=1)
    lanes.clear()
    verb = next(m for m in compiled.plan
                if compiled.instances[m][0].type_name == "Freeverb")
    lens = all_lengths(compiled.cfg)
    sd = state["states"][verb]
    rings = [sd[k] for k in fv.LINE_KEYS]
    idx = torch.zeros((24, VOICES), dtype=torch.int32, device="cuda")
    from srack_tpu_torch.ops.ring_roll import RING_ALIGN
    rows = [torch.empty((x, VOICES), device="cuda") for x in lens]
    k9_ms = cuda_ms(k9_call(RING_ALIGN, rings, rows, lens, VOICES, idx=idx,
                            dst_lines=True), repeats=20, warmup=1)
    del rows
    pv = dict(p[verb])
    for (mid, pname), lane in (automation or {}).items():
        pv[pname] = lane
    gains = fv.block_gains(pv, VOICES)
    lines = torch.cat(ring_to_lines(rings, lens, idx))
    fs = torch.stack([sd[k] for k in fv.FS_KEYS], dim=1).contiguous()
    lane = torch.zeros((VOICES, n), device="cuda")
    call, keep = k8_call(compiled.cfg, lane, lane, gains, fs, lines, n,
                         not prog._outs_used.get(verb, (True, True))[1])
    k8_ms = cuda_ms(call, warmup=1)
    del lane, lines, call, keep
    torch.cuda.empty_cache()
    out = {"serial_stage": k3_ms, "ring_align": k9_ms, "freeverb": k8_ms}
    # K8 reads one lane in both patches (reverb_patch is mono in: the VCA
    # feeds Left and Right) and writes one or two
    right = 2 if prog._outs_used.get(verb, (True, True))[1] else 1
    bounds = {"serial_stage": stage_bound(compiled, kernel, VOICES, n),
              "ring_align": _bound(8 * VOICES * sum(lens) + 4 * 24 * VOICES,
                                   0),
              "freeverb": freeverb_bound(lens, VOICES, n, 1, right)}
    if name == "block_check_patch":
        from srack_tpu_torch.ops.scan_kernel import ROW_SCAN
        x = torch.ones((VOICES, n), dtype=torch.int32, device="cuda")
        out["row_scan"] = cuda_ms(lambda: ROW_SCAN.run("sum", (x,)),
                                  warmup=1)
        bounds["row_scan"] = _bound(8 * x.numel(), x.numel())
        del x
        torch.cuda.empty_cache()
    for k, (b_ms, b_by, nbytes, ops) in bounds.items():
        log(f"[bound] {k} in {name} V={VOICES} n={n}: {nbytes} bytes, {ops} "
            f"f32 operations -> {b_ms:.4f} ms ({b_by}); alone it takes "
            f"{out[k]:.3f} ms, {out[k] / b_ms:.1f}x its bound")
    rest = total_ms - k3_ms - 2 * k9_ms - k8_ms
    log(f"[split] {name} V={VOICES} n={n}: K3 {k3_ms:.3f} ms, K9 "
        f"{k9_ms:.3f} ms x 2, K8 {k8_ms:.3f} ms, the rest (block phases, "
        f"K4, transposes, wrappers) {rest:.3f} ms of {total_ms:.3f} "
        + (f"(K4 alone: {out['row_scan']:.3f} ms per i32 sum over [{VOICES}, "
           f"{n}]) " if "row_scan" in out else "")
        + f"[{card}]")


def k8_wrapper_split(render, name, card) -> dict:
    """K8's wrapper on the very arguments a full-width render gives it
    (caught at the wrapper, the render ended there), timed apart: the
    lanes as K8 takes them (``FreeverbKernel.lanes``: views read in place,
    a copy only of a lane not in f32), the allocations and stacks of
    the lines, rings, write indices and filter states, K9 into the lines,
    K8's launch, K9 back into rings, and the rest of the wrapper as the
    difference from the whole wrapper's time.  The mix pass is inside K8's
    launch (fused)."""
    from srack_tpu_torch.modules.freeverb import FS_KEYS, LINE_KEYS
    from srack_tpu_torch.ops import freeverb_kernel as fvk
    from srack_tpu_torch.ops.ring_roll import RING_ALIGN
    keep = {}
    with captured(fvk, "render", keep):
        render()
    check("args" in keep, f"the {name} render did not reach K8's wrapper")
    args, kwargs = keep["args"], keep["kwargs"]
    cfg, l_in, r_in, mono, gains, state, n = args
    skip_r = kwargs.get("skip_r", False)
    lens = fvk.all_lengths(cfg)
    v = state["cl0"].shape[0]
    kernel = fvk.kernel_for(lens, state["cl0"].dtype)

    def lanes():
        return kernel.lanes(l_in, l_in if mono else r_in, v, n)

    def allocs():
        return (torch.empty((sum(lens), v), device="cuda"),
                torch.empty(v * sum(lens), device="cuda"),
                torch.stack([state[f"{k}_idx"] for k in LINE_KEYS]).to(
                    torch.int32).contiguous(),
                torch.stack([state[k] for k in FS_KEYS], dim=1).contiguous())
    ms = {"lanes": cuda_ms(lanes, warmup=1),
          "allocations": cuda_ms(allocs, warmup=1)}
    left, right = lanes()
    lines, flat, idx, fs = allocs()
    rows = torch.split(lines, list(lens))
    rings_in = [state[k].contiguous() for k in LINE_KEYS]
    ms["K9 in"] = cuda_ms(lambda: RING_ALIGN.move(
        rings_in, rows, lens, v, idx=idx, dst_lines=True), warmup=1)
    call, k8_keep = k8_call(cfg, left, right, gains, fs, lines, n, skip_r)
    ms["K8"] = cuda_ms(call, warmup=1)
    rings = [b.view(v, length) for b, length in zip(
        torch.split(flat, [v * x for x in lens]), lens)]
    ms["K9 out"] = cuda_ms(lambda: RING_ALIGN.move(
        rows, rings, lens, v, shifts=[n % x for x in lens], src_lines=True),
        warmup=1)
    total = cuda_ms(lambda: fvk.render(*args, **kwargs), warmup=1)
    ms["rest"] = total - sum(ms.values())
    log(f"[split] K8's wrapper in {name} V={v} n={n}: "
        + ", ".join(f"{k} {t:.3f} ms" for k, t in ms.items())
        + f" of {total:.3f} ms (the mix pass is fused into K8) [{card}]")
    del keep, args, kwargs, k8_keep, left, right, lines, flat, rings
    torch.cuda.empty_cache()
    return {"wrapper_ms": total, **{f"{k}_ms": t for k, t in ms.items()}}


def _held(pairs, tol, what) -> float:
    """Kernel results against their plain versions: int32 and bool exact,
    floats within ``tol`` abs + ``tol`` rel (``tol`` 0: exact); ``pairs``
    of ``(got, want, where)``, ``where`` a bool mask of the elements that
    are defined or None.  Returns the largest float difference."""
    worst = 0.0
    for got, want, where in pairs:
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{what}: {tuple(got.shape)} {got.dtype} vs "
              f"{tuple(want.shape)} {want.dtype}")
        if where is not None:
            got = torch.where(where, got, torch.zeros_like(got))
            want = torch.where(where, want, torch.zeros_like(want))
        if tol == 0 or not want.dtype.is_floating_point:
            check(torch.equal(got, want), f"{what}: not exact")
            continue
        d = (got - want).abs()
        bad = (d > tol + tol * want.abs()).sum().item()
        check(bad == 0, f"{what}: {bad} elements off, the largest by "
              f"{d.max().item()}")
        worst = max(worst, d.max().item())
        del d
    return worst


HELD_ROWS = 256     # rows per slice of the unfused Sample form's check
HELD_CALLS = {}     # kernel -> the inputs of its calls in the last warm-up
NOISE_REC = {}      # the Noise-lane kernel at the drums render's shape


def sample_words(args) -> int:
    """The table words one K7 call must read: the distinct frames its
    voices read (index 0 where a voice has stopped), none where a length
    is 0.  The unfused form computes them when its table is each row's
    frame numbers; in slices of ``HELD_ROWS`` rows."""
    from srack_tpu_torch.modules.sample import play_unfused
    gate, cv, table = args[:3]
    rows, k = table.shape
    frames = torch.arange(k, dtype=torch.float32, device=table.device)
    words = 0
    for r0 in range(0, rows, HELD_ROWS):
        sl = slice(r0, r0 + HELD_ROWS)
        sub = [None if a is None else a[sl] for a in args]
        sub[2] = frames.expand(sub[0].shape[0], k)
        idx = play_unfused(*sub)[0].to(torch.int64)
        live = (args[7][sl] > 0).unsqueeze(-1)
        rowbase = torch.arange(idx.shape[0], device=idx.device).unsqueeze(-1)
        keys = torch.where(live, rowbase * k + idx, -1)
        uniq = torch.unique(keys)
        words += int((uniq >= 0).sum())
        del idx, keys, uniq
    return words


def sample_bound(args, words):
    """K7's bound for one call: gate (and CV) in and audio out once, the
    table words its voices read; bytes."""
    gate, cv = args[:2]
    return _bound(4 * gate.numel() * (3 if cv is not None else 2)
                  + 4 * words + 4 * 6 * gate.shape[0], 0)


def noise_bound(rows, n):
    """The Noise-lane kernel's bound: the keys in and the f32 lanes out
    once; its integer operations (``INT_OPS`` an element) at the f32 rate,
    the table's only 32-bit rate outside the tensor cores (Hopper's INT32
    units issue at half of it, so the true bound is no lower)."""
    from srack_tpu_torch.ops.noise_kernel import INT_OPS
    return _bound(8 * rows + 4 * rows * n, INT_OPS * rows * n)


def gather_bound(table, idx):
    """K5's or K6's bound: the indices in and the outputs out once, and the
    distinct table words these indices read, once; bytes."""
    rows, k = table.shape
    words = 0
    for r0 in range(0, rows, 64):
        j = idx[r0:r0 + 64].to(torch.int64)
        j = torch.clamp(j & (2 ** (k - 1).bit_length() - 1), max=k - 1)
        rowbase = torch.arange(j.shape[0], device=j.device).unsqueeze(-1)
        words += torch.unique(rowbase * k + j).numel()
        del j
    return _bound(8 * idx.numel() + 4 * words, 0)


@contextlib.contextmanager
def held_against_plain(found: dict):
    """While open, each call of K8's wrapper, of K4's two entries (and
    their f64 build's), of K7 and of K5 also runs its plain version on the
    very inputs the main path gave it and holds its result to it: K8
    (block_plain, in the core's dtype: f32, or f64 in exact precision)
    audio, filter states and lines (so also the K9 moves around it) within
    2e-5 abs + rel, write indices exact; K4 (the log-doubling forms) int32
    sums, maxes and fills exact (fills where a value is defined), f32 sum
    within 2e-4 and affine within 3e-4 abs + rel, f64 sum within 1e-12 abs
    + rel, f64 max and fill exact; K7 bit-exact against its unfused form
    (K4's scans and the row gather K6), in slices of HELD_ROWS rows; K5
    exact against torch.gather; the Noise-lane kernel bit-exact against
    its plain version (int64 words).  ``found[kernel]`` gathers ``(what,
    shape, max abs err, plain s)``, under the name of the build that
    launched; ``HELD_CALLS`` keeps the K7, K5 and Noise-lane calls' inputs
    for timing them alone."""
    from srack_tpu_torch.modules import freeverb as fv
    from srack_tpu_torch.modules.sample import play_unfused
    from srack_tpu_torch.ops import basic, freeverb_kernel as fvk
    from srack_tpu_torch.ops.gather_kernel import ROW_GATHER
    from srack_tpu_torch.ops.noise_kernel import (NOISE_LANES,
                                                  noise_lanes_plain)
    from srack_tpu_torch.ops.sample_kernel import SAMPLE_PLAY
    from srack_tpu_torch.ops.scan_kernel import ROW_SCAN, ROW_SCAN_F64
    HELD_CALLS.clear()

    def render(cfg, l_in, r_in, mono, gains, state, n, skip_r=False):
        new_state, outs = k8_render(cfg, l_in, r_in, mono, gains, state,
                                    n, skip_r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, device = state["cl0"].shape[0], state["cl0"].device
        left = basic.block_lane(l_in, v, n, device=device)
        right = left if mono else basic.block_lane(r_in, v, n, device=device)
        want_state, want = fv.block_plain(left, right, gains, state, n)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        pairs = [(outs[0], want[0], None)]
        if not skip_r:
            pairs.append((outs[1], want[1], None))
        pairs += [(new_state[k], w, None) for k, w in want_state.items()]
        core = state["cl0"].dtype
        err = _held(pairs, FV_TOL, f"K8 {str(core)[6:]} at [{v}, {n}]")
        found.setdefault(fvk.kernel_for(fvk.all_lengths(cfg), core).name,
                         []).append(
            (f"audio, 16 filter states, 24 lines against block_plain "
             f"({str(core)[6:]} core)", (v, n), err, secs))
        return new_state, outs

    def held_run(lib, scan_run):
        def run(kind, arrs):
            got = scan_run(kind, arrs)
            t0 = time.perf_counter()
            if kind == "affine":
                want = basic.affine_scan_plain(*arrs)
            else:
                want = ((basic.cumsum_plain if kind == "sum"
                         else basic.cummax_plain)(arrs[0]),)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            dtype = arrs[0].dtype
            tol = (0 if kind == "max" or dtype == torch.int32
                   else F64_SUM_TOL if dtype == torch.float64
                   else SCAN_TOL[kind])
            what = (f"{kind} {str(dtype)[6:]} against the log-doubling "
                    f"form")
            err = _held([(g, w, None) for g, w in zip(got, want)], tol,
                        f"K4 {what}")
            found.setdefault(lib.name, []).append(
                (what, tuple(arrs[0].shape), err, secs))
            return got
        return run

    def fill(values, mask):
        got, ok = scan_fill(values, mask)
        t0 = time.perf_counter()
        want, want_ok = basic.forward_fill_multi_plain(tuple(values), mask)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        what = (f"fill {str(values[0].dtype)[6:]} x{len(values)} against the "
                f"log-doubling form")
        _held([(ok, want_ok, None)] + [(g, w, ok) for g, w in zip(got, want)],
              0, f"K4 {what}")
        for name in {"row_scan_f64" if x.dtype == torch.float64
                     else "row_scan" for x in values}:
            found.setdefault(name, []).append(
                (what, tuple(mask.shape), 0.0, secs))
        return got, ok

    def play(*args):
        got = play_run(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows, n = args[0].shape
        for r0 in range(0, rows, HELD_ROWS):
            sl = slice(r0, r0 + HELD_ROWS)
            want = play_unfused(*[None if a is None else a[sl]
                                  for a in args])
            _held([(g[sl], w, None) for g, w in zip(got, want)], 0,
                  f"K7 at [{rows}, {n}] rows {r0}..")
            del want
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        words = sample_words(args)
        cv = "CV connected" if args[1] is not None else "constant rate"
        found.setdefault("sample_play", []).append(
            (f"{cv}, K = {args[2].shape[1]} ({words} table words read) "
             f"against its unfused form (K4, K6)", (rows, n), 0.0, secs))
        HELD_CALLS.setdefault("sample_play", []).append((args, words))
        return got

    def gather(table, idx):
        got = gather_run(table, idx)
        t0 = time.perf_counter()
        want = basic.table_lookup_rows_plain(table, idx)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _held([(got, want, None)], 0, f"K5 at {list(idx.shape)}")
        found.setdefault("row_gather", []).append(
            (f"{str(table.dtype)[6:]} K = {table.shape[1]} against "
             f"torch.gather", tuple(idx.shape), 0.0, secs))
        HELD_CALLS.setdefault("row_gather", []).append((table, idx))
        return got

    def noise(keys, n):
        got = noise_run(keys, n)
        t0 = time.perf_counter()
        want = noise_lanes_plain(keys, n)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _held([(got, want, None)], 0, f"Noise lanes at {list(got.shape)}")
        del want
        found.setdefault("noise_lanes", []).append(
            ("against its plain version (int64 words)", tuple(got.shape),
             0.0, secs))
        HELD_CALLS.setdefault("noise_lanes", []).append((keys.clone(), n))
        return got

    k8_render = fvk.render
    scan_fill = ROW_SCAN.fill
    play_run, gather_run = SAMPLE_PLAY.run, ROW_GATHER.run
    noise_run = NOISE_LANES.run
    fvk.render, ROW_SCAN.fill = render, fill
    for lib in (ROW_SCAN, ROW_SCAN_F64):
        lib.run = held_run(lib, lib.run)
    SAMPLE_PLAY.run, ROW_GATHER.run, NOISE_LANES.run = play, gather, noise
    try:
        yield found
    finally:
        fvk.render = k8_render
        del ROW_SCAN.run, ROW_SCAN.fill, ROW_SCAN_F64.run
        del SAMPLE_PLAY.run, ROW_GATHER.run, NOISE_LANES.run


def _log_held(phase, found, card) -> dict:
    """Log what :func:`held_against_plain` found; returns the largest error
    of each kernel."""
    errs = {}
    for name, rows in found.items():
        merged = {}   # calls of one kind at one shape: one line
        for what, shape, err, secs in rows:
            count, worst, total = merged.get((what, shape), (0, 0.0, 0.0))
            merged[(what, shape)] = (count + 1, max(worst, err),
                                     total + secs)
        for (what, shape), (count, err, secs) in merged.items():
            calls = f" ({count} calls)" if count > 1 else ""
            log(f"[{phase}] {name} {what} at the main path's shape "
                f"{list(shape)}{calls}: max abs err {err:.3e} (plain "
                f"version {secs:.1f} s) [{card}]")
            errs[name] = max(errs.get(name, 0.0), err)
    return errs


def phase_reverb(stt, kernels, card):
    """The slice's main path: reverb_patch, 1,024 voices x 10 s, stereo,
    through render_batch on the default device.  The warm-up render holds
    K8 against its plain version at the shapes it gets there."""
    patch = stt.presets.reverb_patch(stt.AudioConfig(sample_rate=SR,
                                                     channels=2))
    params = stt.presets.farm_params(patch, VOICES)
    found = {}
    audio, ms, launches = _timed_main(
        kernels, lambda: stt.render_batch(patch, HEADLINE_N, params=params),
        ("serial_stage", "freeverb", "ring_align"),
        held_against_plain(found), BLOCK_RENDERS)
    renders = ", ".join(f"{x:.3f}" for x in RENDER_MS)
    check("freeverb" in found, "the reverb render did not call K8's wrapper")
    held = _log_held("9 reverb", found, card)
    check(audio.device.type == "cuda", "render_batch did not default to "
          "the card")
    peak = _check_audio(audio, (VOICES, 2, HEADLINE_N), "reverb")
    del audio
    torch.cuda.empty_cache()
    rate = VOICES * HEADLINE_N / (ms / 1e3)
    _split(stt, "reverb_patch", patch, params, HEADLINE_N, None, ms, card)
    K8_WRAPPER["reverb"] = k8_wrapper_split(
        lambda: stt.render_batch(patch, HEADLINE_N, params=params),
        "reverb_patch", card)
    log(f"[9 reverb] reverb_patch V={VOICES} n={HEADLINE_N} stereo via "
        f"render_batch -> block engine, launches {launches} per render; "
        f"{ms:.3f} ms/render (the median of {renders}), {rate / 1e9:.4f} G "
        f"samples/s, aggregate real-time {rate / SR:.0f}x, peak "
        f"{peak:.5f} [{card}]")
    return launches, held


def block_check_automation(stt, patch, n, seed=3):
    """block_check_patch's automation lanes on the card: room_size in
    [0.5, 0.8] and wet in [0.05, 0.15], per voice and sample."""
    rng = np.random.default_rng(seed)
    verb = next(i.id for i in patch if i.name == "verb")
    return {(verb, "room_size"): torch.from_numpy(rng.uniform(
                0.5, 0.8, (VOICES, n)).astype(np.float32)).cuda(),
            (verb, "wet"): torch.from_numpy(rng.uniform(
                0.05, 0.15, (VOICES, n)).astype(np.float32)).cuda()}


def phase_block_check(stt, kernels, card):
    """block_check_patch (mono), 1,024 voices x 10 s, with its two
    automation lanes, through render_batch on the default device.  The
    warm-up render holds K8 and K4 against their plain versions at the
    shapes they get there."""
    patch, _ = stt.presets.block_check_patch(
        stt.AudioConfig(sample_rate=SR, channels=1))
    params = stt.presets.farm_params(patch, VOICES)
    automation = block_check_automation(stt, patch, HEADLINE_N)
    found = {}
    audio, ms, launches = _timed_main(
        kernels, lambda: stt.render_batch(patch, HEADLINE_N, params=params,
                                          automation=automation),
        ("row_scan", "serial_stage", "freeverb", "ring_align"),
        held_against_plain(found), BLOCK_RENDERS)
    renders = ", ".join(f"{x:.3f}" for x in RENDER_MS)
    check(set(found) == {"freeverb", "row_scan"},
          f"the block check render called the wrappers of {sorted(found)}")
    held = _log_held("10 block check", found, card)
    peak = _check_audio(audio, (VOICES, 1, HEADLINE_N), "block check")
    del audio
    torch.cuda.empty_cache()
    rate = VOICES * HEADLINE_N / (ms / 1e3)
    _split(stt, "block_check_patch", patch, params, HEADLINE_N, automation,
           ms, card)
    K8_WRAPPER["block check"] = k8_wrapper_split(
        lambda: stt.render_batch(patch, HEADLINE_N, params=params,
                                 automation=automation),
        "block_check_patch", card)
    log(f"[10 block check] block_check_patch V={VOICES} n={HEADLINE_N} "
        f"mono, 2 automation lanes, via render_batch -> block engine, "
        f"launches {launches} per render; {ms:.3f} ms/render (the median of "
        f"{renders}), {rate / 1e9:.4f} G samples/s, peak {peak:.5f} "
        f"[{card}]")
    return launches, held


# -- slice 3b: the Sample player (K7), the row gather (K5, K6), the
# sequencers' block forms and buffer mode ------------------------------------

KIT_NAMES = ("drum_machine", "sampler_kit", "kit_check_patch")
KIT_SR = 4800       # phase 3's block-vs-scan rate: ~8 clock steps in 2,048
KIT_BLOCK = 256     # buffer mode's block in phase 3
GATHER_N = 48000
GATHER_KS = (16, 64, 400, 1024)
GATHER_LONG_K = 48000
PLAY_KS = (400, 4000, 48000)
PLAY_FUZZ = 1e-3    # tests/test_sample_kernel.py:178-188
CHECK_STAGES = {}   # (case, mode) -> the K3 of phase 3's 4,800 Hz stage
_KIT_CHECK = {}


def kit_check_cases(stt) -> dict:
    """Phase 3's block-vs-scan patches at 4,800 Hz, mono, compiled once:
    the three kit patches in sample mode and feedback_patch and
    drum_machine in buffer mode (block 256)."""
    if not _KIT_CHECK:
        for name in KIT_NAMES:
            patch = getattr(stt.presets, name)(stt.AudioConfig(
                sample_rate=KIT_SR, channels=1))
            _KIT_CHECK[(name, "sample")] = (patch, stt.compile_patch(patch))
        for name in ("feedback_patch", "drum_machine"):
            patch = getattr(stt.presets, name)(stt.AudioConfig(
                sample_rate=KIT_SR, block_size=KIT_BLOCK, channels=1,
                buffer_feedback=True))
            _KIT_CHECK[(name, "buffer")] = (patch, stt.compile_patch(patch))
    return _KIT_CHECK


def _gather_idx(rng, kind, k, shape):
    rows, n = shape
    if kind == "ramp":     # monotone ramps with restarts, as a Sample reads
        restart = rng.uniform(size=shape) < 2e-4
        restart[:, 0] = True
        seg = np.maximum.accumulate(np.where(restart, np.arange(n), 0),
                                    axis=1)
        rate = rng.choice([0.5, 1.0, 1.5], rows)[:, None]
        idx = ((np.arange(n) - seg) * rate).astype(np.int64)
        idx += rng.integers(0, k, rows)[:, None]
        return (idx % k).astype(np.int32)
    if kind == "uniform":
        return rng.integers(0, k, shape).astype(np.int32)
    # some indices out of range, on either side: the select tree's answer
    return rng.integers(-k // 8 - 1, k + k // 8 + 1, shape).astype(np.int32)


def compare_gather():
    """K5 (small entry) for tables of 16, 64, 400 and 1,024 entries, f32
    and int32, indices partly out of range; K6 (long entry) for 48,000
    frames, monotone ramps with restarts and uniform random indices; at
    [1,024, 48,000]: exact against the plain gather."""
    from srack_tpu_torch.ops import basic
    from srack_tpu_torch.ops.gather_kernel import ROW_GATHER, ROW_GATHER_LONG
    t0 = time.perf_counter()
    rng = np.random.default_rng(21)
    shape = (VOICES, GATHER_N)
    keep = {}
    for k in GATHER_KS:
        idx = torch.from_numpy(_gather_idx(rng, "wide", k, shape)).cuda()
        for dt in (torch.float32, torch.int32):
            table = torch.from_numpy(rng.integers(-999, 999, (VOICES, k))
                                     .astype(np.int32)).to(dt).cuda()
            got = ROW_GATHER.run(table, idx)
            check(torch.equal(got, basic.table_lookup_rows_plain(table, idx)),
                  f"K5 K={k} {dt}: not exact")
        log(f"[3 compare] row_gather K={k} f32 and int32 {list(shape)}, "
            f"{(idx.ge(k) | idx.lt(0)).float().mean().item():.3f} of the "
            f"indices out of range: exact")
    table = torch.from_numpy(rng.standard_normal((VOICES, GATHER_LONG_K))
                             .astype(np.float32)).cuda()
    for kind in ("ramp", "uniform"):
        idx = torch.from_numpy(_gather_idx(rng, kind, GATHER_LONG_K,
                                           shape)).cuda()
        got = ROW_GATHER_LONG.run(table, idx)
        check(torch.equal(got, basic.table_lookup_rows_plain(table, idx)),
              f"K6 {kind}: not exact")
        keep[kind] = idx
        log(f"[3 compare] row_gather_long K={GATHER_LONG_K} {kind} indices "
            f"{list(shape)}: exact")
    small_table = torch.from_numpy(rng.standard_normal((VOICES, 16)).astype(
        np.float32)).cuda()
    small_idx = torch.from_numpy(_gather_idx(rng, "uniform", 16,
                                             shape)).cuda()
    log(f"[3 compare] row_gather: {time.perf_counter() - t0:.1f} s")
    return {"row_gather": (small_table, small_idx),
            "row_gather_long": (table, keep["ramp"])}


def _play_inputs(rng, k, n, mode):
    """K7's inputs for 1,024 voices: sparse random triggers, a random
    carried position (whole frames), playing and gate edge state, lengths
    from half the table to all of it (some 0); rates: base 1 (CV
    unconnected), base 0.5 with integer CVs, base 0.937 with CVs in
    [-0.1, 0.1)."""
    v = VOICES
    gate = (rng.uniform(size=(v, n)) < 1 / 300).astype(np.float32)
    cv, base = None, 1.0
    if mode == "int":
        cv, base = rng.integers(-1, 2, (v, n)).astype(np.float32), 0.5
    elif mode == "fuzz":
        cv = (rng.uniform(size=(v, n)) * 0.2 - 0.1).astype(np.float32)
        base = 0.937
    length = rng.integers(k // 2, k + 1, v).astype(np.int32)
    length[::97] = 0

    def dev(a):
        return torch.from_numpy(a).cuda()
    return (dev(gate), None if cv is None else dev(cv),
            dev(rng.standard_normal((v, k)).astype(np.float32)),
            torch.full((v,), base, device="cuda"),
            dev(rng.integers(0, k, v).astype(np.float32)),
            dev(rng.uniform(size=v) < 0.5), dev(rng.uniform(size=v) < 0.5),
            dev(length))


def compare_sample_play():
    """K7 at n = 2,048 and 2,047 for tables of 400, 4,000 and 48,000 frames,
    1,024 voices, CV unconnected, integer CVs and CVs in [-0.1, 0.1) at
    base 0.937: bit-exact against its unfused form on CUDA tensors (K4's
    scans and K6), which holds K7 to K4's order; against the plain version
    (log-doubling scans, torch.gather) exact at representable rates and,
    at base 0.937, at most 1e-3 of the samples off (a one-ulp position can
    pick the neighbouring frame) with the end position within rtol 1e-5.
    Returns the largest error against the plain version where it must be
    exact, and the inputs of the timing shape."""
    from srack_tpu_torch.modules.sample import play_unfused
    from srack_tpu_torch.ops.sample_kernel import SAMPLE_PLAY
    t0 = time.perf_counter()
    rng = np.random.default_rng(23)
    worst, timing = 0.0, None
    for k in PLAY_KS:
        for n in CHECK_NS:
            for mode in ("const", "int", "fuzz"):
                args = _play_inputs(rng, k, n, mode)
                got = SAMPLE_PLAY.run(*args)
                # the lanes as transposed views of [n, V] rows, as the
                # block engine's stage gives them
                views = tuple(None if a is None else a.T.contiguous().T
                              for a in args[:2])
                check(_same(SAMPLE_PLAY.run(*views, *args[2:]), got),
                      f"K7 K={k} n={n} {mode}: the transposed lanes give "
                      f"another result")
                del views
                unf = play_unfused(*args)
                for g, w, what in zip(got, unf, ("audio", "pos", "playing",
                                                 "gate_last")):
                    if not torch.equal(g, w):
                        bad = (g != w).sum().item()
                        check(False, f"K7 K={k} n={n} {mode}: {what} "
                              f"differs from the unfused form in {bad} "
                              f"places")
                plain = play_unfused(*args, plain=True)
                if mode == "fuzz":
                    miss = (got[0] != plain[0]).sum().item()
                    check(miss <= PLAY_FUZZ * got[0].numel(),
                          f"K7 K={k} n={n} fuzz: {miss} samples off")
                    # the end position is a difference of two prefix sums:
                    # its error scales with the sums, not with itself
                    scale = torch.maximum(plain[1].abs(), 1.2 * base_sum(
                        args))
                    err = (got[1] - plain[1]).abs()
                    rows_off = ((err > 1e-5 * scale)
                                | (got[2] != plain[2])).sum().item()
                    check(rows_off <= PLAY_FUZZ * VOICES + 1,
                          f"K7 K={k} n={n} fuzz: the end state of "
                          f"{rows_off} voices off")
                    check(torch.equal(got[3], plain[3]),
                          f"K7 K={k} n={n} fuzz: gate_last differs")
                    extra = (f", {miss} samples and {rows_off} voices' end "
                             f"state off the plain version (largest end "
                             f"position difference "
                             f"{(err / scale).max().item():.2e} of the "
                             f"row's rate sum)")
                else:
                    for g, w in zip(got, plain):
                        check(torch.equal(g, w), f"K7 K={k} n={n} {mode}: "
                              f"not exact against the plain version")
                    extra = ", exact against the plain version"
                played = (got[0] != 0).float().mean().item()
                log(f"[3 compare] sample_play K={k} n={n} {mode}: "
                    f"bit-exact against the unfused form (K4, K6), from "
                    f"[R, n] rows and transposed views alike{extra}; "
                    f"{played:.3f} of the samples sound")
                if k == GATHER_LONG_K and n == CHECK_NS[0] and \
                        mode == "const":
                    timing = args
    log(f"[3 compare] sample_play: {time.perf_counter() - t0:.1f} s")
    return worst, timing


def base_sum(args):
    """Each row's sum of rates over the call, the scale of its prefix
    sums: base * n * 2^max(cv)."""
    gate, cv, _, base = args[:4]
    n = gate.shape[1]
    peak = 1.0 if cv is None else torch.exp2(cv.max(dim=1).values)
    return base * n * peak


class SampleTriggers:
    """While open, counts the gate rising edges of every K7 call (its
    gate lane against its carried edge state)."""

    def __init__(self):
        self.edges = []

    def __enter__(self):
        from srack_tpu_torch.ops.sample_kernel import SAMPLE_PLAY
        run = SAMPLE_PLAY.run

        def counted(*args):
            gate, last = args[0], args[6]
            above = gate > 0
            prev = torch.cat([last.unsqueeze(-1), above[:, :-1]], dim=1)
            self.edges.append(int((above & ~prev).sum()))
            return run(*args)
        SAMPLE_PLAY.run = counted
        return self

    def __exit__(self, *exc):
        from srack_tpu_torch.ops.sample_kernel import SAMPLE_PLAY
        del SAMPLE_PLAY.run


def _noise_drivers(stt, patch, n, seed):
    rng = np.random.default_rng(seed)
    return {inst.id: torch.from_numpy(rng.uniform(-1, 1, (VOICES, n)).astype(
        np.float32)).cuda()
        for inst in patch if inst.mdef.type_name == "Noise"}


def compare_kit_engine(stt, name, mode, case=None, n=None):
    """The block engine against the scan engine on the card, 1,024 voices,
    4,800 Hz, n = 2,048, from random oscillator phases, sequencer steps
    and Sample positions, Noise fed one random lane in both: audio within
    5e-6; two halves with the state carried equal one render; the final
    states agree (int32/bool exact but an oscillator's unconnected Sync
    edge state, pos_g within rtol 1e-4, other floats and, in buffer mode,
    the final fb lanes within 5e-6).  Each Sample's gate must rise in the
    run, so the check cannot pass on silence."""
    t0 = time.perf_counter()
    patch, compiled = case or kit_check_cases(stt)[(name, mode)]
    n = n or CHECK_NS[0]
    params = _cuda(stt, stt.presets.farm_params(patch, VOICES))
    state = _random_state(stt, compiled, VOICES, 11)
    drivers = _noise_drivers(stt, patch, n, 12)
    kw = dict(params=params, batched=True, device="cuda")
    with SampleTriggers() as trig:
        audio_b, _, final_b = compiled.render(n, state=state,
                                              drivers=drivers,
                                              engine="block", **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        audio_s, _, final_s = compiled.render(n, state=state,
                                              drivers=drivers,
                                              engine="scan", **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # K7 runs once per Sample, in buffer mode once per Sample and block
    n_samples = sum(i.mdef.type_name == "Sample" for i in patch)
    edges = [sum(trig.edges[j::n_samples]) for j in range(n_samples)]
    check(len(trig.edges) == n_samples * (n // KIT_BLOCK if mode == "buffer"
                                          else 1) and all(edges),
          f"{name} {mode}: a Sample's gate never rose ({trig.edges})")
    check(bool(torch.isfinite(audio_s).all()), f"{name}: scan not finite")
    err = (audio_b - audio_s).abs().max().item()
    check(err <= BLOCK_ATOL, f"{name} {mode} block vs scan: audio off by "
          f"{err}")
    half = n // 2
    first = {k: a[:, :half] for k, a in drivers.items()}
    second = {k: a[:, half:] for k, a in drivers.items()}
    a1, _, s1 = compiled.render(half, state=state, drivers=first,
                                engine="block", **kw)
    a2, _, _ = compiled.render(n - half, state=s1, drivers=second,
                               engine="block", **kw)
    cont = (torch.cat([a1, a2], dim=-1) - audio_b).abs().max().item()
    check(cont <= BLOCK_ATOL, f"{name} {mode}: halves off one render by "
          f"{cont}")
    serr = 0.0
    # Freeverb rings in time order (the block form returns them so)
    final_b = _canonical(stt, compiled, final_b)
    final_s = _canonical(stt, compiled, final_s)
    for mid, sd in final_s["states"].items():
        inputs = compiled.instances[mid][2]
        for k, w in sd.items():
            g = final_b["states"][mid][k]
            where = f"{name} {mode} state {mid}.{k}"
            check(g.shape == w.shape and g.dtype == w.dtype, where)
            if w.dtype in (torch.int32, torch.bool):
                if k == "sync_last" and inputs[1] is None:
                    continue
                check(torch.equal(g, w), f"{where}: not exact")
            elif k == "pos_g":
                d = (g - w).abs()
                check(bool((d <= 1e-4 * w.abs() + 1e-6).all()),
                      f"{where}: off by {d.max().item()}")
            else:
                d = (g - w).abs().max().item() if w.numel() else 0.0
                check(d <= BLOCK_ATOL, f"{where}: off by {d}")
                serr = max(serr, d)
    for k, w in final_s["fb"].items():
        d = (final_b["fb"][k] - w).abs().max().item()
        check(d <= BLOCK_ATOL, f"{name} {mode} final fb {k}: off by {d}")
        serr = max(serr, d)
    sounding = int((audio_s != 0).sum())
    check(sounding > 0, f"{name} {mode}: the scan render is silent")
    log(f"[3 compare] {name} {mode} mode block engine vs scan engine "
        f"V={VOICES} {KIT_SR} Hz n={n}: max |audio| err {err:.3e} "
        f"(bit-exact: {torch.equal(audio_b, audio_s)}), halves vs one "
        f"render {cont:.3e}, max float-state err {serr:.3e}"
        f"{' (final fb included)' if mode == 'buffer' else ''}; gate edges "
        f"per Sample {edges}; {sounding} samples not silent; block "
        f"{t1 - t0:.1f} s, scan {t2 - t1:.1f} s, "
        f"{time.perf_counter() - t0:.1f} s in all")
    return err


def phase_compare_kit(stt):
    """Phase 3 for slice 3b's kernels and engine paths."""
    gather_keep = compare_gather()
    play_err, play_args = compare_sample_play()
    for name in KIT_NAMES:
        compare_kit_engine(stt, name, "sample")
    for name in ("feedback_patch", "drum_machine"):
        compare_kit_engine(stt, name, "buffer")
    return {"row_gather": 0.0, "row_gather_long": 0.0,
            "sample_play": play_err}, gather_keep, play_args


def kit_times(gather_keep, play_args):
    """K5, K6 and K7 at phase 3's shapes beside their plain versions and,
    for the gathers, torch.gather (on int64 indices made before the
    timing)."""
    from srack_tpu_torch.modules.sample import play_unfused
    from srack_tpu_torch.ops import basic
    from srack_tpu_torch.ops.gather_kernel import ROW_GATHER, ROW_GATHER_LONG
    from srack_tpu_torch.ops.sample_kernel import SAMPLE_PLAY
    out = {}
    for name, kernel in (("row_gather", ROW_GATHER),
                         ("row_gather_long", ROW_GATHER_LONG)):
        table, idx = gather_keep[name]
        idx64 = idx.to(torch.int64)
        out[name] = (
            cuda_ms(lambda: kernel.run(table, idx), repeats=20, warmup=1),
            cuda_ms(lambda: basic.table_lookup_rows_plain(table, idx),
                    repeats=5, warmup=1),
            cuda_ms(lambda: torch.gather(table, 1, idx64), repeats=20,
                    warmup=1),
            gather_bound(table, idx),
            f"K={table.shape[1]} f32 {list(idx.shape)} "
            f"{'uniform' if name == 'row_gather' else 'ramp'} indices "
            f"(library: torch.gather)")
    words = sample_words(play_args)
    out["sample_play"] = (
        cuda_ms(lambda: SAMPLE_PLAY.run(*play_args), repeats=20, warmup=1),
        cuda_ms(lambda: play_unfused(*play_args, plain=True), repeats=5,
                warmup=1),
        None, sample_bound(play_args, words),
        f"K={play_args[2].shape[1]} constant rate {list(play_args[0].shape)}"
        f", {words} table words read")
    return out


def _kit_split(stt, name, total_ms, card):
    """Each kernel of one full-width kit render timed alone at its shapes
    there: K3 on the stage (zero lanes), every K7, K5 and Noise-lane call
    of the warm-up render on its very inputs (the Noise lanes' plain
    version too, once, into ``NOISE_REC``), and K4 as an int32 sum over
    [1,024, n] per launch; the rest (block phases, wrappers, the lanes'
    layout) as the difference."""
    from srack_tpu_torch.ops.gather_kernel import ROW_GATHER
    from srack_tpu_torch.ops.noise_kernel import (NOISE_LANES,
                                                  noise_lanes_plain)
    from srack_tpu_torch.ops.sample_kernel import SAMPLE_PLAY
    from srack_tpu_torch.ops.scan_kernel import ROW_SCAN
    compiled = block_cases(stt)[name][1]
    prog = compiled.block_program()
    kernel = STAGES[name]
    n = HEADLINE_N
    p = _cuda(stt, stt.presets.farm_params(block_cases(stt)[name][0],
                                           VOICES))
    state = _cuda(stt, stt.compiler.tree_map(
        lambda a: a.expand((VOICES,) + a.shape).contiguous(),
        compiled.init_state()))
    stage_state = {"states": {m: state["states"][m]
                              for m in prog.stage_plan}, "fb": state["fb"]}
    lanes = {k: torch.zeros((VOICES, n), device="cuda")
             for k in kernel.lanes}
    k3_ms = cuda_ms(lambda: kernel.run(p, stage_state, lanes, n), warmup=1)
    lanes.clear()
    parts = [f"K3 {k3_ms:.3f} ms"]
    rest = total_ms - k3_ms
    b_ms, b_by, nbytes, ops = stage_bound(compiled, kernel, VOICES, n)
    log(f"[bound] serial_stage in {name} V={VOICES} n={n}: {nbytes} bytes, "
        f"{ops} f32 operations -> {b_ms:.4f} ms ({b_by}); alone it takes "
        f"{k3_ms:.3f} ms, {k3_ms / b_ms:.1f}x its bound")
    k7 = []
    for args, words in HELD_CALLS.get("sample_play", []):
        # a gate from the stage is a transposed view of K3's [O, n, V]
        # output: K7 reads it in place, as the render calls it
        ms = cuda_ms(lambda: SAMPLE_PLAY.run(*args), warmup=1)
        b_ms, b_by, nbytes, _ = sample_bound(args, words)
        layout = ("[R, n] rows" if args[0].stride(1) == 1
                  else "a transposed view")
        log(f"[bound] sample_play in {name} K={args[2].shape[1]} "
            f"{'CV connected' if args[1] is not None else 'constant rate'} "
            f"V={VOICES} n={n}: {nbytes} bytes ({words} table words) -> "
            f"{b_ms:.4f} ms ({b_by}); alone, on the render's operands (the "
            f"gate {layout}, no copy), it takes {ms:.3f} ms, "
            f"{ms / b_ms:.1f}x its bound")
        k7.append(ms)
    if k7:
        parts.append("K7 " + " + ".join(f"{t:.3f}" for t in k7) + " ms")
        rest -= sum(k7)
    k5 = []
    for table, idx in HELD_CALLS.get("row_gather", []):
        ms = cuda_ms(lambda: ROW_GATHER.run(table, idx), warmup=1)
        b_ms, b_by, nbytes, _ = gather_bound(table, idx)
        log(f"[bound] row_gather in {name} {str(table.dtype)[6:]} "
            f"K={table.shape[1]} {list(idx.shape)}: {nbytes} bytes -> "
            f"{b_ms:.4f} ms ({b_by}); alone it takes {ms:.3f} ms, "
            f"{ms / b_ms:.1f}x its bound")
        k5.append(ms)
    if k5:
        parts.append("K5 " + " + ".join(f"{t:.3f}" for t in k5) + " ms")
        rest -= sum(k5)
    noise = []
    for keys, nn in HELD_CALLS.get("noise_lanes", []):
        ms = cuda_ms(lambda: NOISE_LANES.run(keys, nn), repeats=5, warmup=1)
        b_ms, b_by, nbytes, ops = noise_bound(keys.numel(), nn)
        log(f"[bound] noise_lanes in {name} [{keys.numel()}, {nn}]: {nbytes} "
            f"bytes, {ops} operations -> {b_ms:.4f} ms ({b_by}); alone it "
            f"takes {ms:.3f} ms, {ms / b_ms:.1f}x its bound")
        noise.append(ms)
        if not NOISE_REC:
            torch.cuda.empty_cache()
            NOISE_REC.update(
                ms=ms, plain_ms=cuda_ms(lambda: noise_lanes_plain(keys, nn)),
                bound=(b_ms, b_by), shape=f"{name} [{keys.numel()}, {nn}]")
            log(f"[6 plain] noise_lanes {NOISE_REC['shape']}: plain version "
                f"{NOISE_REC['plain_ms']:.3f} ms, kernel {ms:.3f} ms [{card}]")
    if noise:
        parts.append("Noise lanes " + " + ".join(f"{t:.3f}" for t in noise)
                     + " ms")
        rest -= sum(noise)
    HELD_CALLS.clear()
    if name == "kit_check_patch":
        x = torch.ones((VOICES, n), dtype=torch.int32, device="cuda")
        k4 = cuda_ms(lambda: ROW_SCAN.run("sum", (x,)), warmup=1)
        del x
        parts.append(f"K4 {k4:.3f} ms per launch (int32 sum alone)")
    torch.cuda.empty_cache()
    log(f"[split] {name} V={VOICES} n={n}: " + ", ".join(parts)
        + f"; the rest (block phases, wrappers, layout"
        + (", K4" if name == "kit_check_patch" else "")
        + f") {rest:.3f} ms of {total_ms:.3f} [{card}]")


def phase_kit(stt, kernels, card, name, phase, names):
    """One slice-3b main path: ``name`` (mono), 1,024 voices x 10 s at 48
    kHz through render_batch on the default device.  The warm-up render
    holds every K7 call against its unfused form and every K5 call
    against torch.gather at the shapes they get there."""
    patch = getattr(stt.presets, name)(stt.AudioConfig(sample_rate=SR,
                                                       channels=1))
    params = stt.presets.farm_params(patch, VOICES)
    found = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    audio, ms, launches = _timed_main(
        kernels, lambda: stt.render_batch(patch, HEADLINE_N, params=params),
        names, held_against_plain(found))
    check("sample_play" in found, f"{name}: the render did not call K7")
    check(("noise_lanes" in found) == ("noise_lanes" in names),
          f"{name}: the Noise-lane kernel's calls {found.get('noise_lanes')}")
    held = _log_held(phase, found, card)
    check(audio.device.type == "cuda", "render_batch did not default to "
          "the card")
    peak = _check_audio(audio, (VOICES, 1, HEADLINE_N), name)
    del audio
    torch.cuda.empty_cache()
    rate = VOICES * HEADLINE_N / (ms / 1e3)
    _kit_split(stt, name, ms, card)
    log(f"[{phase}] {name} V={VOICES} n={HEADLINE_N} mono via render_batch "
        f"-> block engine, launches {launches}; {ms:.3f} ms/render, "
        f"{rate / 1e9:.4f} G samples/s, aggregate real-time "
        f"{rate / SR:.0f}x, peak {peak:.5f}; device memory peak "
        f"{PEAK['render'] / 2**30:.2f} GiB in the timed render, "
        f"{PEAK['warm-up'] / 2**30:.2f} GiB in the warm-up with its checks, "
        f"no segment= [{card}]")
    return launches, held


# -- slice 5: gradients through kernel K10 ------------------------------------

VJP_SR, VJP_N = 4800, 512   # phase 3's K10 check: the plain version costs
                            # several ms per sample at 1,024 voices
VJP_NAMES = ("subtractive_voice", "gradient_patch", "feedback_patch",
             "lane_check_patch", "kernel_check_patch")
TRAIN_N, TRAIN_STEPS, TRAIN_MULTI = 48000, 3, 32   # bench.py:205-262
VJP = {}   # case -> (patch, compiled, FusedVJPKernel); "train" at 48 kHz
VJP_AB = {}  # phase 15's other builds of the training voice: "train"
             # with the one-thread forward and backward (fused_vjp_fwd_twin,
             # fused_vjp_bwd_twin), "t_chunk 64" with checkpoints every 64
             # samples (fused_vjp_bwd_t64), "fwd T=64" and "fwd T=128" with
             # the split forward at those chunks (fused_vjp_fwd_T64, _T128)
FWD_SWEEP_CHUNKS = (64, 128)
TRAIN_PARAMS = {}  # phase 14's trained params, [V, ...], for phase 15


def vjp_cases(stt) -> dict:
    """K10's cases: phase 3's five patches at 4,800 Hz (the subtractive
    voice with a fast gate clock, the JAX tests' gradient patch,
    feedback_patch, lane_check_patch with its gate, Noise and pitch lanes,
    kernel_check_patch) and phase 14's subtractive voice at 48 kHz."""
    cfg1 = stt.AudioConfig(sample_rate=VJP_SR, channels=1)
    cases = {}
    for name in VJP_NAMES:
        autos, lanes = (), ()
        if name == "lane_check_patch":
            patch, autos = stt.presets.lane_check_patch(
                stt.AudioConfig(sample_rate=VJP_SR, channels=2))
        elif name == "kernel_check_patch":
            patch = stt.presets.kernel_check_patch(
                stt.AudioConfig(sample_rate=VJP_SR, channels=3))
        elif name == "subtractive_voice":
            patch = stt.presets.subtractive_voice(cfg1, gate_rate_oct=-1.0)
        else:
            patch = getattr(stt.presets, name)(cfg1)
        compiled = stt.compile_patch(patch, automation=autos)
        if name == "lane_check_patch":
            ids = {inst.name: inst.id for inst in patch}
            lanes = (ids["gate"], ids["noise"],
                     compiled._auto_key(ids["vco"], "val"))
        cases[name] = (patch, compiled, compiled.fused_vjp(lanes))
    patch = stt.presets.subtractive_voice(stt.AudioConfig(sample_rate=SR,
                                                          channels=1))
    compiled = stt.compile_patch(patch)
    cases["train"] = (patch, compiled, compiled.fused_vjp(()))
    return cases


def vjp_kernels(stt) -> dict:
    """Phase 2's K10 builds: the forward and the backward of every case,
    and the training voice's one-thread backward (the twin) for phase
    15."""
    from srack_tpu_torch.ops.fused_vjp import FusedVJPKernel
    VJP.update(vjp_cases(stt))
    compiled = VJP["train"][1]
    VJP_AB["train"] = FusedVJPKernel(compiled, (), stages=1)
    VJP_AB["t_chunk 64"] = FusedVJPKernel(compiled, (), t_chunk=64)
    for lib in (VJP_AB["t_chunk 64"].fwd, VJP_AB["t_chunk 64"].bwd):
        lib.name += "_t64"
    jobs = {"train@k10_fwd_twin": VJP_AB["train"].fwd,
            "train@k10_bwd_twin": VJP_AB["train"].bwd,
            "train@k10_bwd t_chunk 64": VJP_AB["t_chunk 64"].bwd,
            "train@k10 t_chunk 64": VJP_AB["t_chunk 64"].fwd}
    # the split forward at longer chunks, where shared memory allows
    for t in FWD_SWEEP_CHUNKS:
        try:
            k = FusedVJPKernel(compiled, (), fwd_chunk=t)
        except ValueError as err:
            log(f"[2 build] train@k10 forward at T={t}: not built ({err})")
            continue
        k.fwd.name += f"_T{t}"
        VJP_AB[f"fwd T={t}"] = k
        jobs[f"train@k10 forward T={t}"] = k.fwd
    for name, (_, _, kernel) in VJP.items():
        jobs[f"{name}@k10"] = kernel.fwd
        jobs[f"{name}@k10_bwd"] = kernel.bwd
        log(f"[2 build] {name}@k10: {fwd_form(kernel)}")
        log(f"[2 build] {name}@k10_bwd: {bwd_form(kernel)}")
    return jobs


def fwd_form(kernel) -> str:
    """How a K10 build runs its forward: its stages (G), chunk (T) and
    shared memory, or one thread per voice."""
    if kernel.fwd_twin:
        return "forward: one thread per voice (the twin)"
    part = kernel.fwd_partition
    return (f"forward: G={part.n_stages} stages of {list(part.costs)} ops "
            f"and a store warp, "
            f"T={kernel.fwd_chunk} of t_chunk {kernel.t_chunk} in groups of "
            f"U={kernel.fwd_group}, "
            f"{kernel.fwd_smem_bytes} B shared memory, {len(part.wires)} "
            f"cross-stage wires, checkpoint rows stored by their stages")


def bwd_form(kernel) -> str:
    """How a K10 build runs its backward: its sweep stages (G), replay
    warps (R), sub-chunk (T) and shared memory, or one thread per voice."""
    if kernel.twin:
        return "one thread per voice (the twin)"
    sh, part = kernel.shape, kernel.partition
    return (f"G={part.n_stages} sweep stages of {list(part.costs)} ops "
            f"(step re-run + adjoint), R={sh.replays} replay warps, "
            f"T={sh.chunk} of t_chunk {kernel.t_chunk}, {sh.nbytes} B "
            f"shared memory, {len(sh.xwires)} forward wires in the scratch, "
            f"{len(sh.rings)} cotangent rings")


def adjoint_ops(compiled, mid) -> int:
    """f32 operations per sample of a module's adjoint, read off
    ``csrc/modules_adj.cuh`` (``srack_tpu_torch.ops.partition.adjoint_ops``,
    by which K10's backward partition weighs its stages).  Counted for the
    bounds."""
    from srack_tpu_torch.ops.partition import adjoint_ops as ops
    return ops(compiled, mid)


def vjp_bound(compiled, kernel, v: int, n: int, which: str) -> tuple:
    """K10's bound for one launch.  ``which="fwd"``: K1's bytes and
    operations plus the checkpoints out.  ``"bwd"``: the params,
    checkpoints and lanes in, the audio cotangent and the final state's in
    and the float params' and initial state's cotangents out, once each;
    per voice-sample one forward step (``module_ops``: the wires the
    adjoints need, recomputed once) plus ``adjoint_ops``; or, where less,
    the same with the forward's state before every sample read back (4 * S
    bytes per voice-sample, no checkpoints) instead of the recompute.
    Returns ``(ms, "bytes"|"operations", bytes, ops)``."""
    lay = kernel.layout
    n_chunks = -(-n // kernel.t_chunk)
    ck = 4 * v * n_chunks * kernel.s_rows
    steps = sum(module_ops(compiled, m) for m in compiled.plan)
    if which == "fwd":
        _, _, nbytes, ops = bound(compiled, kernel, v, n, kernel.lanes)
        return _bound(nbytes + ck, ops)
    rows = lay.n_pf + lay.n_pi + 2 * lay.n_sf + lay.n_pf
    nbytes = ck + 4 * v * (rows + (len(kernel.lanes)
                                   + compiled.cfg.channels) * n)
    adj = sum(adjoint_ops(compiled, m) for m in compiled.plan)
    stored = nbytes - ck + 4 * v * n * kernel.s_rows
    return min(_bound(nbytes, (steps + adj) * v * n),
               _bound(stored, adj * v * n))


def _vjp_grads(stt, render, params, state, w, wf):
    """``render(params, state) -> (audio, final)`` under autograd, then the
    gradient of ``sum(audio * w) + sum(final float leaf * wf)`` with
    respect to every float param and float initial-state leaf.  Returns
    ``(audio, {path: grad}, forward s, backward s)``."""
    from srack_tpu_torch.ops.fused import _get
    tm, items = stt.compiler.tree_map, stt.compiler.tree_items
    p = tm(lambda a: a.detach().clone().requires_grad_(
        a.is_floating_point()), params)
    s = tm(lambda a: a.detach().clone().requires_grad_(
        a.is_floating_point()), state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio, final = render(p, s)
    loss = (audio * w).sum()
    for path, weight in wf.items():
        loss = loss + (_get(final, path) * weight).sum()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    leaves = [(path, t) for path, t in items(p) + items(s)
              if t.requires_grad]
    grads = torch.autograd.grad(loss, [t for _, t in leaves],
                                allow_unused=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return audio.detach(), {
        path: torch.zeros_like(t) if g is None else g
        for (path, t), g in zip(leaves, grads)}, t1 - t0, t2 - t1


def _vjp_inputs(stt, name, patch, compiled, n):
    """1,024 voices of farm_params on the card (kernel_check_patch's
    Non-Linear at exponent 2.0: at 1.5 its powf of a negative base makes
    the gradient NaN upstream, in JAX and in both engines here), the
    initial state, lane_check_patch's lanes.  For the training voice at
    48 kHz, whose gate clock first rises after ~2,500 samples, the clock's
    phase starts at random (seed 29), so that some voices' envelopes run
    within phase 3's 512 samples."""
    params, state, xs = _inputs(stt, name, patch, compiled, n)
    if name == "kernel_check_patch":
        shaper = next(i.id for i in patch if i.name == "shaper")
        params[shaper]["constant"] = torch.full((VOICES,), 2.0,
                                                device="cuda")
    if name == "train":
        clock = next(i.id for i in patch if i.name == "gate_clock")
        rng = np.random.default_rng(29)
        state["states"][clock]["pos"] = torch.from_numpy(rng.integers(
            -2**31, 2**31, VOICES, dtype=np.int64).astype(np.int32)).cuda()
    return params, state, xs


def vjp_times(stt, kernel, params, state, n, xs):
    """K10's forward and backward launches alone (mean of 3 after one
    warm-up), on the operands the wrapper packs for one render."""
    with torch.no_grad():
        lanes, pi, si, floats = kernel.operands(params, state, n, xs)
        pf, sf = kernel.float_rows(floats, VOICES, pi.device)
        _, _, _, ck = kernel.run_fwd(pf, pi, sf, si, lanes, VOICES, n)
        fwd_ms = cuda_ms(lambda: kernel.run_fwd(pf, pi, sf, si, lanes,
                                                VOICES, n),
                         repeats=3, warmup=1)
        rng = np.random.default_rng(5)
        cta = torch.from_numpy(rng.standard_normal(
            (VOICES, kernel.compiled.cfg.channels, n)).astype(
                np.float32)).cuda()
        ctf = torch.zeros((max(kernel.layout.n_sf, 1), VOICES),
                          device="cuda")
        bwd_ms = cuda_ms(lambda: kernel.run_bwd(pf, pi, lanes, ck, cta, ctf,
                                                VOICES, n),
                         repeats=3, warmup=1)
    return fwd_ms, bwd_ms


RAGGED_V = 1000     # a last CTA of 8 voices
RAGGED_BLOCK = 66   # K2's block: no multiple of the chunk
RAGGED = {}         # K2 at RAGGED_BLOCK (its patch and compiled plan)


def ragged_kernels(stt) -> dict:
    """K2 of the buffer-feedback patch at a block of ``RAGGED_BLOCK``, for
    :func:`compare_ragged`."""
    from srack_tpu_torch.ops.fused import FusedKernel
    patch = stt.presets.feedback_patch(stt.AudioConfig(
        sample_rate=SR, block_size=RAGGED_BLOCK, channels=1,
        buffer_feedback=True))
    compiled = stt.compile_patch(patch)
    RAGGED["K2"] = (patch, compiled, FusedKernel(compiled))
    return {f"feedback_buffer block {RAGGED_BLOCK}": RAGGED["K2"][2]}


def compare_ragged(stt, kernels) -> None:
    """K1, K2 and K10's forward against the scan engine on the card, bit
    for bit, where the store warp's tile is ragged: ``RAGGED_V`` voices (a
    last CTA of 8), n with and without a part last chunk, K2's chunks
    straddling its blocks."""
    v = RAGGED_V
    cases = [("K1", *kernels["subtractive_voice"], (1024, 1023)),
             ("K2", *RAGGED["K2"], (4 * RAGGED_BLOCK, 3 * RAGGED_BLOCK)),
             ("K10 forward", *VJP["train"], (512, 510))]
    for what, patch, compiled, kernel, ns in cases:
        for n in ns:
            params = _cuda(stt, stt.presets.farm_params(patch, v))
            state = _cuda(stt, stt.compiler.tree_map(
                lambda a: a.expand((v,) + a.shape).contiguous(),
                compiled.init_state()))
            xs = compiled._make_xs(params, 0, n, {})
            with torch.no_grad():
                if what == "K10 forward":
                    audio, final = kernel.apply(params, state, n, xs)
                else:
                    audio, final = kernel.render(params, state, n, xs)
                want, want_final = compiled.render_scan(
                    params, state, n, batched=True, nograd=True, xs=xs)
            torch.cuda.synchronize()
            check(torch.equal(audio, want), f"{what} n={n} V={v}: audio "
                  f"off the scan engine by "
                  f"{(audio - want).abs().max().item()}")
            state_note = ""
            if what != "K10 forward":   # phase 3's K10 check holds its audio
                serr = _state_diff(final, want_final, f"{what} n={n}")
                # K1 bit for bit, K2 within phase 3's limit
                limit = ATOL if compiled.cfg.buffer_feedback else 0.0
                check(serr <= limit, f"{what} n={n}: float state off by "
                      f"{serr} (limit {limit:g})")
                state_note = (f", max float-state err {serr:.3e} (limit "
                              f"{limit:g})")
            log(f"[3 compare] {what} V={v} n={n} (the store warp's last "
                f"CTA of {v % 32} voices): audio bit for bit with the scan "
                f"engine{state_note}")


def phase_compare_vjp(stt):
    """K10 against its plain version, autograd through the scan engine, on
    the card: 1,024 voices, n = 512, the five patches of ``VJP_NAMES`` at
    4,800 Hz and phase 14's kernel (the training voice at 48 kHz, the
    very wrapper phase 14 launches); a loss on the audio and on the final
    float state.  The audio bit-exact; each cotangent leaf within ``1e-8 +
    1e-4 * max|ref|`` (``tests/test_fused_interpret.py``'s rule), NaN where
    the reference is NaN."""
    errs = {"fused_vjp_fwd": 0.0, "fused_vjp_bwd": 0.0}
    keep = {}
    n = VJP_N
    for name in VJP_NAMES + ("train",):
        t0 = time.perf_counter()
        patch, compiled, kernel = VJP[name]
        check(not kernel.twin, f"K10 {name}: the backward is the one-thread "
              f"twin, not the split kernel")
        check(not kernel.fwd_twin, f"K10 {name}: the forward is the "
              f"one-thread twin, not the split kernel")
        params, state, xs = _vjp_inputs(stt, name, patch, compiled, n)
        rng = np.random.default_rng(23)
        w = torch.from_numpy(rng.standard_normal(
            (VOICES, compiled.cfg.channels, n)).astype(np.float32)).cuda()
        wf = {path: torch.from_numpy(rng.standard_normal(
            tuple(t.shape)).astype(np.float32)).cuda()
            for path, t in stt.compiler.tree_items(state)
            if t.is_floating_point()}
        audio_k, got, _, _ = _vjp_grads(
            stt, lambda p, s: kernel.apply(p, s, n, xs), params, state, w,
            wf)
        audio_p, want, plain_f, plain_b = _vjp_grads(
            stt, lambda p, s: compiled._run(p, s, xs, n, True)[::2],
            params, state, w, wf)
        check(torch.equal(audio_k, audio_p),
              f"K10 {name}: audio not bit-exact to the scan engine, off by "
              f"{(audio_k - audio_p).abs().max().item()}")
        check(set(got) == set(want), f"K10 {name}: leaves differ")
        worst, ratio, nan_leaves, flowing = 0.0, 0.0, 0, 0
        for path, g in want.items():
            k = got[path]
            nan = torch.isnan(g)
            check(torch.equal(nan, torch.isnan(k)),
                  f"K10 {name} {path}: NaN pattern differs")
            if bool(nan.all()):
                nan_leaves += 1
                continue
            g, k = g[~nan].double(), k[~nan].double()
            top = g.abs().max().item()
            tol = 1e-8 + 1e-4 * top
            err = (k - g).abs().max().item()
            check(bool(((k - g).abs() <= tol + 1e-7 * g.abs()).all()),
                  f"K10 {name} {path}: cotangent off by {err} (tolerance "
                  f"{tol})")
            worst, ratio = max(worst, err), max(ratio, err / tol)
            flowing += top > 0
        check(flowing >= 3, f"K10 {name}: only {flowing} leaves have "
              f"non-zero cotangents")
        errs["fused_vjp_bwd"] = max(errs["fused_vjp_bwd"], worst)
        sounding = int((audio_p.abs().amax(dim=(1, 2)) > 0).sum())
        log(f"[3 compare] {name} (fused_vjp_fwd + fused_vjp_bwd) V={VOICES} "
            f"n={n} at {compiled.cfg.sample_rate} Hz: audio bit-exact "
            f"({sounding} voices not silent); {len(want)} cotangent "
            f"leaves ({flowing} non-zero, {nan_leaves} NaN in both), max "
            f"|err| {worst:.3e}, at most {ratio:.3f} of the tolerance; "
            f"plain version {plain_f:.2f} s forward + {plain_b:.2f} s "
            f"backward; {fwd_form(kernel)}; backward: {bwd_form(kernel)}; "
            f"{time.perf_counter() - t0:.1f} s")
        if name == "train":
            keep = {"params": params, "state": state, "xs": xs, "n": n,
                    "plain": (1e3 * plain_f, 1e3 * plain_b)}
    return errs, keep


def phase_train(stt, kernels, card):
    """Phase 14, bench.py's training config on the card through
    ``utils.train``: subtractive_voice at 48 kHz, 1,024 voices x 48,000
    samples, Adam (lr 1e-3), waveform_l2 against silent targets,
    ``batched_train_step(fast=True)``: one warm-up step, whose K10 forward
    audio must equal K1's render of the same params bit for bit (K1 is
    held to the scan engine in phase 3), and 3 timed ones, each launching
    exactly one K10 forward, one K10 backward and no other kernel (the
    scan engine is fenced off), then a 32-step ``multi_train_step``; the
    last loss must be below the first.  Returns K10's launches per step,
    its two kernels' times alone and their bounds."""
    import functools
    from srack_tpu_torch.utils import train as T
    patch, compiled, kernel = VJP["train"]
    v, n = VOICES, TRAIN_N
    tm = stt.compiler.tree_map
    adam = functools.partial(torch.optim.Adam, lr=1e-3)
    ts = T.SoundMatcher(patch, n).init()
    train, frozen = ts["train"], ts["frozen"]
    check(all(t.device.type == "cuda"
              for _, t in stt.compiler.tree_items(train)),
          "SoundMatcher did not default to the card")
    step = T.batched_train_step(compiled, adam, n, fast=True)
    targets = torch.zeros((v, 1, n), device="cuda")
    params0 = tm(lambda a: a.detach().clone(), T._merge(train, frozen))
    run_fwd, fwd_audio = kernel.run_fwd, []

    def no_scan(*args, **kwargs):
        raise SmokeFailure("a training step ran the scan engine")

    def keep_audio(*args):
        out = run_fwd(*args)
        fwd_audio.append(out[0])
        return out

    compiled._run = no_scan
    kernel.run_fwd = keep_audio
    try:
        t0 = time.perf_counter()
        train, opt, loss = step(train, frozen, None, targets, 0)
        first = float(loss)
        warm_s = time.perf_counter() - t0
    finally:
        del compiled._run, kernel.run_fwd
    check(len(fwd_audio) == 1, f"the warm-up step launched the K10 forward "
          f"{len(fwd_audio)} times")
    k1 = compiled.fused(())
    k1_before = k1.launches
    with torch.no_grad():
        audio_k1, _, _ = compiled.render(
            n, params=tm(lambda a: a.expand((v,) + a.shape), params0),
            batched=True, engine="fused", device="cuda")
    check(k1.launches == k1_before + 1, "K1 did not render the check")
    _check_audio(audio_k1, (v, 1, n), "train K1")
    check(torch.equal(fwd_audio[0], audio_k1),
          f"the warm-up step's K10 forward audio is not K1's, off by "
          f"{(fwd_audio[0] - audio_k1).abs().max().item()}")
    sounding = int((audio_k1.abs().amax(dim=(1, 2)) > 0).sum())
    del fwd_audio, audio_k1
    log(f"[14 train] warm-up step: K10's forward audio [{v}, 1, {n}] equals "
        f"K1's render of the same params bit for bit ({sounding} voices not "
        f"silent)")
    compiled._run = no_scan
    try:
        counters = _counters(kernels)
        for c in counters:
            c.launches = 0
        secs = []
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train, opt, loss = step(train, frozen, opt, targets, i + 1)
            float(loss)
            secs.append(time.perf_counter() - t0)
        counts = {}
        for c in counters:
            counts[c.name] = counts.get(c.name, 0) + c.launches
        launches = {k: counts.pop(k) for k in ("fused_vjp_fwd",
                                               "fused_vjp_bwd")}
        for k, got in launches.items():
            check(got == TRAIN_STEPS, f"{TRAIN_STEPS} training steps "
                  f"launched {k} {got} times")
        check(not any(counts.values()),
              f"the training steps launched other kernels: {counts}")
        multi = T.multi_train_step(compiled, adam, n, TRAIN_MULTI,
                                   fast=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train, opt, losses = multi(train, frozen, opt, targets, 7)
        last = float(losses[-1])
        multi_s = time.perf_counter() - t0
    finally:
        del compiled._run
    check(bool(torch.isfinite(losses).all()), "a training loss is not finite")
    check(last < first, f"the loss did not fall: {first} -> {last}")
    step_ms = 1e3 * min(secs)
    multi_ms = 1e3 * multi_s / TRAIN_MULTI
    rate = v * n / (step_ms / 1e3)
    params = T._merge({m: {k: t.detach() for k, t in d.items()}
                       for m, d in train.items()}, frozen)
    params_b = stt.compiler.tree_map(lambda a: a.expand((v,) + a.shape),
                                     params)
    state = stt.compiler.tree_map(
        lambda a: a.expand((v,) + a.shape).contiguous().cuda(),
        compiled.init_state())
    TRAIN_PARAMS.update(params_b)
    fwd_ms, bwd_ms = vjp_times(stt, kernel, params_b, state, n, {})
    bounds = {}
    for which, ms in (("fwd", fwd_ms), ("bwd", bwd_ms)):
        b_ms, b_by, nbytes, ops = vjp_bound(compiled, kernel, v, n, which)
        bounds[which] = (b_ms, b_by)
        form = f" ({bwd_form(kernel) if which == 'bwd' else fwd_form(kernel)})"
        log(f"[14 train] fused_vjp_{which}{form} alone V={v} n={n}: "
            f"{ms:.3f} ms; "
            f"bound {nbytes} bytes, {ops} f32 operations -> {b_ms:.4f} ms "
            f"({b_by}), {ms / b_ms:.1f}x its bound; ptxas: "
            f"{ptxas(getattr(kernel, which))} [{card}]")
    step_list = ", ".join(f"{1e3 * x:.2f}" for x in secs)
    log(f"[14 train] subtractive_voice V={v} n={n} at {SR} Hz, Adam lr 1e-3, "
        f"waveform_l2, batched_train_step(fast=True): warm-up step "
        f"{warm_s:.2f} s; {TRAIN_STEPS} steps {step_list} ms "
        f"(best {step_ms:.2f} ms/step, {rate / 1e9:.4f} G samples/s through "
        f"fwd+bwd), each step launching fused_vjp_fwd and fused_vjp_bwd "
        f"once and no other kernel; {TRAIN_MULTI}-step multi_train_step "
        f"{multi_ms:.2f} ms/step ({v * n / (multi_ms / 1e3) / 1e9:.4f} G "
        f"samples/s); loss {first:.6g} -> {last:.6g} [{card}]")
    per_step = {k: got // TRAIN_STEPS for k, got in launches.items()}
    return per_step, (fwd_ms, bwd_ms), bounds


# -- slice 6: K1 and K3 as stage pipelines, one-voice renders ------------------

AB = {}   # A/B case -> (the split kernel, its one-thread (G = 1) twin)
SWEEP = {}  # case -> {chunk: the split kernel built with that chunk}
SWEEP_CHUNKS = (16, 64, 128)
GROUPS = {}  # case -> {group: the split kernel built with that sample group}
SWEEP_GROUPS = (1, 2, 4, 8)
AB_CELLS = (("headline", "subtractive_voice", VOICES, HEADLINE_N),
            ("farm", "subtractive_voice", FARM_VOICES, FARM_N),
            ("sequencer", "sequencer_patch", VOICES, HEADLINE_N),
            ("buffer", "feedback_buffer", VOICES, BUFFER_N))
ONE_N = 48000       # one voice, 1 s at 48 kHz
ONE_SCAN_N = 4800   # its prefix held to the scan engine on the card
ONE_REVERB_N = 1024  # reverb_patch's prefix held to the scan engine


def ab_kernels(kernels) -> dict:
    """Phase 2's one-thread twins (G = 1) of the split K1 of the headline
    voice and the sequencer, of the split K2 of the buffer cell and of the
    split K3 of each block cell's stage, for phase 15, each named
    ``<kernel>_g1`` so that a main path launching one fails its count; and
    the split headline voice and kit-check stage at the other chunk lengths
    of ``SWEEP_CHUNKS``."""
    from srack_tpu_torch.ops.fused import FusedKernel, StageKernel
    for name in ("subtractive_voice", "sequencer_patch", "feedback_buffer"):
        _, compiled, kernel = kernels[name]
        AB[name] = (kernel, FusedKernel(compiled, kernel.lanes, stages=1))
    for name, kernel in STAGES.items():
        AB[name] = (kernel, StageKernel(kernel.program, kernel.lanes,
                                        stages=1))
    for _, one in AB.values():
        one.name += "_g1"
    jobs = {f"{name} G=1": one for name, (_, one) in AB.items()}
    kernel = kernels["subtractive_voice"][2]
    SWEEP["subtractive_voice"] = {t: FusedKernel(
        kernel.compiled, kernel.lanes, chunk=t) for t in SWEEP_CHUNKS}
    kernel = STAGES["kit_check_patch"]
    SWEEP["kit_check_patch"] = {t: StageKernel(
        kernel.program, kernel.lanes, chunk=t) for t in SWEEP_CHUNKS}
    for name, by_chunk in SWEEP.items():
        jobs.update({f"{name} T={t}": k for t, k in by_chunk.items()})
    # the split headline voice, buffer cell and reverb stage at the other
    # sample groups of SWEEP_GROUPS
    for name in ("subtractive_voice", "feedback_buffer"):
        kernel = AB[name][0]
        GROUPS[name] = {u: FusedKernel(kernel.compiled, kernel.lanes,
                                       group=u)
                        for u in SWEEP_GROUPS if u != kernel.group}
    kernel = STAGES["reverb_patch"]
    GROUPS["reverb_patch"] = {u: StageKernel(kernel.program, kernel.lanes,
                                             group=u)
                              for u in SWEEP_GROUPS if u != kernel.group}
    for name, by_group in GROUPS.items():
        jobs.update({f"{name} U={u}": k for u, k in by_group.items()})
    return jobs


def _turns(split, one, run):
    """``run(kernel)`` through ``split`` and its twin ``one`` in turns (one,
    split, split, one), each timed after a warm-up call.  Returns the times
    ``{"one": [ms, ms], "split": [ms, ms]}`` and each one's first result."""
    times = {"one": [], "split": []}
    outs = {}
    for which in ("one", "split", "split", "one"):
        kernel = one if which == "one" else split
        times[which].append(cuda_ms(lambda: run(kernel), warmup=1))
        if which not in outs:
            outs[which] = run(kernel)
    torch.cuda.synchronize()
    return times, outs


def _ab_pair(split, one, run, same, what, card, sweep=None,
             groups=None) -> dict:
    """``run(kernel)`` through the split kernel and its G = 1 twin, timed
    in turns (G = 1, split, split, G = 1; one warm-up call each): both
    results must be equal bit for bit (``same``).  ``sweep``: the split
    kernel at other chunk lengths, ``{chunk: kernel}``, and ``groups`` at
    other sample groups, ``{group: kernel}``, each timed once (after a
    warm-up) and held to the split's result.  Returns the record."""
    times, outs = _turns(split, one, run)
    check(same(outs["split"], outs["one"]), f"{what}: the split kernel "
          f"differs from its one-thread twin")
    del outs["one"]
    chunks, by_group = {}, {}
    for t, kernel in (sweep or {}).items():
        chunks[t] = cuda_ms(lambda: run(kernel), warmup=1)
        check(same(run(kernel), outs["split"]), f"{what}: the split kernel "
              f"at T={t} differs")
    for u, kernel in (groups or {}).items():
        by_group[u] = cuda_ms(lambda: run(kernel), warmup=1)
        check(same(run(kernel), outs["split"]), f"{what}: the split kernel "
              f"at U={u} differs")
    del outs
    torch.cuda.empty_cache()
    if chunks:
        chunks[split.chunk] = min(times["split"])
        log(f"[15 a/b] {what}, chunk lengths: " + ", ".join(
            f"T={t} {ms:.3f} ms" for t, ms in sorted(chunks.items()))
            + f" (T={split.chunk} is the build's; each equal to it bit for "
            f"bit) [{card}]")
    if by_group:
        by_group[split.group] = min(times["split"])
        log(f"[15 a/b] {what}, sample groups: " + ", ".join(
            f"U={u} {ms:.3f} ms" for u, ms in sorted(by_group.items()))
            + f" (U={split.group} is the build's; each equal to it bit for "
            f"bit) [{card}]")
    one_ms, split_ms = min(times["one"]), min(times["split"])
    rec = {"g1_ms": one_ms, "split_ms": split_ms,
           "ratio": split_ms / one_ms, "stages": split.partition.n_stages,
           "chunk": split.chunk, "group": split.group,
           "smem_bytes": split.smem_bytes,
           "registers": registers(split), "g1_registers": registers(one),
           "stage_ops": list(split.partition.costs),
           "g1_ops": sum(split.partition.costs)}
    if chunks:
        rec["ms_by_chunk"] = {str(t): ms for t, ms in sorted(chunks.items())}
    if by_group:
        rec["ms_by_group"] = {str(u): ms for u, ms in sorted(by_group.items())}
    log(f"[15 a/b] {what}: G=1 {one_ms:.3f} ms ({times['one'][0]:.3f}, "
        f"{times['one'][1]:.3f}; {rec['g1_registers']} registers, "
        f"{rec['g1_ops']} ops per sample), split {split_ms:.3f} ms "
        f"({times['split'][0]:.3f}, {times['split'][1]:.3f}; G="
        f"{rec['stages']}, stages of {rec['stage_ops']} ops, T="
        f"{rec['chunk']}, U={rec['group']}, {rec['smem_bytes']} B shared "
        f"memory, {rec['registers']} registers): split / G=1 = "
        f"{rec['ratio']:.3f}; equal bit for bit over the whole render "
        f"[{card}]")
    return rec


def _same(a, b) -> bool:
    """Two results (tensors, or trees and tuples of them) equal bit for
    bit."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def phase_ab(stt, kernels, card) -> dict:
    """Phase 15: the split K1 against its one-thread twin at full width on
    the headline, the farm and the sequencer, the split K2 against its twin
    on the buffer cell (farm_params, the initial state), the split K3
    against its twin on the stage of each block cell (1,024 voices x
    480,000 samples, random input lanes in [-1, 1)), and the shared-memory
    K8 against its twin on the reverb and block-check renders' operands:
    audio (or stage outputs) and final state equal bit for bit, both timed
    in one call; the headline, the farm, the buffer cell and the reverb
    stage also at each sample group of ``SWEEP_GROUPS``, each equal to the
    build bit for bit; K10's split kernels against their twins; K7's tile
    shapes and K9's tile lengths on the kit and reverb renders' operands
    (``k7_tiles``, ``k9_tiles``)."""
    out = {}
    for cell, name, v, n in AB_CELLS:
        split, one = AB[name]
        patch, compiled, _ = kernels[name]
        params = _cuda(stt, stt.presets.farm_params(patch, v))
        state = _cuda(stt, stt.compiler.tree_map(
            lambda a: a.expand((v,) + a.shape).contiguous(),
            compiled.init_state()))
        kid = "K2" if split.buffer else "K1"
        out[cell] = _ab_pair(
            split, one, lambda k: k.render(params, state, n), _same,
            f"{kid} {cell} ({name}) V={v} n={n}", card, SWEEP.get(
                name if cell in ("headline", "farm") else None),
            GROUPS.get(name if cell != "sequencer" else None))
        del params, state
    for name in STAGES:
        split, one = AB[name]
        prog = split.program
        patch, compiled = block_cases(stt)[name]
        params = _cuda(stt, stt.presets.farm_params(patch, VOICES))
        state = _cuda(stt, stt.compiler.tree_map(
            lambda a: a.expand((VOICES,) + a.shape).contiguous(),
            compiled.init_state()))
        stage_state = {"states": {m: state["states"][m]
                                  for m in prog.stage_plan},
                       "fb": state["fb"]}
        gen = torch.Generator(device="cuda").manual_seed(15)
        lanes = {k: torch.rand((VOICES, HEADLINE_N), device="cuda",
                               generator=gen) * 2 - 1 for k in split.lanes}
        out[name] = _ab_pair(
            split, one,
            lambda k: k.run(params, stage_state, lanes, HEADLINE_N), _same,
            f"K3 {name} stage ({len(prog.stage_plan)} modules, "
            f"{len(lanes)} input lanes) V={VOICES} n={HEADLINE_N}", card,
            SWEEP.get(name), GROUPS.get(name))
        del lanes, params, state, stage_state
        torch.cuda.empty_cache()
    cells = k8_cells(stt)   # the block check's automation made once
    for cell, (patch, automation) in cells.items():
        out[f"k8 {cell}"] = k8_ab(stt, cell, patch, automation, card)
    out["k10 train"] = k10_ab(stt, card)
    out["k10 fwd"] = k10_fwd_ab(stt, card)
    for name in KIT_NAMES:
        out[f"k7 {name}"] = k7_tiles(stt, name, card)
    for cell, (patch, automation) in cells.items():
        out[f"k9 {cell}"] = k9_tiles(stt, cell, patch, automation, card)
    return out


def _same_nan(a, b) -> bool:
    """Two tuples of tensors equal bit for bit, NaN where NaN."""
    return all(bool(((x == y) | (x.isnan() & y.isnan())).all())
               and bool((x.isnan() == y.isnan()).all()) for x, y in zip(a, b))


def k10_ab(stt, card) -> dict:
    """K10's split backward against its one-thread twin at the training
    width, 1,024 voices x 48,000 samples: the training voice from
    farm_params, the checkpoints of its forward, a random audio cotangent
    and final-state cotangent (seed 31); every float param's and initial
    float state's cotangent equal bit for bit, both timed in one call in
    turns (twin, split, split, twin)."""
    patch, compiled, kernel = VJP["train"]
    twin = VJP_AB["train"]
    v, n = VOICES, TRAIN_N
    params = _cuda(stt, stt.presets.farm_params(patch, v))
    state = _cuda(stt, stt.compiler.tree_map(
        lambda a: a.expand((v,) + a.shape).contiguous(),
        compiled.init_state()))
    rng = np.random.default_rng(31)
    with torch.no_grad():
        lanes, pi, si, floats = kernel.operands(params, state, n, {})
        pf, sf = kernel.float_rows(floats, v, pi.device)
        _, _, _, ck = kernel.run_fwd(pf, pi, sf, si, lanes, v, n)
        cta = torch.from_numpy(rng.standard_normal((v, 1, n)).astype(
            np.float32)).cuda()
        ctf = torch.from_numpy(rng.standard_normal(
            (max(kernel.layout.n_sf, 1), v)).astype(np.float32)).cuda()
        times, outs = _turns(kernel, twin, lambda k: k.run_bwd(
            pf, pi, lanes, ck, cta, ctf, v, n))
    check(_same_nan(outs["split"], outs["one"]), "K10's split backward "
          "differs from its one-thread twin")
    flowing = int((outs["one"][0].abs().amax(dim=1) > 0).sum())
    one_ms, split_ms = min(times["one"]), min(times["split"])
    # the same backward with checkpoints every 64 samples: half the scratch
    k64 = VJP_AB["t_chunk 64"]
    with torch.no_grad():
        ck64 = k64.run_fwd(pf, pi, sf, si, lanes, v, n)[3]
        t64_ms = cuda_ms(lambda: k64.run_bwd(pf, pi, lanes, ck64, cta, ctf,
                                             v, n), warmup=1)
        check(_same_nan(k64.run_bwd(pf, pi, lanes, ck64, cta, ctf, v, n),
                        outs["split"]), "K10's backward at t_chunk 64 "
              "differs")
    del ck64
    sh = kernel.shape
    rec = {"twin_ms": one_ms, "ms": split_ms, "ratio": split_ms / one_ms,
           "shape": [v, n], "stages": kernel.partition.n_stages,
           "stage_ops": list(kernel.partition.costs),
           "replays": sh.replays, "chunk": sh.chunk,
           "t_chunk": kernel.t_chunk, "smem_bytes": sh.nbytes,
           "scratch_bytes": 4 * int(np.prod(kernel.scratch_shape(v, n))),
           "registers": registers(kernel.bwd),
           "twin_registers": registers(twin.bwd),
           "t_chunk_64_ms": t64_ms,
           "t_chunk_64_scratch_bytes": 4 * int(np.prod(
               k64.scratch_shape(v, n)))}
    log(f"[15 a/b] K10 backward, training voice V={v} n={n}: twin "
        f"{one_ms:.3f} ms ({times['one'][0]:.3f}, {times['one'][1]:.3f}; "
        f"{rec['twin_registers']} registers), split {split_ms:.3f} ms "
        f"({times['split'][0]:.3f}, {times['split'][1]:.3f}; "
        f"{bwd_form(kernel)}, scratch {rec['scratch_bytes']} B, "
        f"{rec['registers']} registers): split / twin = {rec['ratio']:.3f}; "
        f"dpf and dsf equal bit for bit ({flowing} param rows non-zero); "
        f"at t_chunk 64 (scratch {rec['t_chunk_64_scratch_bytes']} B) "
        f"{t64_ms:.3f} ms, equal bit for bit [{card}]")
    del outs, ck, cta
    torch.cuda.empty_cache()
    return rec


def k10_fwd_ab(stt, card) -> dict:
    """K10's split forward against its one-thread twin at the training
    width, 1,024 voices x 48,000 samples, on the training voice from
    farm_params and from phase 14's trained params (the initial state):
    audio, final state and checkpoints equal bit for bit, both timed in one
    call in turns (twin, split, split, twin); the split forward at the
    chunks of ``FWD_SWEEP_CHUNKS`` that fit, each timed once and held to
    it."""
    patch, compiled, kernel = VJP["train"]
    twin = VJP_AB["train"]
    check(not kernel.fwd_twin and twin.fwd_twin
          and twin.fwd.name == "fused_vjp_fwd_twin",
          "K10's forward pair is not the split kernel and its twin")
    v, n = VOICES, TRAIN_N
    state = _cuda(stt, stt.compiler.tree_map(
        lambda a: a.expand((v,) + a.shape).contiguous(),
        compiled.init_state()))
    rec = {"shape": [v, n], "stages": kernel.fwd_partition.n_stages,
           "stage_ops": list(kernel.fwd_partition.costs),
           "chunk": kernel.fwd_chunk, "t_chunk": kernel.t_chunk,
           "smem_bytes": kernel.fwd_smem_bytes,
           "registers": registers(kernel.fwd),
           "twin_registers": registers(twin.fwd)}
    for cell, params in (("farm_params", _cuda(
            stt, stt.presets.farm_params(patch, v))),
            ("phase 14's params", TRAIN_PARAMS)):
        check(bool(params), f"K10 forward a/b: no {cell}")
        with torch.no_grad():
            lanes, pi, si, floats = kernel.operands(params, state, n, {})
            pf, sf = kernel.float_rows(floats, v, pi.device)

            def run(k):
                return k.run_fwd(pf, pi, sf, si, lanes, v, n)
            times, outs = _turns(kernel, twin, run)
            check(_same_nan(outs["split"], outs["one"]), f"K10's split "
                  f"forward differs from its twin ({cell}: audio, final "
                  f"state or checkpoints)")
            chunks = {kernel.fwd_chunk: min(times["split"])}
            for t in FWD_SWEEP_CHUNKS:
                k = VJP_AB.get(f"fwd T={t}")
                if k is None:
                    continue
                chunks[t] = cuda_ms(lambda: run(k), warmup=1)
                check(_same_nan(run(k), outs["split"]), f"K10's forward at "
                      f"T={t} differs ({cell})")
        sounding = int((outs["one"][0].abs().amax(dim=(1, 2)) > 0).sum())
        one_ms, split_ms = min(times["one"]), min(times["split"])
        rec[cell] = {"twin_ms": one_ms, "ms": split_ms,
                     "ratio": split_ms / one_ms,
                     "ms_by_chunk": {str(t): ms for t, ms in
                                     sorted(chunks.items())}}
        log(f"[15 a/b] K10 forward, training voice, {cell}, V={v} n={n}: "
            f"twin {one_ms:.3f} ms ({times['one'][0]:.3f}, "
            f"{times['one'][1]:.3f}; {rec['twin_registers']} registers), "
            f"split {split_ms:.3f} ms ({times['split'][0]:.3f}, "
            f"{times['split'][1]:.3f}; {fwd_form(kernel)}, "
            f"{rec['registers']} registers): split / twin = "
            f"{split_ms / one_ms:.3f}; audio, final state and "
            f"{outs['one'][3].shape[0]} checkpoint rows equal bit for bit "
            f"({sounding} voices not silent); by chunk: " + ", ".join(
                f"T={t} {ms:.3f} ms" for t, ms in sorted(chunks.items()))
            + f" [{card}]")
        del outs, lanes, pi, si, floats, pf, sf
        torch.cuda.empty_cache()
    log(f"[15 a/b] K10 forward ptxas: split {ptxas(kernel.fwd)}; twin "
        f"{ptxas(twin.fwd)}")
    return rec


K9_TILES = (32, 64, 128, 256)   # positions a tile, timed in phase 15


def k9_tiles(stt, cell, patch, automation, card) -> dict:
    """K9 on the very operands of both K9 calls of one render (1,024
    voices x 480,000 samples, caught at the wrapper, the render going on):
    rings -> the Freeverb kernel's lines with the voices' write indices
    ("in"), and lines -> rings with a shift per line ("out").  The tile at
    every length of ``K9_TILES``, into buffers of its own, timed alone
    (arguments made once, a mean over 20 launches) and equal bit for bit
    to the plain gather (and transpose)."""
    from srack_tpu_torch.ops import ring_roll as rr
    params = stt.presets.farm_params(patch, VOICES)
    recs = {}
    move = rr.RING_ALIGN.move

    def hook(src, dst, lens, v, idx=None, shifts=None, src_lines=False,
             dst_lines=False):
        which = "out" if src_lines else "in"
        kw = dict(idx=idx, shifts=shifts, src_lines=src_lines,
                  dst_lines=dst_lines)
        want = []
        for j, line in enumerate(src):
            start = torch.full((v,), 0 if shifts is None else int(shifts[j]),
                               dtype=torch.int64, device=line.device)
            if idx is not None:
                start += idx[j]
            w = rr.ring_align_plain(line.T if src_lines else line, start)
            want.append(w.T if dst_lines else w)
        by_tile, chosen = {}, rr.RING_ALIGN.tile
        try:
            for p in K9_TILES:
                rr.RING_ALIGN.tile = p
                got = [torch.empty_like(d) for d in dst]
                by_tile[str(p)] = cuda_ms(k9_call(
                    rr.RING_ALIGN, src, got, lens, v, **kw), repeats=20,
                    warmup=1)
                check(_same(got, want), f"K9 {cell} {which}: the tile of "
                      f"{p} positions differs from the plain gather")
                del got
        finally:
            rr.RING_ALIGN.tile = chosen
        ms = by_tile[str(chosen)]
        b_ms = _bound(8 * v * sum(lens) + (4 * idx.numel() if idx is not None
                                           else 0), 0)[0]
        recs[which] = {"ms": ms, "bound_ms": b_ms, "ms_by_tile": by_tile,
                       **K9_SHAPE}
        log(f"[15 a/b] K9 {cell} {which} ({'lines -> rings, a shift per '
            'line' if src_lines else 'rings -> lines, per-voice indices'}) "
            f"V={v}, 24 lines: tile {ms:.4f} ms (32 voices x {chosen} "
            f"positions), {100 * b_ms / ms:.1f} % of its bound {b_ms:.4f} "
            f"ms; by tile: " + ", ".join(f"{p} {t:.4f} ms" for p, t in
                                         by_tile.items())
            + f"; each equal to the plain gather bit for bit [{card}]")
        del want
        return move(src, dst, lens, v, **kw)
    rr.RING_ALIGN.move = hook
    try:
        stt.render_batch(patch, HEADLINE_N, params=params,
                         automation=automation)
    finally:
        del rr.RING_ALIGN.move
    check(set(recs) == {"in", "out"}, f"the {cell} render made K9 calls "
          f"{sorted(recs)}")
    torch.cuda.empty_cache()
    return recs


def k7_tiles(stt, name, card) -> list:
    """K7 on the very operands of every Sample launch of one kit render
    (1,024 voices x 480,000 samples, caught at the wrapper): the gate (and
    CV) as given, the stage's transposed view, timed after a warm-up; on
    the first launch also at every tile shape of ``TILE_SHAPES``, each
    equal bit for bit to the main path's shape (the order of combination
    is one of positions, not of threads).  Returns a record per launch."""
    from srack_tpu_torch.ops import sample_kernel as sk
    patch = getattr(stt.presets, name)(stt.AudioConfig(sample_rate=SR,
                                                       channels=1))
    params = stt.presets.farm_params(patch, VOICES)
    tile = sk.TILE_SHAPES[sk.SAMPLE_PLAY.shape]
    recs = []
    run = sk.SAMPLE_PLAY.run

    def hook(*args):
        out = run(*args)
        ms = cuda_ms(lambda: run(*args), warmup=1)
        layout = ("[R, n] rows" if args[0].stride(1) == 1
                  else "a transposed view")
        recs.append({"ms": ms, "gate": layout, "cv": args[1] is not None,
                     "k": args[2].shape[1], "tile": list(tile)})
        if len(recs) == 1:   # every tile shape of the entry, in turn
            chosen, by_tile = sk.SAMPLE_PLAY.shape, {}
            try:
                for i, shp in enumerate(sk.TILE_SHAPES):
                    sk.SAMPLE_PLAY.shape = i
                    by_tile[str(shp)] = cuda_ms(lambda: run(*args), warmup=1)
                    check(_same(run(*args), out), f"K7 {name}: tile {shp} "
                          f"differs from tile {tile}")
            finally:
                sk.SAMPLE_PLAY.shape = chosen
            recs[-1]["ms_by_tile"] = by_tile
            log(f"[15 a/b] K7 {name} launch 1, tile shapes (voices a CTA, "
                f"warps a voice): " + ", ".join(
                    f"{k} {t:.3f} ms" for k, t in by_tile.items())
                + f"; each equal to {tile} bit for bit [{card}]")
        log(f"[15 a/b] K7 {name} launch {len(recs)} (K={args[2].shape[1]}, "
            f"{'CV' if args[1] is not None else 'constant rate'}, the gate "
            f"{layout}) V={VOICES} n={args[0].shape[1]}: {ms:.3f} ms on the "
            f"render's operands ({tile[0]} voices a CTA, {tile[1]} warps a "
            f"voice) [{card}]")
        return out
    sk.SAMPLE_PLAY.run = hook
    try:
        stt.render_batch(patch, HEADLINE_N, params=params)
    finally:
        del sk.SAMPLE_PLAY.run
    check(recs, f"the {name} render did not reach K7")
    torch.cuda.empty_cache()
    return recs


def k8_cells(stt) -> dict:
    """The renders that give K8 its main-path operands: reverb_patch
    (stereo; phase 9) and block_check_patch (mono, automated room_size and
    wet; phase 10), 1,024 voices x 480,000 samples: ``{cell: (patch,
    automation)}``."""
    reverb = stt.presets.reverb_patch(stt.AudioConfig(sample_rate=SR,
                                                      channels=2))
    check_patch, _ = stt.presets.block_check_patch(
        stt.AudioConfig(sample_rate=SR, channels=1))
    return {"reverb": (reverb, None),
            "block check": (check_patch, block_check_automation(
                stt, check_patch, HEADLINE_N))}


class _Captured(Exception):
    """Ends a render once a hook holds the arguments it wanted."""


@contextlib.contextmanager
def captured(owner, attr: str, keep: dict):
    """While open, the first call of ``owner.attr`` stores its positional
    and keyword arguments in ``keep`` and ends the render."""
    def hook(*args, **kwargs):
        keep.update(args=args, kwargs=kwargs)
        raise _Captured
    saved = owner.__dict__[attr]
    setattr(owner, attr, hook)
    try:
        yield keep
    except _Captured:
        pass
    finally:
        setattr(owner, attr, saved)


def k8_ab(stt, cell, patch, automation, card) -> dict:
    """The shared-memory K8 against its one-thread twin on the very
    operands the cell's render gives K8 ([1,024, 480,000], caught at the
    wrapper's launch): audio, filter states and lines equal bit for bit,
    both timed in one call in turns (twin, K8, K8, twin), the better of
    two calls each."""
    from srack_tpu_torch.ops import freeverb_kernel as fvk
    params = stt.presets.farm_params(patch, VOICES)
    keep = {}
    with captured(fvk.FreeverbKernel, "launch_lines", keep):
        stt.render_batch(patch, HEADLINE_N, params=params,
                         automation=automation)
    check("args" in keep, f"the {cell} render did not reach K8")
    picked, cfg, l_in, r_in, gains, fs, lines, n, skip_r = keep["args"]
    check(picked is fvk.FREEVERB, f"the {cell} render picked "
          f"{picked.name}, not the shared-memory K8")

    def run(kernel):
        f, li = fs.clone(), lines.clone()
        outs = kernel.launch_lines(cfg, l_in, r_in, gains, f, li, n, skip_r)
        return tuple(x for x in (*outs, f, li) if x is not None)
    times, outs = _turns(fvk.FREEVERB, fvk.FREEVERB_TWIN, run)
    check(_same(outs["split"], outs["one"]), f"K8 {cell}: the shared-memory "
          f"kernel differs from its one-thread twin")
    one_ms, k8_ms = min(times["one"]), min(times["split"])
    check(k8_ms < one_ms, f"K8 {cell}: {k8_ms:.3f} ms, not faster than its "
          f"twin's {one_ms:.3f}")
    lanes = [name for name, x in (("dampening", gains[0]), ("room_size",
             gains[1]), ("wet1", gains[3]), ("wet2", gains[4]),
             ("dry", gains[5])) if x.shape[-1] == n]
    rec = {"twin_ms": one_ms, "ms": k8_ms, "ratio": k8_ms / one_ms,
           "shape": [VOICES, n], "stereo_out": not skip_r,
           "lanes": lanes, "registers": registers(fvk.FREEVERB), **K8_SHAPE}
    log(f"[15 a/b] K8 {cell} V={VOICES} n={n} (the render's operands, "
        f"{'stereo' if not skip_r else 'mono'} out, automated "
        f"{lanes or 'none'}): twin {one_ms:.3f} ms ({times['one'][0]:.3f}, "
        f"{times['one'][1]:.3f}), shared-memory K8 {k8_ms:.3f} ms "
        f"({times['split'][0]:.3f}, {times['split'][1]:.3f}; T="
        f"{K8_SHAPE['tile']}, {K8_SHAPE['smem_bytes']} B shared memory, "
        f"{K8_SHAPE['ctas_per_sm']} CTAs per SM): K8 / twin = "
        f"{rec['ratio']:.4f}; audio, filter states and lines equal bit "
        f"for bit; ptxas: {ptxas(fvk.FREEVERB)} [{card}]")
    del outs, keep
    torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def no_scan_engine():
    """While open, the scan engine raises."""
    from srack_tpu_torch.compiler import CompiledPatch

    def fenced(*args, **kwargs):
        raise SmokeFailure("a render ran the scan engine")
    run = CompiledPatch._run
    CompiledPatch._run = fenced
    try:
        yield
    finally:
        CompiledPatch._run = run


def _counted(kernels, call):
    """``call()`` with every launch count set to 0 just before it;
    returns ``(result, {kernel name: launches})`` of the kernels that
    launched."""
    counters = _counters(kernels)
    for k in counters:
        k.launches = 0
    result = call()
    torch.cuda.synchronize()
    counts = {}
    for k in counters:
        if k.launches:
            counts[k.name] = counts.get(k.name, 0) + k.launches
    return result, counts


def phase_one_voice(stt, kernels, card) -> dict:
    """Phase 16: one unbatched voice through the entry points on the card,
    the scan engine fenced off.  subtractive_voice (48 kHz, mono, its
    default params): ``stt.render`` of 1 s must launch K1 once and no other
    kernel (timed after a warm-up); its first 4,800 samples equal the
    scan engine's unbatched render on the card bit for bit, and the 1 s
    render must take under 1 % of the scan engine's time for it, estimated
    from the scan engine's per-sample cost there; ``render_stream``
    without ``voices=`` (4 blocks), ``render_long(batched=False)`` (4
    segments) and a one-patch ``render_many`` launch K1 once per block,
    segment or call and equal the one render bit for bit.  reverb_patch
    (stereo) the same way through the block engine (K3, K8, K9, no K1),
    1,024 samples from a gate clock that sounds at once within 5e-6 of the
    scan engine, and its pieces within 5e-6 of the one render.  Returns the
    launches by entry point and the times."""
    cfg1 = stt.AudioConfig(sample_rate=SR, channels=1)
    rec = {}
    # the launches of one render: K9 twice (the Freeverb wrapper's way in
    # and out)
    for name, patch, per_render, n_scan in (
            ("subtractive_voice", stt.presets.subtractive_voice(cfg1),
             {"fused_voice": 1}, ONE_SCAN_N),
            ("reverb_patch", stt.presets.reverb_patch(
                stt.AudioConfig(sample_rate=SR, channels=2)),
             {"serial_stage": 1, "freeverb": 1, "ring_align": 2},
             ONE_REVERB_N)):
        compiled = stt.compile_patch(patch)
        block = compiled.cfg.block_size
        with no_scan_engine():
            stt.render(patch, ONE_N)     # warm-up
            (audio, _, _), counts = _counted(
                kernels, lambda: stt.render(patch, ONE_N))
            ms = cuda_ms(lambda: stt.render(patch, ONE_N))
            launches = {"render": counts}
            streamed, counts = _counted(kernels, lambda: [
                a for a, _, _ in stt.render_stream(patch, n_blocks=4)])
            launches["render_stream"] = counts
            long_audio, counts = _counted(kernels, lambda: stt.render_long(
                patch, ONE_N, segment=ONE_N // 4)[0])
            launches["render_long"] = counts
            many, counts = _counted(
                kernels, lambda: stt.render_many([patch], ONE_N)[0])
            launches["render_many"] = counts
        for entry, counts in launches.items():
            calls = 4 if entry in ("render_stream", "render_long") else 1
            want = {k: calls * c for k, c in per_render.items()}
            check(counts == want, f"{name}: one voice through {entry} "
                  f"launched {counts}, not {want}")
        check(tuple(audio.shape) == (compiled.cfg.channels, ONE_N)
              and audio.device.type == "cuda", f"{name}: one voice's audio "
              f"{tuple(audio.shape)} on {audio.device}")
        check(bool(torch.isfinite(audio).all()), f"{name}: not finite")
        peak = audio.abs().max().item()
        check(0 < peak <= PEAK_MAX, f"{name}: one voice's peak {peak}")
        # K1 carries its state exactly; the block engine's pieces agree
        # with one render within its tolerance (tests/test_block_engine.py)
        tol = 0.0 if name == "subtractive_voice" else BLOCK_ATOL
        pieces = {}
        for entry, got, want in (
                ("render_stream", torch.cat(streamed, dim=-1),
                 audio[..., :4 * block]),
                ("render_long", long_audio, audio.cpu()),
                ("render_many", many, audio)):
            check(got.shape == want.shape, f"{name}: {entry} shape")
            pieces[entry] = (got - want).abs().max().item()
            check(pieces[entry] <= tol, f"{name}: {entry} off render by "
                  f"{pieces[entry]}")
        del streamed, long_audio, many
        # the voice's first 4,800 samples sound from ~2,500 on; reverb_patch
        # is held from its gate clock at a phase where it sounds at once
        state, prefix = None, audio[..., :n_scan]
        if name == "reverb_patch":
            clock = next(i.id for i in patch if i.name == "gate_clock")
            state = compiled.init_state()
            state["states"][clock]["pos"] = torch.tensor(-2 ** 30,
                                                          dtype=torch.int32)
            with no_scan_engine():
                prefix = stt.render(patch, n_scan, state=state)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            scan, _, _ = stt.render(patch, n_scan, state=state,
                                    engine="scan")
        torch.cuda.synchronize()
        scan_s = time.perf_counter() - t0
        per_sample_ms = 1e3 * scan_s / n_scan
        est_ms = per_sample_ms * ONE_N
        err = (prefix - scan).abs().max().item()
        exact = torch.equal(prefix, scan)
        sounding = int((scan != 0).sum())
        check(sounding > 0, f"{name}: the held prefix is silent")
        if name == "subtractive_voice":
            check(exact, f"{name}: one voice's first {n_scan} samples off "
                  f"the scan engine by {err}")
        check(err <= BLOCK_ATOL, f"{name}: one voice off the scan engine "
              f"by {err}")
        check(ms < 0.01 * est_ms, f"{name}: one voice for 1 s took {ms} ms, "
              f"not under 1 % of the scan engine's ~{est_ms:.0f} ms")
        log(f"[16 one voice] {name} one voice, 1 s at {SR} Hz, via "
            f"stt.render on the card (scan engine fenced off): launches "
            f"{launches['render']}, {ms:.3f} ms; the scan engine on the "
            f"card renders its first {n_scan} samples in {scan_s:.2f} s "
            f"({per_sample_ms:.3f} ms per sample, so ~{est_ms / 1e3:.1f} s "
            f"for 1 s): {100 * ms / est_ms:.4f} % of it; max |err| against "
            f"it {err:.3e} (bit-exact: {exact}, {sounding} samples not "
            f"silent{', from a sounding gate clock' if state else ''}); "
            f"render_stream (4 blocks of {block}) "
            f"{launches['render_stream']}, render_long (4 segments) "
            f"{launches['render_long']}, render_many (one patch) "
            f"{launches['render_many']}, off render by at most "
            f"{max(pieces.values()):.3e} (tolerance {tol}); peak {peak:.5f} "
            f"[{card}]")
        rec[name] = {"ms": ms, "scan_ms_per_sample": per_sample_ms,
                     "scan_est_ms": est_ms, "launches": launches,
                     "bit_exact": exact, "max_abs_err": err}
    return rec

# -- slice 10: exact precision: the f64 builds of K3, K4, K8 and K9 ----------

EXACT_NAMES = ("subtractive_voice", "reverb_patch", "feedback_patch")
EXACT_CHECK_NAMES = ("subtractive_voice", "feedback_patch",
                     "reverb_patch") + KIT_NAMES
EXACT_N = HEADLINE_N    # 10 s at 48 kHz
EXACT_SEGMENT = 96000   # bench.py's exact rung (bench.py:266-292)
EXACT_PREFIX = 1024     # held to the exact scan engine on the card
EXACT_CHECK_N = 1024    # phase 3's exact block-vs-scan length at 4,800 Hz
DRIFT_N = 48000         # fast against exact over 1 s (tests/test_precision)
DRIFT_TOL = 1e-3
EXACT_STAGES = {}       # (case, rate) -> K3 of an exact stage
EXACT_TIMES = {}        # f64 build -> its check-shape times and bound
_EXACT = {}


def f64_libs() -> list:
    """The fixed sources' f64 builds, each with a launch count of its own:
    K4 (row_scan_f64), K8 and its twin (freeverb_f64, freeverb_twin_f64)
    and K9 (ring_align_f64)."""
    from srack_tpu_torch.ops.freeverb_kernel import (FREEVERB_F64,
                                                     FREEVERB_TWIN_F64)
    from srack_tpu_torch.ops.ring_roll import RING_ALIGN_F64
    from srack_tpu_torch.ops.scan_kernel import ROW_SCAN_F64
    return [ROW_SCAN_F64, FREEVERB_F64, FREEVERB_TWIN_F64, RING_ALIGN_F64]


def exact_cases(stt) -> dict:
    """Exact precision's patches, compiled once: ``(name, 48000)`` for
    phase 17's paths and ``(name, 4800)`` for phase 3's block-vs-scan
    checks (reverb_patch stereo, the others mono)."""
    if not _EXACT:
        for names, rate in ((EXACT_NAMES, SR), (EXACT_CHECK_NAMES, KIT_SR)):
            for name in names:
                patch = getattr(stt.presets, name)(stt.AudioConfig(
                    sample_rate=rate, precision="exact",
                    channels=2 if name == "reverb_patch" else 1))
                _EXACT[(name, rate)] = (patch, stt.compile_patch(patch))
    return _EXACT


def exact_kernels(stt) -> dict:
    """K3 for each exact case's stage (``EXACT_STAGES``), for phase 2's
    build; a patch whose exact stage is empty (sampler_kit: no seed in
    exact precision) has none."""
    jobs = {}
    for key, (_, compiled) in exact_cases(stt).items():
        prog = compiled.block_program()
        if not prog.stage_plan:
            continue
        EXACT_STAGES[key] = prog.stage_kernel(stage_lane_keys(prog))
        jobs[f"exact {key[0]} {key[1]} Hz stage"] = EXACT_STAGES[key]
    return jobs


def exact_shapes(stt) -> None:
    """Build the fixed sources' f64 builds (entries of the f32 builds'
    libraries, found by hash) and log K8's f64 shape at 48 kHz: T, shared
    memory, CTAs per SM (the card's occupancy query)."""
    from srack_tpu_torch.ops import freeverb_kernel as fvk
    for lib in f64_libs():
        lib.build()
    lens = fvk.all_lengths(stt.AudioConfig(sample_rate=SR))
    tile = fvk.tile_for(lens, 8)
    ctas = ctypes.c_int(-1)
    fn = fvk.FREEVERB_F64.build().srk_freeverb_ctas_per_sm_f64
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], \
        ctypes.c_int
    check(fn(sum(lens), tile, ctypes.byref(ctas)) == 0,
          "K8's f64 occupancy query failed")
    K8_SHAPE.update(f64_tile=tile, f64_ctas_per_sm=ctas.value,
                    f64_smem_bytes=fvk.tile_bytes(lens, tile, 8))
    log(f"[2 build] f64 builds (entries of the same libraries): "
        + ", ".join(lib.name for lib in f64_libs())
        + f"; freeverb_f64 at {SR} Hz: T={tile}, "
        f"{K8_SHAPE['f64_smem_bytes']} B shared memory, {ctas.value} CTAs "
        f"per SM")


def _bound2(nbytes, ops32, ops64):
    """The larger of the bytes over bandwidth and the operations over the
    peaks of their types (f32 at 67, f64 at 34 TFLOP/s)."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ops32 / PEAK_F32 + ops64 / PEAK_F64
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, nbytes, ops32 + ops64


def stage_bound_f64(compiled, kernel, v, n):
    """K3's bound with f64 leaves: its f32 rows and lanes at 4 bytes, its
    double rows at 8, the exact Oscillator's f64 operations over the f64
    peak and the rest over the f32 peak."""
    from srack_tpu_torch.ops.partition import module_ops_f64
    lay = kernel.layout
    rows = lay.n_pf + lay.n_pi + 2 * (lay.n_sf + lay.n_si)
    wires = len(kernel.lanes) + len(kernel.program.stage_out)
    nbytes = v * (4 * rows + 8 * (lay.n_pd + 2 * lay.n_sd) + 4 * wires * n)
    plan = kernel.program.stage_plan
    ops64 = sum(module_ops_f64(compiled, m) for m in plan) * v * n
    ops32 = sum(module_ops(compiled, m) for m in plan) * v * n - ops64
    return _bound2(nbytes, ops32, ops64)


def freeverb_bound_f64(lens, v, n, lanes_in, lanes_out):
    """K8's f64 bound: f32 lanes, f64 lines and filter states in and out,
    FV_OPS f64 operations per voice-sample."""
    nbytes = v * (4 * (lanes_in + lanes_out) * n + 16 * (sum(lens) + 16))
    return _bound2(nbytes, 0, FV_OPS * v * n)


def compare_scans_f64():
    """K4's f64 build on [1,024, 48,000] f64 rows (an increment's range,
    [0, 0.1)): the sum within 1e-12 relative of the log-doubling form, the
    max exact, fills of one and two arrays exact where a value is
    defined; times the sum, its plain version and torch.cumsum."""
    from srack_tpu_torch.ops import basic
    from srack_tpu_torch.ops.scan_kernel import ROW_SCAN, ROW_SCAN_F64
    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    shape = (SCAN_ROWS, SCAN_N)
    x = torch.from_numpy(rng.uniform(0.0, 0.1, shape)).cuda()
    y = torch.from_numpy(rng.standard_normal(shape)).cuda()
    mask = torch.from_numpy(rng.uniform(size=shape) < 1e-3).cuda()
    got, = ROW_SCAN_F64.run("sum", (x,))
    want = basic.cumsum_plain(x)
    rel = ((got - want).abs() / want.abs().clamp(min=1e-300)).max().item()
    check(rel <= F64_SUM_TOL, f"K4 f64 sum: relative error {rel}")
    err = (got - want).abs().max().item()
    got, = ROW_SCAN_F64.run("max", (y,))
    check(torch.equal(got, basic.cummax_plain(y)), "K4 f64 max: not exact")
    for vals in ((x,), (x, y)):
        filled, ok = ROW_SCAN.fill(vals, mask)
        want_f, want_ok = basic.forward_fill_multi_plain(vals, mask)
        check(torch.equal(ok, want_ok), "K4 f64 fill: validity differs")
        for g, w in zip(filled, want_f):
            check(torch.equal(g[ok], w[ok]), "K4 f64 fill: not exact")
    EXACT_TIMES["row_scan_f64"] = (
        cuda_ms(lambda: ROW_SCAN_F64.run("sum", (x,)), repeats=20),
        cuda_ms(lambda: basic.cumsum_plain(x), repeats=3),
        cuda_ms(lambda: torch.cumsum(x, dim=-1), repeats=20),
        _bound2(16 * x.numel(), 0, x.numel()),
        f"f64 sum [{SCAN_ROWS}, {SCAN_N}] (library: torch.cumsum)")
    log(f"[3 compare] row_scan_f64 [{SCAN_ROWS}, {SCAN_N}]: sum max abs err "
        f"{err:.3e} (max relative {rel:.3e}, tolerance 1e-12 relative), max "
        f"exact, fills x1 and x2 exact where a value is defined; "
        f"{time.perf_counter() - t0:.1f} s")
    return err


def compare_freeverb_twin_f64(stt, n):
    """K8's two f64 entries on the same operands (random rings and filter
    states, the wrapper's K9 in): the shared-memory entry and the twin
    equal bit for bit."""
    from srack_tpu_torch.modules import freeverb as fv
    from srack_tpu_torch.ops import freeverb_kernel as fvk
    cfg, gains, state, l_in, r_in = _freeverb_inputs(stt, n, True, n + 1,
                                                     True)
    lens = fvk.all_lengths(cfg)
    idx = torch.stack([state[f"{k}_idx"] for k in fv.LINE_KEYS]).to(
        torch.int32).contiguous()
    outs = []
    for kernel in (fvk.FREEVERB_F64, fvk.FREEVERB_TWIN_F64):
        lines = torch.cat(ring_to_lines([state[k] for k in fv.LINE_KEYS],
                                        lens, idx)).contiguous()
        fs = torch.stack([state[k] for k in fv.FS_KEYS], dim=1).contiguous()
        o = kernel.launch_lines(cfg, l_in, r_in, gains, fs, lines, n)
        outs.append((*o, fs, lines))
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    check(same, "K8's f64 entries differ")
    log(f"[3 compare] freeverb_f64 and freeverb_twin_f64 V={VOICES} n={n}, "
        f"automated room_size and wet: audio, filter states and lines bit "
        f"for bit equal")


def compare_exact_stage(stt, key, n):
    """An exact stage's K3 against its torch loop at 48 kHz, from random
    f64 phases: outputs within 1e-6, f64 state within 1e-12, f32 state
    within 1e-6, int32/bool exact; both timed (CUDA events)."""
    t0 = time.perf_counter()
    patch, compiled = exact_cases(stt)[key]
    prog = compiled.block_program()
    kernel = EXACT_STAGES[key]
    rng = np.random.default_rng(n)
    params = _cuda(stt, stt.presets.farm_params(patch, VOICES))
    state = _random_state(stt, compiled, VOICES, n)
    stage_state = {"states": {m: state["states"][m]
                              for m in prog.stage_plan}, "fb": state["fb"]}
    lanes = {k: torch.from_numpy(rng.uniform(-1, 1, (VOICES, n)).astype(
        np.float32)).cuda() for k in kernel.lanes}
    derived = compiled.derived_params(params)
    plain_params = {m: derived[m] for m in prog.stage_plan}
    res = {}
    k_ms = cuda_ms(lambda: res.update(k=kernel.run(params, stage_state,
                                                   lanes, n)), warmup=1)
    with torch.no_grad():
        p_ms = cuda_ms(lambda: res.update(p=prog.stage_plain(
            plain_params, stage_state, lanes, n)))
    (outs_k, final_k), (outs_p, final_p) = res["k"], res["p"]
    err, exact = 0.0, True
    for w in prog.stage_out:
        check(bool(torch.isfinite(outs_p[w]).all()),
              f"exact {key[0]} stage plain version not finite")
        err = max(err, (outs_k[w] - outs_p[w]).abs().max().item())
        exact = exact and torch.equal(outs_k[w], outs_p[w])
    check(err <= 1e-6, f"exact {key[0]} stage n={n}: outputs off by {err}")
    serr64 = 0.0
    for mid, sd in final_p["states"].items():
        for k, w in sd.items():
            g = final_k["states"][mid][k]
            where = f"exact {key[0]} stage state {mid}.{k}"
            check(g.shape == w.shape and g.dtype == w.dtype, where)
            if w.dtype in (torch.int32, torch.bool):
                check(torch.equal(g, w), f"{where}: not exact")
                continue
            d = (g - w).abs().max().item()
            check(d <= (1e-12 if w.dtype == F64 else 1e-6), f"{where}: {d}")
            if w.dtype == F64:
                serr64 = max(serr64, d)
    if kernel.layout.doubles:
        EXACT_TIMES["serial_stage_f64"] = (
            k_ms, p_ms, None, stage_bound_f64(compiled, kernel, VOICES, n),
            f"exact {key[0]} stage V={VOICES} n={n}")
    log(f"[3 compare] exact {key[0]} stage ({kernel.name}"
        f"{pipeline(kernel)}, {len(prog.stage_plan)} modules) V={VOICES} "
        f"n={n}: max |out| err {err:.3e} (bit-exact: {exact}), max f64 "
        f"state err {serr64:.3e}; kernel {k_ms:.3f} ms, plain version "
        f"{p_ms:.1f} ms; {time.perf_counter() - t0:.1f} s")
    return err


def phase_compare_exact(stt) -> dict:
    """Phase 3 for exact precision: each f64 build against its plain
    version on the card, and the exact block engine against the exact
    scan engine at 4,800 Hz.  Returns each build's largest error."""
    from srack_tpu_torch.modules import freeverb as fv
    from srack_tpu_torch.ops import freeverb_kernel as fvk
    from srack_tpu_torch.ops.ring_roll import RING_ALIGN_F64, ring_align_plain
    errs = {"row_scan_f64": compare_scans_f64(),
            "ring_align_f64": compare_ring(stt, f64=True)}
    errs["freeverb_f64"] = max(compare_freeverb(stt, n, automated, True)
                               for n in CHECK_NS
                               for automated in (False, True))
    compare_freeverb_twin_f64(stt, CHECK_NS[0])
    errs["serial_stage_f64"] = max(
        compare_exact_stage(stt, ("feedback_patch", SR), n)
        for n in PLAIN_NS)
    compare_exact_stage(stt, ("subtractive_voice", SR), PLAIN_NS[0])
    for name in EXACT_CHECK_NAMES:
        compare_kit_engine(stt, name, "exact",
                           case=exact_cases(stt)[(name, KIT_SR)],
                           n=EXACT_CHECK_N)
    # the f64 builds' plain versions at phase 3's shapes (K3's came with its
    # comparison)
    n = CHECK_NS[0]
    cfg, gains, state, l_in, r_in = _freeverb_inputs(stt, n, False, n, True)
    EXACT_TIMES["freeverb_f64"] = (
        cuda_ms(lambda: fvk.render(cfg, l_in, r_in, False, gains, state, n),
                repeats=20, warmup=1),
        cuda_ms(lambda: fv.block_plain(l_in, r_in, gains, state, n),
                repeats=3), None,
        freeverb_bound_f64(fvk.all_lengths(cfg), VOICES, n, 2, 2),
        f"V={VOICES} n={n}, stereo in, the wrapper (K9 in, K8, K9 out)")
    lens, rings, idx = _ring_inputs(stt, True)
    lines = [torch.empty((m, VOICES), dtype=F64, device="cuda")
             for m in lens]
    gidx = [((idx[j].to(torch.int64) + torch.arange(
        length, device="cuda").unsqueeze(-1)) % length)
        for j, length in enumerate(lens)]
    EXACT_TIMES["ring_align_f64"] = (
        cuda_ms(k9_call(RING_ALIGN_F64, rings, lines, lens, VOICES, idx=idx,
                        dst_lines=True), repeats=20, warmup=1),
        cuda_ms(lambda: [ring_align_plain(r, idx[j]).T.contiguous()
                         for j, r in enumerate(rings)], repeats=5),
        cuda_ms(lambda: [torch.gather(r.T, 0, g)
                         for r, g in zip(rings, gidx)], repeats=20),
        _bound2(16 * VOICES * sum(lens) + 4 * idx.numel(), 0, 0),
        f"24 f64 lines x {VOICES} voices, rings -> lines, the launch alone "
        f"(library: torch.gather)")
    return errs


def _exact_split(stt, name, compiled, n, launches, total_ms, card) -> dict:
    """Each kernel of one exact render timed alone at its shapes there
    (``n``: the segment), times its launches per render, and the rest."""
    from srack_tpu_torch.block_engine import wire_key
    from srack_tpu_torch.modules import freeverb as fv
    from srack_tpu_torch.ops import freeverb_kernel as fvk
    from srack_tpu_torch.ops.ring_roll import RING_ALIGN_F64
    from srack_tpu_torch.ops.scan_kernel import ROW_SCAN_F64
    prog = compiled.block_program()
    patch = exact_cases(stt)[(name, SR)][0]
    params = _cuda(stt, stt.presets.farm_params(patch, VOICES))
    state = _cuda(stt, stt.compiler.tree_map(
        lambda a: a.expand((VOICES,) + a.shape).contiguous(),
        compiled.init_state()))
    alone, bounds = {}, {}
    kernel = EXACT_STAGES[(name, SR)]
    stage_state = {"states": {m: state["states"][m]
                              for m in prog.stage_plan}, "fb": state["fb"]}
    lanes = {wire_key(w): torch.zeros((VOICES, n), device="cuda")
             for w in prog.stage_in}
    alone[kernel.name] = cuda_ms(
        lambda: kernel.run(params, stage_state, lanes, n), warmup=1)
    bounds[kernel.name] = (stage_bound_f64 if kernel.layout.doubles
                           else stage_bound)(compiled, kernel, VOICES, n)
    lanes.clear()
    if "row_scan_f64" in launches:
        x = torch.full((VOICES, n), 1e-3, dtype=F64, device="cuda")
        alone["row_scan_f64"] = cuda_ms(
            lambda: ROW_SCAN_F64.run("sum", (x,)), warmup=1, repeats=3)
        bounds["row_scan_f64"] = _bound2(16 * x.numel(), 0, x.numel())
        del x
    if "freeverb_f64" in launches:
        verb = next(m for m in compiled.plan
                    if compiled.instances[m][0].type_name == "Freeverb")
        lens = fvk.all_lengths(compiled.cfg)
        sd = state["states"][verb]
        rings = [sd[k] for k in fv.LINE_KEYS]
        idx = torch.zeros((24, VOICES), dtype=torch.int32, device="cuda")
        rows = [torch.empty((m, VOICES), dtype=F64, device="cuda")
                for m in lens]
        alone["ring_align_f64"] = cuda_ms(k9_call(
            RING_ALIGN_F64, rings, rows, lens, VOICES, idx=idx,
            dst_lines=True), repeats=20, warmup=1)
        bounds["ring_align_f64"] = _bound2(
            16 * VOICES * sum(lens) + 4 * 24 * VOICES, 0, 0)
        gains = fv.block_gains(params[verb], VOICES, F64)
        lines = torch.cat(rows).contiguous()
        fs = torch.stack([sd[k] for k in fv.FS_KEYS], dim=1).contiguous()
        lane = torch.zeros((VOICES, n), device="cuda")
        right = prog._outs_used.get(verb, (True, True))[1]
        call, keep = k8_call(compiled.cfg, lane, lane, gains, fs, lines, n,
                             not right)
        alone["freeverb_f64"] = cuda_ms(call, warmup=1)
        bounds["freeverb_f64"] = freeverb_bound_f64(lens, VOICES, n, 1,
                                                    2 if right else 1)
        del rows, lines, call, keep, lane
    torch.cuda.empty_cache()
    rest = total_ms - sum(alone[k] * launches[k] for k in alone)
    for k, (b_ms, b_by, nbytes, ops) in bounds.items():
        log(f"[17 exact] bound of {k} in exact {name} V={VOICES} n={n}: "
            f"{nbytes} bytes, {ops} operations -> {b_ms:.4f} ms ({b_by}); "
            f"alone it takes {alone[k]:.3f} ms, {alone[k] / b_ms:.1f}x its "
            f"bound")
    log(f"[17 exact] split of exact {name} V={VOICES} n={EXACT_N} in "
        f"launches of n={n}: " + ", ".join(
            f"{k} {alone[k]:.3f} ms x {launches[k]}" for k in alone)
        + f", the rest (block phases, the f64 Oscillator forms, transposes, "
        f"wrappers) {rest:.3f} ms of {total_ms:.3f} [{card}]")
    return {"alone_ms": alone, "rest_ms": rest, "n": n,
            "bounds": {k: b[:2] for k, b in bounds.items()}}


def _drift(stt, name, head, card) -> float:
    """The fast render of the same params against the first DRIFT_N
    samples of the exact one (each render's own engine on the card)."""
    channels = 2 if name == "reverb_patch" else 1
    patch = getattr(stt.presets, name)(stt.AudioConfig(
        sample_rate=SR, channels=channels))
    fast, _, _ = stt.render_batch(patch, DRIFT_N,
                                  params=stt.presets.farm_params(patch,
                                                                 VOICES))
    return (fast - head).abs().max().item()


def exact_path(stt, kernels, card, name, segment, names) -> dict:
    """One exact main path at 1,024 voices x 10 s, 48 kHz, through
    ``render_batch`` (engine auto) with the scan engine fenced off: the
    launches of ``names`` must move and no other kernel's; the warm-up
    render holds K4's and K8's f64 builds against their plain versions at
    the shapes it gives them (:func:`held_against_plain`); finite audio,
    peak <= 1.002; timed after a warm-up (CUDA events), its memory peak;
    1,024 samples from random f64 phases within 5e-6 of the exact scan
    engine on the card; the fast render's first 48,000 samples against
    the exact one's; each kernel alone; and, where ``segment`` is set,
    whether one unsegmented render fits the card."""
    patch, compiled = exact_cases(stt)[(name, SR)]
    params = stt.presets.farm_params(patch, VOICES)
    channels = compiled.cfg.channels
    found = {}
    with no_scan_engine():
        audio, ms, launches = _timed_main(
            kernels, lambda: stt.render_batch(patch, EXACT_N, params=params,
                                              segment=segment), names,
            held_against_plain(found))
    if not isinstance(launches, dict):   # one kernel's count
        launches = {names[0]: launches}
    wrapped = {"row_scan_f64", "freeverb_f64"} & set(names)
    check(set(found) == wrapped, f"exact {name}: the warm-up called the "
          f"wrappers of {sorted(found)}, the path launches {sorted(wrapped)}")
    held = _log_held(f"17 exact {name}", found, card)
    mem = PEAK["render"]
    peak = _check_audio(audio, (VOICES, channels, EXACT_N), f"exact {name}")
    head = audio[..., :DRIFT_N].clone()
    del audio
    torch.cuda.empty_cache()
    drift = _drift(stt, name, head, card)
    del head
    # the prefix from random phases (the gate clocks sound at once), the
    # scan engine on the card the reference
    p = _cuda(stt, params)
    state = _random_state(stt, compiled, VOICES, 17)
    with no_scan_engine():
        pre_b, _, _ = compiled.render(EXACT_PREFIX, params=p, state=state,
                                      batched=True, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        pre_s, _ = compiled.render_scan(p, state, EXACT_PREFIX, batched=True,
                                        nograd=True)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    err = (pre_b - pre_s).abs().max().item()
    sounding = int((pre_s != 0).sum())
    check(sounding > 0, f"exact {name}: the held prefix is silent")
    check(err <= BLOCK_ATOL, f"exact {name}: the first {EXACT_PREFIX} "
          f"samples off the exact scan engine by {err}")
    del pre_b, pre_s
    unsegmented = None
    if segment:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            with no_scan_engine():
                a = stt.render_batch(patch, EXACT_N, params=params)[0]
            torch.cuda.synchronize()
            unsegmented = {"fits": True,
                           "peak_bytes": torch.cuda.max_memory_allocated()}
            del a
        except torch.cuda.OutOfMemoryError:
            unsegmented = {"fits": False}
        torch.cuda.empty_cache()
    rate = VOICES * EXACT_N / (ms / 1e3)
    split = _exact_split(stt, name, compiled, segment or EXACT_N, launches,
                         ms, card)
    log(f"[17 exact] exact {name} V={VOICES} n={EXACT_N} at {SR} Hz via "
        f"render_batch(segment={segment}) -> block engine (scan engine "
        f"fenced off), launches {launches} per render; {ms:.3f} ms/render, "
        f"{rate / 1e9:.4f} G samples/s, peak {peak:.5f}, device memory "
        f"peak {mem / 2 ** 30:.2f} GiB; first {EXACT_PREFIX} samples from "
        f"random phases within {err:.3e} of the exact scan engine "
        f"(bit-exact: {err == 0.0}, {sounding} samples not silent, scan "
        f"{scan_s:.1f} s); fast vs exact over the first {DRIFT_N}: max "
        f"|diff| {drift:.3e}"
        + ("" if unsegmented is None else
           f"; unsegmented: {'fits, peak %.2f GiB' % (unsegmented['peak_bytes'] / 2 ** 30) if unsegmented['fits'] else 'does not fit the card'}")
        + f" [{card}]")
    return {"ms": ms, "g_samples_per_s": rate / 1e9, "launches": launches,
            "memory_peak_bytes": mem, "prefix_err": err, "drift": drift,
            "segment": segment, "unsegmented": unsegmented, "split": split,
            "held": held}


def exact_drift_sine(stt, card) -> float:
    """``tests/test_precision.py`` on the card: a sine at val 0.25, 1 s at
    48 kHz, fast against exact within 1e-3 (each on its engine: K1, and the
    exact Oscillator's closed form)."""
    out = {}
    for precision in ("fast", "exact"):
        p = stt.Patch(stt.AudioConfig(sample_rate=SR, channels=1,
                                      precision=precision))
        o = p.add("Oscillator", val=0.25)
        p.connect(o, "Sine", p.output, 0)
        out[precision] = stt.render(p, DRIFT_N)[0]
    d = (out["fast"] - out["exact"]).abs().max().item()
    check(d <= DRIFT_TOL, f"fast vs exact sine over 1 s: {d}")
    log(f"[17 exact] tests/test_precision.py's sine (val 0.25, 1 s at {SR} "
        f"Hz) fast vs exact on the card: max |diff| {d:.3e} (<= "
        f"{DRIFT_TOL}) [{card}]")
    return d


def exact_one_voice(stt, kernels, card) -> dict:
    """One unbatched voice of the exact subtractive_voice through
    ``stt.render`` (1 s) and ``render_stream`` (4 blocks), the scan engine
    fenced off: the block engine as a batch of one (K3 and K4's f64
    build, once per render or block), held to the exact scan engine over
    1,024 samples from a sounding gate clock."""
    patch = stt.presets.subtractive_voice(stt.AudioConfig(
        sample_rate=SR, channels=1, precision="exact"))
    compiled = stt.compile_patch(patch)
    per = {"serial_stage": 1, "row_scan_f64": 1}
    with no_scan_engine():
        stt.render(patch, ONE_N)
        (audio, _, _), counts = _counted(kernels,
                                         lambda: stt.render(patch, ONE_N))
        ms = cuda_ms(lambda: stt.render(patch, ONE_N))
        streamed, s_counts = _counted(kernels, lambda: [
            a for a, _, _ in stt.render_stream(patch, n_blocks=4)])
    check(counts == per, f"exact one voice via render launched {counts}")
    check(s_counts == {k: 4 * c for k, c in per.items()},
          f"exact one voice via render_stream launched {s_counts}")
    check(tuple(audio.shape) == (1, ONE_N), "exact one voice shape")
    peak = _check_audio(audio, (1, ONE_N), "exact one voice")
    block = compiled.cfg.block_size
    stream_err = (torch.cat(streamed, dim=-1)
                  - audio[..., :4 * block]).abs().max().item()
    check(stream_err <= BLOCK_ATOL, f"exact render_stream off render by "
          f"{stream_err}")
    clock = next(i.id for i in patch if i.name == "gate_clock")
    state = compiled.init_state()
    state["states"][clock]["pos"] = torch.tensor(0.49, dtype=F64)
    with no_scan_engine():
        prefix = stt.render(patch, EXACT_PREFIX, state=state)[0]
    with torch.no_grad():
        scan = stt.render(patch, EXACT_PREFIX, state=state, engine="scan")[0]
    err = (prefix - scan).abs().max().item()
    sounding = int((scan != 0).sum())
    check(sounding > 0 and err <= BLOCK_ATOL, f"exact one voice off the "
          f"scan engine by {err} ({sounding} samples not silent)")
    log(f"[17 exact] exact subtractive_voice, one voice, 1 s at {SR} Hz via "
        f"stt.render (scan engine fenced off): launches {counts}, {ms:.3f} "
        f"ms; render_stream (4 blocks of {block}) {s_counts}, off render by "
        f"{stream_err:.3e}; first {EXACT_PREFIX} samples from a sounding "
        f"gate clock within {err:.3e} of the scan engine ({sounding} not "
        f"silent); peak {peak:.5f} [{card}]")
    return {"ms": ms, "launches": {"render": counts,
                                   "render_stream": s_counts},
            "prefix_err": err, "stream_err": stream_err}


# each parent's f64 build in the kernels' record: its name and the phase-17
# path whose launches and split it reports
F64_BUILDS = {"serial_stage": ("serial_stage_f64", "feedback"),
              "row_scan": ("row_scan_f64", "headline"),
              "freeverb": ("freeverb_f64", "reverb"),
              "ring_align": ("ring_align_f64", "reverb")}


def f64_entry(parent, source, replaces, errs, exact) -> dict:
    """The kernels' record of ``parent``'s f64 build, listed under it: the
    same keys, its launches on its phase-17 path, its time alone and its
    bound at that path's shapes, its plain version at phase 3's shape."""
    name, cell = F64_BUILDS[parent]
    rec = exact[cell]
    split = rec["split"]
    b_ms, b_by = split["bounds"][name]
    check_ms, plain_ms, lib_ms, check_bound, shape = EXACT_TIMES[name]
    by_phase = {f"17 {c}": exact[c]["launches"].get(name, 0)
                for c in ("headline", "reverb", "feedback")}
    by_phase["17 one voice"] = \
        exact["one voice"]["launches"]["render"].get(name, 0)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "f64_build_of": parent,
            "pallas_counterpart": "none: the JAX package runs exact "
                                  "precision's path in XLA",
            "launches": rec["launches"][name],
            "launches_by_phase": by_phase, "max_abs_err": errs[name],
            "ms": split["alone_ms"][name], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": f"exact {cell}, [{VOICES}, {split['n']}] a launch",
            "ms_at_plain_shape": check_ms,
            "bound_ms_at_plain_shape": check_bound[0],
            "plain_shape": shape}


def phase_exact(stt, kernels, card) -> dict:
    """Phase 17: exact precision's main paths on the card."""
    rec = {"headline": exact_path(stt, kernels, card, "subtractive_voice",
                                  EXACT_SEGMENT,
                                  ("serial_stage", "row_scan_f64"))}
    rec["reverb"] = exact_path(stt, kernels, card, "reverb_patch",
                               EXACT_SEGMENT,
                               ("serial_stage", "row_scan_f64",
                                "freeverb_f64", "ring_align_f64"))
    rec["feedback"] = exact_path(stt, kernels, card, "feedback_patch", None,
                                 ("serial_stage_f64",))
    rec["one voice"] = exact_one_voice(stt, kernels, card)
    rec["sine drift"] = exact_drift_sine(stt, card)
    return rec


# -- slice 11: the farm on a mesh, io, the CLI, play and profiling -----------

MESH_SLOTS = 4       # phase 18's mesh of slots on one card
DRUM_MESH_N = 48000  # drum_machine on the four-slot mesh: 1,024 x 1 s
MANY_N = 48000       # render_many's six patches, 1 s each
SRK_VOICES, SRK_N, SRK_PREFIX = 1024, 48000, 1024
RT_VOICES, RT_N = 128, 96000  # the exact round trip: two halves of 1 s
CLI_SECONDS = 10
PLAY_SECONDS = 5
TRACE_DIR = "chiprun_out/trace"
PHASE_LAUNCHES = {}  # "18 ..." / "19 ..." -> {kernel name: launches}
SRK_FIXTURE = "tests/data/reference_all_modules.srk"


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _record(label, counts):
    PHASE_LAUNCHES[label] = dict(counts)
    return counts


def _fixture_patch(stt):
    return stt.io.read_srk(SRK_FIXTURE, stt.AudioConfig(sample_rate=SR,
                                                        channels=2))


def _midi_bytes() -> bytes:
    """A Standard MIDI File of a held C major chord on 8 voices' worth of
    notes (tests/test_midi.py's hand-assembled form): C4 E4 G4 C5 for one
    second, then E4 G4 B4 D5 for one second at 120 bpm."""
    import struct

    def track(events):
        body = b""
        for delta, raw in events:
            out = [delta & 0x7F]
            delta >>= 7
            while delta:
                out.append(0x80 | (delta & 0x7F))
                delta >>= 7
            body += bytes(reversed(out)) + raw
        body += b"\x00\xff\x2f\x00"
        return b"MTrk" + struct.pack(">I", len(body)) + body

    first, second = (60, 64, 67, 72), (64, 67, 71, 74)
    events = [(0, bytes([0x90, k, 0x64])) for k in first]
    events += [(960 if i == 0 else 0, bytes([0x80, k, 0x40]))
               for i, k in enumerate(first)]
    events += [(0, bytes([0x90, k, 0x64])) for k in second]
    events += [(960 if i == 0 else 0, bytes([0x80, k, 0x40]))
               for i, k in enumerate(second)]
    return (b"MThd" + struct.pack(">IHHH", 6, 0, 1, 480)
            + track(events))


def slice11_kernels(stt) -> dict:
    """The kernels phases 18-19's paths build that no earlier phase does:
    K3 of the .srk fixture's stage, K1 of the midi command's gate/CV voice
    with its two driver lanes, and the Noise-lane kernel (every Noise
    render on the card draws its lanes with it)."""
    from srack_tpu_torch.ops.noise_kernel import NOISE_LANES
    fixture = stt.compile_patch(_fixture_patch(stt))
    prog = fixture.block_program()
    voice, gate, cv = stt.presets.gate_cv_voice(stt.AudioConfig(
        sample_rate=SR, channels=1, precision="fast"))
    midi = stt.compile_patch(voice)
    return {"srk fixture stage": prog.stage_kernel(stage_lane_keys(prog)),
            "midi voice": midi.fused((gate.id, cv.id)),
            "noise lanes": NOISE_LANES}


def _mix64(audio) -> torch.Tensor:
    """The voices of ``[V, C, n]`` summed in float64, 1,024 at a time."""
    acc = None
    for part in torch.split(audio, 1024):
        s = part.double().sum(dim=0)
        acc = s if acc is None else acc + s
    return acc


def _farm_on(stt, kernels, card, tag, mesh, patch, params, local, n):
    """``render_farm`` per voice and mixed down on ``mesh``: the audio
    equal to ``local`` bit for bit, the mix within ``V 2^-24 max|audio|``
    of the per-voice audio summed in float64, K1 once per slot and the
    scan engine never."""
    from srack_tpu_torch.parallel import render_farm
    slots = mesh.size
    with no_scan_engine():
        farm, counts = _counted(kernels, lambda: render_farm(
            patch, n, params=params, mesh=mesh))
    check(counts == {"fused_voice": slots}, f"[18 {tag}] the farm launched "
          f"{counts}, not fused_voice once per slot")
    audio = farm[0]
    check(torch.equal(audio, local), f"[18 {tag}] the farm's audio is not "
          f"the local render's, off by {(audio - local).abs().max().item()}")
    want = _mix64(audio)
    peak = audio.abs().max().item()
    del farm, audio
    torch.cuda.empty_cache()
    # each timed after an untimed render, whose memory the caching
    # allocator then holds (as phase 5's warm-up does)
    with no_scan_engine():
        ms = cuda_ms(lambda: render_farm(patch, n, params=params, mesh=mesh),
                     warmup=1)
        torch.cuda.empty_cache()
        mixed, mcounts = _counted(kernels, lambda: render_farm(
            patch, n, params=params, mesh=mesh, mixdown=True))
        mix_ms = cuda_ms(lambda: render_farm(patch, n, params=params,
                                             mesh=mesh, mixdown=True),
                         warmup=1)
    check(mcounts == {"fused_voice": slots}, f"[18 {tag}] the mixdown "
          f"launched {mcounts}")
    v = stt.compiler.tree_leaves(params)[0].shape[0]
    tol = v * 2.0 ** -24 * peak
    err = (mixed[0].double() - want).abs().max().item()
    check(err <= tol, f"[18 {tag}] the mix bus is off the float64 sum of "
          f"the voices by {err} (tolerance {tol})")
    rate = v * n / (ms / 1e3)
    log(f"[18 {tag}] render_farm subtractive_voice V={v} n={n} on "
        f"{mesh!r}: {ms:.3f} ms per voice render ({rate / 1e9:.4f} G "
        f"samples/s), mixdown {mix_ms:.3f} ms; fused_voice {slots} "
        f"launches a render; audio equal to the local render bit for bit; "
        f"mix within {err:.3e} of the float64 sum (tolerance {tol:.3e}) "
        f"[{card}]")
    return {"ms": ms, "mixdown_ms": mix_ms, "g_samples_per_s": rate / 1e9,
            "launches": counts, "mix_err": err, "mix_tol": tol}


def _train_on(stt, kernels, card, tag, mesh, want):
    """One ``batched_train_step(mesh=, fast=True)`` at phase 14's config
    against the unsharded step ``want``: the loss and every param leaf
    within 1e-6 relative, the gradients within 1e-4 of their largest, one
    K10 forward and one backward per slot."""
    import functools
    from srack_tpu_torch.utils import train as T
    patch, compiled, _ = VJP["train"]
    adam = functools.partial(torch.optim.Adam, lr=1e-3)
    ts = T.SoundMatcher(patch, TRAIN_N).init()
    step = T.batched_train_step(compiled, adam, TRAIN_N, fast=True,
                                mesh=mesh)
    targets = torch.zeros((VOICES, 1, TRAIN_N), device="cuda")
    with no_scan_engine():
        (train, _, loss), counts = _counted(kernels, lambda: step(
            ts["train"], ts["frozen"], None, targets, 0))
    slots = mesh.size
    check(counts == {"fused_vjp_fwd": slots, "fused_vjp_bwd": slots},
          f"[18 {tag}] the sharded step launched {counts}")
    loss = float(loss)
    rel = abs(loss - want["loss"]) / abs(want["loss"])
    check(rel <= 1e-6, f"[18 {tag}] loss {loss} vs {want['loss']}")
    worst_p = worst_g = 0.0
    leaves = stt.compiler.tree_items(train)
    for (path, t), (_, w), (_, g) in zip(leaves, want["params"],
                                         want["grads"]):
        d = (t.detach() - w).abs().max().item()
        scale = w.abs().max().item()
        check(d <= 1e-6 * max(scale, 1e-30), f"[18 {tag}] param {path} "
              f"off by {d} (scale {scale})")
        worst_p = max(worst_p, d / max(scale, 1e-30))
        gd = (t.grad - g).abs().max().item()
        gs = g.abs().max().item()
        check(gd <= 1e-8 + 1e-4 * gs, f"[18 {tag}] gradient {path} off by "
              f"{gd} (largest {gs})")
        worst_g = max(worst_g, gd / max(gs, 1e-30))
    same = loss == want["loss"] and all(
        torch.equal(t.detach(), w) for (_, t), (_, w)
        in zip(leaves, want["params"]))
    with no_scan_engine():
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS):
            train, _, l2 = step(train, ts["frozen"], None, targets, i + 1)
        float(l2)
        step_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_STEPS
    log(f"[18 {tag}] batched_train_step(mesh, fast=True) V={VOICES} "
        f"n={TRAIN_N}: launches {counts}; loss {loss:.9g} vs unsharded "
        f"{want['loss']:.9g} (rel {rel:.2e}); params within {worst_p:.2e} "
        f"relative, gradients within {worst_g:.2e} of their largest; bit "
        f"for bit: {same}; {step_ms:.2f} ms/step [{card}]")
    return {"launches": counts, "loss_rel": rel, "param_rel": worst_p,
            "grad_rel": worst_g, "bit_for_bit": same, "step_ms": step_ms}


def phase_farm_mesh(stt, kernels, card) -> dict:
    """Phase 18: the farm, sharded training and ``render_many`` placement
    on meshes of the one card: a one-rank NCCL process group (world of 1:
    NCCL takes one rank per card) and a mesh of four slots on cuda:0."""
    import functools
    from srack_tpu_torch import parallel
    from srack_tpu_torch.parallel import Mesh
    from srack_tpu_torch.utils import train as T
    info = parallel.init_distributed(
        coordinator_address=f"localhost:{_free_port()}", num_processes=1,
        process_id=0, backend="nccl")
    rec = {"init": info}
    try:
        one = parallel.make_mesh()
        check(one.size == 1 and one.ranks is not None,
              f"make_mesh over the process group: {one!r}")
        four = Mesh(np.array(["cuda:0"] * MESH_SLOTS).reshape(2, 2),
                    ("dp", "vp"))
        log(f"[18 farm] init_distributed: {info}; meshes {one!r} (NCCL "
            f"rank 0) and {four!r}")
        patch = kernels["subtractive_voice"][0]
        params = stt.presets.farm_params(patch, FARM_VOICES)
        with no_scan_engine():
            local, _, _ = stt.compile_patch(patch).render(
                FARM_N, params=params, batched=True, device="cuda")
        for tag, mesh in (("nccl mesh", one), ("four slots", four)):
            rec[tag] = _farm_on(stt, kernels, card, tag, mesh, patch,
                                params, local, FARM_N)
            _record(f"18 farm {tag}", rec[tag]["launches"])
        del local
        torch.cuda.empty_cache()
        x = torch.ones((1, FARM_N), device="cuda")
        rec["all_reduce_ms"] = cuda_ms(
            lambda: parallel.distributed.all_reduce_sum(x), repeats=20,
            warmup=2)
        log(f"[18 farm] all_reduce of the [1, {FARM_N}] mix bus on the "
            f"one-rank NCCL group: {rec['all_reduce_ms']:.4f} ms [{card}]")

        drums = stt.presets.drum_machine(stt.AudioConfig(sample_rate=SR,
                                                         channels=1))
        dparams = stt.presets.farm_params(drums, VOICES)
        with no_scan_engine():
            want, _, _ = stt.render_batch(drums, DRUM_MESH_N, params=dparams,
                                          key=5)
            farm, counts = _counted(kernels, lambda: parallel.render_farm(
                drums, DRUM_MESH_N, params=dparams, key=5, mesh=four))
            dms = cuda_ms(lambda: parallel.render_farm(
                drums, DRUM_MESH_N, params=dparams, key=5, mesh=four),
                warmup=1)
        check(counts.get("serial_stage") == MESH_SLOTS
              and counts.get("sample_play") == MESH_SLOTS
              and counts.get("noise_lanes") == MESH_SLOTS,
              f"[18 farm noise] drum_machine on four slots launched {counts}")
        check(torch.equal(farm[0], want), "[18 farm noise] drum_machine on "
              "four slots is not the local render, off by "
              f"{(farm[0] - want).abs().max().item()}")
        rec["noise"] = {"launches": counts, "ms": dms}
        _record("18 farm noise", counts)
        log(f"[18 farm noise] drum_machine V={VOICES} n={DRUM_MESH_N} key 5 "
            f"on four slots: equal to the local render bit for bit "
            f"(its Noise lanes keyed by the global voice); launches "
            f"{counts}; {dms:.3f} ms [{card}]")
        del farm, want
        torch.cuda.empty_cache()

        # the unsharded step, then the same step on each mesh
        pt, compiled, _ = VJP["train"]
        adam = functools.partial(torch.optim.Adam, lr=1e-3)
        ts = T.SoundMatcher(pt, TRAIN_N).init()
        step = T.batched_train_step(compiled, adam, TRAIN_N, fast=True)
        with no_scan_engine():
            tr, _, loss = step(ts["train"], ts["frozen"], None, torch.zeros(
                (VOICES, 1, TRAIN_N), device="cuda"), 0)
        items = stt.compiler.tree_items(tr)
        want = {"loss": float(loss),
                "params": [(p, t.detach().clone()) for p, t in items],
                "grads": [(p, t.grad.clone()) for p, t in items]}
        for tag, mesh in (("nccl mesh", one), ("four slots", four)):
            rec[f"train {tag}"] = _train_on(stt, kernels, card,
                                            f"train {tag}", mesh, want)
            _record(f"18 train {tag}", rec[f"train {tag}"]["launches"])

        cfg = stt.AudioConfig(sample_rate=SR, channels=1)
        rng = np.random.default_rng(18)
        patches = []
        for build in (stt.presets.subtractive_voice,
                      stt.presets.sequencer_patch, stt.presets.sine_patch):
            for _ in range(2):
                p = build(cfg)
                osc = next(i.id for i in p
                           if i.mdef.type_name == "Oscillator")
                p.set_params(osc, val=float(rng.uniform(-2.0, 0.0)))
                patches.append(p)
        from srack_tpu_torch.engine import place_groups
        placed = place_groups(patches, four.size)
        with no_scan_engine():
            got, counts = _counted(kernels, lambda: stt.render_many(
                patches, MANY_N, key=3, mesh=four))
            want_many = stt.render_many(patches, MANY_N, key=3)
        for i, (a, b) in enumerate(zip(got, want_many)):
            check(torch.equal(a, b), f"[18 placement] patch {i} on the "
                  f"mesh is not render_many's")
        check(counts == {"fused_voice": 3}, f"[18 placement] launched "
              f"{counts}")
        rec["placement"] = {"groups": [(list(i), s) for i, s in placed],
                            "launches": counts}
        _record("18 placement", counts)
        log(f"[18 placement] render_many of 6 patches in 3 topologies, "
            f"{MANY_N} samples, on four slots: groups and slots {placed}; "
            f"equal to render_many without a mesh bit for bit; launches "
            f"{counts} [{card}]")
    finally:
        torch.distributed.destroy_process_group()
    return rec


def _pcm16(audio: np.ndarray) -> np.ndarray:
    """``[C, n]`` f32 as the interleaved 16-bit PCM ``write_wav`` writes."""
    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767)
    return pcm.T.reshape(-1).astype("<i2")


def _held_wav(stt, path, audio: np.ndarray, what) -> None:
    """The WAV at ``path`` holds ``audio`` ``[C, n]`` at 16 bits: its PCM
    equal to the audio's, and ``read_wav`` (channel 0) equal to that PCM
    over 32,768."""
    raw = open(path, "rb").read()
    check(np.array_equal(np.frombuffer(raw[44:], "<i2"), _pcm16(audio)),
          f"[19 cli] {what}: the WAV's PCM is not the rendered audio's")
    got, _ = stt.io.read_wav(path)
    want = (_pcm16(audio[:1])).astype(np.float32) / np.float32(32768.0)
    check(np.array_equal(got, want), f"[19 cli] {what}: read_wav differs")


@contextlib.contextmanager
def _kept(owner, attr: str, keep: list):
    """While open, every call of ``owner.attr`` appends its result to
    ``keep``."""
    saved = getattr(owner, attr)

    def hook(*args, **kwargs):
        out = saved(*args, **kwargs)
        keep.append(out)
        return out
    setattr(owner, attr, hook)
    try:
        yield keep
    finally:
        setattr(owner, attr, saved)


def _cli(stt, kernels, card, label, argv, api, rec):
    """``main(argv)`` in this process with the launches counted; the
    audio of the entry point ``api`` it calls kept and held to the WAV."""
    from srack_tpu_torch import __main__ as cli
    from srack_tpu_torch import engine
    keep = []
    out = f"chiprun_out/cli_{label.replace(' ', '_')}.wav"
    with no_scan_engine(), _kept(engine, api, keep):
        t0 = time.perf_counter()
        rc, counts = _counted(kernels, lambda: cli.main(argv + ["-o", out]))
        secs = time.perf_counter() - t0
    check(rc == 0, f"[19 cli] {label}: exit code {rc}")
    check(counts, f"[19 cli] {label}: launched no kernel")
    rec[label] = {"launches": counts, "s": secs}
    _record(f"19 cli {label}", counts)
    return keep, out, counts, secs


def phase_io(stt, kernels, card) -> dict:
    """Phase 19: the .srk fixture on the card, the exact round trips, the
    CLI in-process, play and profiling."""
    import os
    from srack_tpu_torch import native
    from srack_tpu_torch.utils.profiling import timed_render
    os.makedirs("chiprun_out", exist_ok=True)
    rec = {"native_library": native.lib() is not None}
    log(f"[19 io] native planner and WAV codec (g++): "
        f"{'built' if rec['native_library'] else 'not built'}")

    # the .srk fixture at 1,024 voices, 1 s, against the scan engine
    t0 = time.perf_counter()
    patch = _fixture_patch(stt)
    compiled = stt.compile_patch(patch)
    params = stt.presets.farm_params(patch, SRK_VOICES)
    with no_scan_engine():
        stt.render_batch(patch, SRK_N, params=params)
        (audio, _, _), counts = _counted(kernels, lambda: stt.render_batch(
            patch, SRK_N, params=params))
        ms = cuda_ms(lambda: stt.render_batch(patch, SRK_N, params=params),
                     warmup=1)
    engine_name = compiled.auto_engine(True, "cuda")
    _check_audio(audio, (SRK_VOICES, 2, SRK_N), "srk fixture")
    with torch.no_grad():
        ref, _ = compiled.render_scan(
            _cuda(stt, params), _cuda(stt, stt.replicate_params(
                compiled.init_state(), SRK_VOICES)), SRK_PREFIX, batched=True,
            nograd=True, xs=compiled._make_xs(_cuda(stt, params), 0,
                                              SRK_PREFIX, {}))
    err = (audio[..., :SRK_PREFIX] - ref).abs().max().item()
    check(err <= BLOCK_ATOL, f"[19 srk] the fixture's first {SRK_PREFIX} "
          f"samples off the scan engine by {err}")
    rec["srk"] = {"engine": engine_name, "launches": counts, "ms": ms,
                  "prefix_err": err}
    _record("19 srk fixture", counts)
    log(f"[19 srk] {SRK_FIXTURE} ({len(compiled.plan)} modules) V="
        f"{SRK_VOICES} n={SRK_N} stereo -> {engine_name} engine, launches "
        f"{counts}; {ms:.3f} ms; first {SRK_PREFIX} samples within "
        f"{err:.3e} of the scan engine on the card; "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    del audio, ref
    torch.cuda.empty_cache()

    # round trips of an exact patch: JSON patch, npz state (f64 on cuda)
    t0 = time.perf_counter()
    reverb = stt.presets.reverb_patch(stt.AudioConfig(
        sample_rate=SR, channels=2, precision="exact"))
    text = stt.io.save_patch(reverb)
    loaded = stt.io.load_patch(text)
    check(sorted(loaded.connections()) == sorted(reverb.connections()),
          "[19 round trip] the JSON patch lost wiring")
    ex = stt.compile_patch(loaded)
    check(ex is stt.compile_patch(reverb), "[19 round trip] the loaded "
          "patch compiles to another plan")
    rparams = stt.presets.farm_params(loaded, RT_VOICES)
    half = RT_N // 2
    with no_scan_engine():
        whole, _, _ = ex.render(RT_N, params=rparams, batched=True,
                                device="cuda")
        first, _, mid = ex.render(half, params=rparams, batched=True,
                                  device="cuda")
        path = "chiprun_out/exact_state.npz"
        stt.io.save_state(path, mid)
        like = stt.compiler.tree_map(lambda a: torch.zeros_like(a), mid)
        back = stt.io.load_state(path, like)
        f64 = 0
        for (p, a), (_, b) in zip(stt.compiler.tree_items(back),
                                  stt.compiler.tree_items(mid)):
            check(a.dtype == b.dtype and a.device == b.device
                  and torch.equal(a, b), f"[19 round trip] state leaf {p} "
                  f"{a.dtype} {a.device} vs {b.dtype} {b.device}")
            f64 += a.dtype == torch.float64
        check(f64 > 0, "[19 round trip] the exact state has no f64 leaf")
        second, _, _ = ex.render(half, params=rparams, state=back,
                                 batched=True, device="cuda")
        again, _, _ = ex.render(half, params=rparams, state=mid,
                                batched=True, device="cuda")
    check(torch.equal(second, again), "[19 round trip] the loaded state "
          "renders otherwise than the state it saved")
    rt_err = (torch.cat([first, second], -1) - whole).abs().max().item()
    check(rt_err <= BLOCK_ATOL, f"[19 round trip] resumed render off the "
          f"unbroken one by {rt_err}")
    rec["round trip"] = {"f64_leaves": f64, "resume_err": rt_err,
                         "bytes": os.path.getsize(path)}
    log(f"[19 round trip] exact reverb_patch: JSON patch and npz state "
        f"({os.path.getsize(path)} bytes, {f64} f64 leaves back as float64 "
        f"on cuda) round-trip; the resumed render equals the one from the "
        f"saved state bit for bit and the unbroken {RT_N}-sample render "
        f"within {rt_err:.3e} (V={RT_VOICES}); "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    del whole, first, second, again, mid, back
    os.remove(path)
    torch.cuda.empty_cache()

    # the CLI in this process
    cli = {}
    for label, argv in (
            ("subtractive", ["render", "subtractive"]),
            ("reverb", ["render", "reverb"]),
            ("exact", ["render", "subtractive", "--precision", "exact"])):
        keep, out, counts, secs = _cli(
            stt, kernels, card, label,
            argv + ["--seconds", str(CLI_SECONDS)], "render", cli)
        check(len(keep) == 1, f"[19 cli] {label}: {len(keep)} renders")
        a = keep[0][0].cpu().numpy()
        _held_wav(stt, out, a, label)
        log(f"[19 cli] {' '.join(argv)} --seconds {CLI_SECONDS}: "
            f"{secs:.3f} s in main(), launches {counts}; the WAV holds the "
            f"render at 16 bits [{card}]")
    keep, out, counts, secs = _cli(
        stt, kernels, card, "srk",
        ["render", SRK_FIXTURE, "--seconds", "1"], "render", cli)
    _held_wav(stt, out, keep[0][0].cpu().numpy(), "srk")
    log(f"[19 cli] render {SRK_FIXTURE} --seconds 1: {secs:.3f} s, "
        f"launches {counts} [{card}]")
    mid_path = "chiprun_out/chord.mid"
    with open(mid_path, "wb") as f:
        f.write(_midi_bytes())
    keep, out, counts, secs = _cli(
        stt, kernels, card, "midi", ["midi", mid_path, "--voices", "8"],
        "render_batch", cli)
    mixed = np.concatenate([a.cpu().numpy().sum(axis=0) for a, _, _ in keep],
                           axis=-1)
    peak = float(np.abs(mixed).max())
    if peak > 1.0:
        mixed = mixed / (peak * 1.02)
    _held_wav(stt, out, mixed, "midi")
    log(f"[19 cli] midi chord.mid --voices 8: {secs:.3f} s, launches "
        f"{counts}; mix peak {peak:.3f} [{card}]")
    rec["cli"] = cli

    # play: one voice, then 1,024
    t0 = time.perf_counter()
    voice = kernels["subtractive_voice"][0]
    plays = {}
    for label, voices in (("one voice", None), ("1024 voices", VOICES)):
        with no_scan_engine():
            stats, counts = _counted(kernels, lambda: stt.play(
                voice, seconds=PLAY_SECONDS, sink="null", voices=voices))
        block_ms = 1e3 * voice.config.block_size / voice.config.sample_rate
        plays[label] = {"blocks": stats.blocks, "underruns": stats.underruns,
                        "worst_headroom_ms": 1e3 * stats.worst_headroom_s,
                        "block_ms": block_ms, "launches": counts}
        _record(f"19 play {label}", counts)
        log(f"[19 play] play(subtractive_voice, seconds={PLAY_SECONDS}, "
            f"sink='null', voices={voices}): {stats.blocks} blocks timed of "
            f"{voice.config.block_size} samples ({block_ms:.1f} ms), "
            f"{stats.underruns} underruns, worst headroom "
            f"{1e3 * stats.worst_headroom_s:.3f} ms, launches {counts} "
            f"[{card}]")
    rec["play"] = plays
    log(f"[19 play] {time.perf_counter() - t0:.1f} s")

    # profiling: timed_render of the headline, a trace of the reverb render
    head = stt.compile_patch(voice)
    hparams = stt.presets.farm_params(voice, VOICES)
    with no_scan_engine():
        _, _, _, stats = timed_render(head, HEADLINE_N, params=hparams,
                                      batched=True)
    rec["timed_render"] = stats.as_dict()
    log(f"[19 profile] timed_render(headline): {1e3 * stats.wall_s:.3f} ms "
        f"(CUDA events), {stats.samples_per_sec / 1e9:.4f} G samples/s, "
        f"peak {stats.peak_amplitude:.5f}, {stats.nan_lanes} NaN lanes "
        f"[{card}]")
    rec.update(reverb_traces(stt, card))
    rec["state"] = state_on_card(stt, card)
    return rec


def reverb_traces(stt, card) -> dict:
    """Two ``torch.profiler`` traces of the reverb render (1,024 x 480,000,
    stereo), after an untimed one: its initial state built as before slice
    12 (on the host, broadcast and made contiguous there, then copied by
    the render) and made by the render on the card.  The second must make
    no host-to-device copy beyond the caller's CPU param leaves."""
    import os
    from srack_tpu_torch.compiler import tree_leaves
    from srack_tpu_torch.utils.profiling import trace
    rec = {}
    rpatch = stt.presets.reverb_patch(stt.AudioConfig(sample_rate=SR,
                                                      channels=2))
    rp = stt.presets.farm_params(rpatch, VOICES)
    rcompiled = stt.compile_patch(rpatch)

    def host_state():
        # the initial state as a render made it before slice 12: on the
        # host, broadcast and made contiguous there, then copied
        return stt.compiler.tree_map(
            lambda a: a.expand((VOICES,) + a.shape).contiguous(),
            rcompiled.init_state())
    walls = {}
    with no_scan_engine():
        stt.render_batch(rpatch, HEADLINE_N, params=rp)
        for label, state in (("reverb_render_host_state", host_state),
                             ("reverb_render", lambda: None)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with trace(label, trace_dir=TRACE_DIR):
                stt.render_batch(rpatch, HEADLINE_N, params=rp,
                                 state=state())
            walls[label] = 1e3 * (time.perf_counter() - t0)
    rec["trace_host_state"] = _trace_summary(os.path.join(
        TRACE_DIR, "reverb_render_host_state.json"),
        walls["reverb_render_host_state"], card,
        "the initial state built on the host, as before slice 12")
    rec["trace"] = _trace_summary(os.path.join(
        TRACE_DIR, "reverb_render.json"), walls["reverb_render"], card,
        "the render's own initial state, made on the card")
    os.remove(os.path.join(TRACE_DIR, "reverb_render_host_state.json"))
    params = len(tree_leaves(rp))
    check(rec["trace"]["h2d_copies"] <= params,
          f"the reverb render made {rec['trace']['h2d_copies']} "
          f"host-to-device copies for {params} CPU param leaves")
    return rec


def _trace_summary(path, wall_ms, card, what) -> dict:
    """The reverb trace's top 10 device ops by time, its device idle gaps
    and its host-to-device copies, from the Chrome trace's kernel, memcpy
    and memset events."""
    import json as _json
    import os
    with open(path) as f:
        events = _json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check(dev, "[19 profile] the trace holds no device event (the "
          "profiler did not see the card)")
    by_name = {}
    for e in dev:
        name = e["name"][:80]
        t, k = by_name.get(name, (0.0, 0))
        by_name[name] = (t + e["dur"], k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy, gaps, end = 0.0, [], spans[0][0]
    for s, t in spans:
        if s > end:
            gaps.append(s - end)
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    span = spans[-1][1] - spans[0][0]
    gaps.sort(reverse=True)
    h2d = [e for e in dev if e.get("cat") == "gpu_memcpy"
           and "HtoD" in e["name"]]
    pageable = [e for e in h2d if "Pageable" in e["name"]]
    summary = {
        "wall_ms": wall_ms, "device_span_ms": span / 1e3,
        "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / span if span else None,
        "gaps": len(gaps), "gaps_ms": sum(gaps) / 1e3,
        "largest_gaps_ms": [g / 1e3 for g in gaps[:5]],
        "device_events": len(dev), "h2d_copies": len(h2d),
        "h2d_pageable": len(pageable),
        "h2d_ms": sum(e["dur"] for e in h2d) / 1e3,
        "h2d_bytes": sum(int(e.get("args", {}).get("bytes", 0))
                         for e in h2d),
        "top10": [{"name": n, "ms": t / 1e3, "calls": k}
                  for n, (t, k) in top],
        "trace_bytes": os.path.getsize(path)}
    log(f"[19 profile] trace of the reverb render (V={VOICES}, "
        f"n={HEADLINE_N}; {what}): {len(h2d)} host-to-device copies "
        f"({len(pageable)} pageable, {summary['h2d_ms']:.3f} ms, "
        f"{summary['h2d_bytes']} bytes); wall {wall_ms:.3f} ms (profiler "
        f"on), device span "
        f"{span / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, idle share "
        f"{100 * summary['idle_share']:.1f} % in {len(gaps)} gaps "
        f"({sum(gaps) / 1e3:.3f} ms; largest "
        f"{', '.join(f'{g / 1e3:.3f}' for g in gaps[:5])} ms), "
        f"{len(dev)} device events [{card}]")
    for i, (n, (t, k)) in enumerate(top):
        log(f"[19 profile]   {i + 1}. {t / 1e3:.3f} ms in {k} calls: {n}")
    return summary


# -- slice 12: K4 redesigned, the initial state made on the card -------------

K4_CHECK_NS = (SCAN_N, SCAN_N - 1)  # the 16-byte variant, the one-element one
K4_KINDS = ([(kind, dt, 0) for kind in ("sum", "max")
             for dt in (torch.float32, torch.int32, F64)]
            + [("fill", dt, k) for dt in (torch.float32, torch.int32, F64)
               for k in (1, 2, 3, 4)]
            + [("affine", torch.float32, 0)])
K4_DT = {torch.float32: "f32", torch.int32: "i32", F64: "f64"}
K4_SHAPE = {}   # "<kind> <dtype> [xK] vec|scalar" -> the pipelined build
K4_REC = {}     # phase 3's K4 times at the check shapes


def _k4_label(kind, dt, k, vec) -> str:
    return (f"{kind} {K4_DT[dt]}" + (f" x{k}" if kind == "fill" else "")
            + (" vec" if vec else " scalar"))


def _k4_ptxas(log_text) -> dict:
    """ptxas's lines for K4's pipelined kernels, by label: registers,
    spill bytes (stores + loads) and stack frame, read off the mangled
    names (``srk_scan_pipe_kernel<S, VEC>``)."""
    import re
    dts = {"f": torch.float32, "i": torch.int32, "d": F64}
    out, name, frame = {}, None, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, frame = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if not (m and name and "srk_scan_pipe_kernel" in name):
            continue
        vec = "Lb1E" in name
        s1 = re.search(r"srk_scan1I([fid])\d+srk_(add|max)", name)
        fill = re.search(r"srk_scan_fillI([fid])Li(\d)E", name)
        if s1:
            label = _k4_label("sum" if s1.group(2) == "add" else "max",
                              dts[s1.group(1)], 0, vec)
        elif fill:
            label = _k4_label("fill", dts[fill.group(1)],
                              int(fill.group(2)), vec)
        else:
            label = _k4_label("affine", torch.float32, 0, vec)
        stack, st, ld = frame or (-1, -1, -1)
        out[label] = {"registers": int(m.group(1)), "spill_bytes": st + ld,
                      "stack_bytes": stack}
    return out


def k4_shape(stt) -> dict:
    """Record each K4 build's registers, spills and stack frame (``-Xptxas
    -v``), ring bytes (its dynamic shared memory) and the CTAs of 256
    threads an SM holds (the card's occupancy query) in ``K4_SHAPE``."""
    from srack_tpu_torch.ops import scan_kernel as sk
    regs = _k4_ptxas(sk.ROW_SCAN.build_log)
    fn = sk.ROW_SCAN.build().srk_scan_shape
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    kinds = {"sum": 0, "max": 1, "fill": 2, "affine": 3}
    dts = {torch.float32: 0, torch.int32: 1, F64: 2}
    for kind, dt, k in K4_KINDS:
        for vec in (True, False):
            label = _k4_label(kind, dt, k, vec)
            ctas, smem = ctypes.c_int(-1), ctypes.c_int(-1)
            check(fn(kinds[kind], dts[dt], k, int(vec), ctypes.byref(ctas),
                     ctypes.byref(smem)) == 0,
                  f"K4's occupancy query failed for {label}")
            ctas, smem = ctas.value, smem.value
            check(label in regs, f"no ptxas line for K4's {label} build")
            K4_SHAPE[label] = dict(regs[label], ring_bytes=smem,
                                   ctas_per_sm=ctas)
            log(f"[2 build] row_scan {label}: {regs[label]['registers']} "
                f"registers, {regs[label]['spill_bytes']} bytes spilled, "
                f"{regs[label]['stack_bytes']} bytes stack frame, a ring of "
                f"{smem} B, {ctas} CTAs of 256 threads per SM")
    return K4_SHAPE


def _k4_inputs(n, seed):
    rng = np.random.default_rng(seed)
    shape = (SCAN_ROWS, n)

    def dev(a):
        return torch.from_numpy(a).cuda()
    return {
        torch.float32: dev(rng.standard_normal(shape).astype(np.float32)),
        torch.int32: dev(rng.integers(-2 ** 31, 2 ** 31 - 1, shape,
                                      dtype=np.int64).astype(np.int32)),
        F64: dev(rng.uniform(0.0, 0.1, shape)),
        "mask": dev(rng.uniform(size=shape) < 1e-3),
        "a": dev(rng.uniform(0.99, 1.0, shape).astype(np.float32))}


def _k4_call(kind, dt, k, x):
    """``(run, plain)`` of one K4 kind on phase 3's inputs ``x``: the
    wrapper's call and the plain version's."""
    from srack_tpu_torch.ops import basic, scan_kernel as sk
    lib = sk.ROW_SCAN_F64 if dt == F64 else sk.ROW_SCAN
    if kind == "fill":
        vals = tuple(torch.roll(x[dt], 37 * j, -1) for j in range(k))
        return (lambda: lib.fill(vals, x["mask"]),
                lambda: basic.forward_fill_multi_plain(vals, x["mask"]))
    if kind == "affine":
        return (lambda: lib.run("affine", (x["a"], x[dt])),
                lambda: basic.affine_scan_plain(x["a"], x[dt]))
    plain = basic.cumsum_plain if kind == "sum" else basic.cummax_plain
    return (lambda: lib.run(kind, (x[dt],)), lambda: (plain(x[dt]),))


def compare_k4_forms(card) -> dict:
    """Phase 3 for K4's redesign: every kind and dtype (sum and max of f32,
    int32 and f64; fills of 1-4 arrays of each; affine) on [1,024, 48,000]
    rows (the 16-byte variant) and [1,024, 47,999] (the one-element
    variant), against the plain version: int32 kinds, maxes and fills
    exact (fills where a value is defined), f32 sum within 2e-4, affine
    3e-4, f64 sum 1e-12 (abs + rel); each launch's entry read off the
    build's per-entry count; then each dtype's sum timed through both
    variants and torch.cumsum.  Returns the largest error of each
    build."""
    from srack_tpu_torch.ops import scan_kernel as sk
    t0 = time.perf_counter()
    errs = {"row_scan": 0.0, "row_scan_f64": 0.0}
    for n in K4_CHECK_NS:
        vec = n % 4 == 0
        x = _k4_inputs(n, n)
        for kind, dt, k in K4_KINDS:
            lib = sk.ROW_SCAN_F64 if dt == F64 else sk.ROW_SCAN
            entry = (f"srk_scan_{kind}_{K4_DT[dt]}" + ("_vec" if vec else ""))
            before = lib.by_entry.get(entry, 0)
            run, plain = _k4_call(kind, dt, k, x)
            got, want = run(), plain()
            check(lib.by_entry.get(entry, 0) == before + 1,
                  f"K4 {kind} {K4_DT[dt]} at n={n} did not launch {entry}")
            what = f"K4 {_k4_label(kind, dt, k, vec)} at [{SCAN_ROWS}, {n}]"
            if kind == "fill":
                (filled, ok), (want_f, want_ok) = got, want
                err = _held([(ok, want_ok, None)] + [
                    (g, w, ok) for g, w in zip(filled, want_f)], 0, what)
            else:
                tol = (0 if kind == "max" or dt == torch.int32
                       else F64_SUM_TOL if dt == F64 else SCAN_TOL[kind])
                err = _held([(g, w, None) for g, w in zip(got, want)], tol,
                            what)
            errs[lib.name] = max(errs[lib.name], err)
            log(f"[3 compare] row_scan {_k4_label(kind, dt, k, vec)} "
                f"[{SCAN_ROWS}, {n}] ({entry}): max abs err {err:.3e} "
                f"against the log-doubling form")
            del got, want
        for dt in (torch.float32, torch.int32, F64):
            run, _ = _k4_call("sum", dt, 0, x)
            y = x[dt]
            rec = {"ms": cuda_ms(run, repeats=20, warmup=1),
                   "library_ms": (cuda_ms(lambda: torch.cumsum(y, dim=-1),
                                          repeats=20, warmup=1)
                                  if dt != torch.int32 else None),
                   "bound_ms": _bound(2 * y.numel() * y.element_size(),
                                      0)[0]}
            K4_REC[f"sum {K4_DT[dt]} {n}"] = rec
            lib = ("" if rec["library_ms"] is None
                   else f", torch.cumsum {rec['library_ms']:.4f} ms")
            log(f"[3 compare] row_scan sum {K4_DT[dt]} [{SCAN_ROWS}, {n}] "
                f"({'16-byte' if vec else 'one-element'} variant): "
                f"{rec['ms']:.4f} ms{lib}; "
                f"bound {rec['bound_ms']:.4f} ms (bytes), share "
                f"{100 * rec['bound_ms'] / rec['ms']:.1f} % [{card}]")
        del x
        torch.cuda.empty_cache()
    log(f"[3 compare] row_scan forms: {time.perf_counter() - t0:.1f} s")
    return errs


def state_on_card(stt, card) -> dict:
    """Every patch the phases render (fast and exact, both feedback
    modes): ``init_state("cuda")`` equal to the host build leaf for leaf
    (value, dtype, shape), and broadcast over 1,024 voices on the card
    equal to the host build expanded and made contiguous, bit for bit."""
    from srack_tpu_torch.compiler import tree_leaves, tree_map
    t0 = time.perf_counter()
    patches = []
    channels = {"reverb_patch": 2, "lane_check_patch": 2,
                "kernel_check_patch": 3}
    for prec in ("fast", "exact"):
        for name in ("subtractive_voice", "sine_patch", "sequencer_patch",
                     "feedback_patch", "reverb_patch", "drum_machine",
                     "sampler_kit", "kit_check_patch", "gradient_patch",
                     "block_check_patch", "lane_check_patch",
                     "kernel_check_patch"):
            p = getattr(stt.presets, name)(stt.AudioConfig(
                sample_rate=SR, channels=channels.get(name, 1),
                precision=prec))
            patches.append((f"{name} {prec}",
                            p[0] if isinstance(p, tuple) else p))
        patches.append((f"feedback_patch buffer {prec}",
                        stt.presets.feedback_patch(stt.AudioConfig(
                            sample_rate=SR, block_size=BUFFER_BLOCK,
                            channels=1, buffer_feedback=True,
                            precision=prec))))
    patches.append(("the .srk fixture", _fixture_patch(stt)))
    leaves = 0
    for what, patch in patches:
        compiled = stt.compile_patch(patch)
        host, card_state = compiled.init_state(), compiled.init_state("cuda")
        wide = tree_map(lambda a: a.expand((VOICES,) + a.shape), card_state)
        want = tree_map(lambda a: a.expand((VOICES,) + a.shape).contiguous(),
                        host)
        for got, ref, g1 in zip(tree_leaves(wide), tree_leaves(want),
                                tree_leaves(card_state)):
            check(g1.device.type == "cuda", f"{what}: a leaf on {g1.device}")
            check(got.dtype == ref.dtype and got.shape == ref.shape
                  and torch.equal(got.cpu(), ref),
                  f"{what}: the state made on the card differs from the "
                  f"host build")
            leaves += 1
    log(f"[19 state] {len(patches)} patches, {leaves} leaves: the initial "
        f"state made on the card equal to the host build bit for bit, "
        f"broadcast over {VOICES} voices; {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    return {"patches": len(patches), "leaves": leaves}


def main() -> int:
    card = phase_device()
    import srack_tpu_torch as stt

    t0 = time.perf_counter()
    kernels = phase_build(stt)
    log(f"[2 build] all kernels built in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    errs, keep = phase_compare(stt, kernels)
    block_errs, scan_x = phase_compare_block(stt)
    errs.update(block_errs)
    t1 = time.perf_counter()
    kit_errs, gather_keep, play_args = phase_compare_kit(stt)
    errs.update(kit_errs)
    log(f"[3 compare] slice 3b: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    vjp_errs, vjp_keep = phase_compare_vjp(stt)
    errs.update(vjp_errs)
    log(f"[3 compare] slice 5 (K10): {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    compare_ragged(stt, kernels)
    log(f"[3 compare] ragged tiles: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    errs.update(phase_compare_exact(stt))
    log(f"[3 compare] slice 10 (exact precision): "
        f"{time.perf_counter() - t1:.1f} s")
    for name, err in compare_k4_forms(card).items():   # slice 12
        errs[name] = max(errs[name], err)
    log(f"[3 compare] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    main_launches, _ = phase_main(stt, kernels, card,
                                  keep["fused_voice"])
    log(f"[4 main] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_farm(stt, kernels, card)
    log(f"[5 farm] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    times = _times(keep)
    for name, (kernel_ms, plain_ms) in times.items():
        k = keep[name]
        log(f"[6 plain] {name} V={VOICES} n={k['n']}: plain version (scan "
            f"engine) {plain_ms:.3f} ms, kernel {kernel_ms:.3f} ms (mean "
            f"of 5) [{card}]")
    btimes, k8_launch_ms = block_times(stt, scan_x)
    del scan_x
    torch.cuda.empty_cache()
    btimes.update(kit_times(gather_keep, play_args))
    del gather_keep, play_args
    torch.cuda.empty_cache()
    k = vjp_keep
    vjp_check_ms = vjp_times(stt, VJP["train"][2], k["params"], k["state"],
                             k["n"], k["xs"])
    for which, kernel_ms, plain_ms in zip(("fwd", "bwd"), vjp_check_ms,
                                          k["plain"]):
        log(f"[6 plain] fused_vjp_{which} subtractive_voice V={VOICES} "
            f"n={k['n']} at {SR} Hz: plain version (scan engine under "
            f"autograd, its {'forward' if which == 'fwd' else 'backward'}) "
            f"{plain_ms:.3f} ms, kernel {kernel_ms:.3f} ms [{card}]")
    vjp_plain = k["plain"]
    del vjp_keep, k
    torch.cuda.empty_cache()
    for name, (kernel_ms, plain_ms, lib_ms, _, shape) in btimes.items():
        lib = "" if lib_ms is None else f", library call {lib_ms:.3f} ms"
        log(f"[6 plain] {name} {shape}: plain version {plain_ms:.3f} ms, "
            f"kernel {kernel_ms:.3f} ms{lib} [{card}]")
    log(f"[6 plain] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    seq_launches, _ = phase_sequencer(stt, kernels, card)
    log(f"[7 sequencer] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    buf_launches, _ = phase_buffer(stt, kernels, card)
    log(f"[8 buffer] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rev_launches, rev_held = phase_reverb(stt, kernels, card)
    log(f"[9 reverb] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    chk_launches, chk_held = phase_block_check(stt, kernels, card)
    log(f"[10 block check] {time.perf_counter() - t0:.1f} s")
    kit_launches, kit_held = {}, []
    for phase, name, names in (
            ("11 drums", "drum_machine", ("serial_stage", "sample_play",
                                          "noise_lanes")),
            ("12 sampler", "sampler_kit", ("serial_stage", "sample_play")),
            ("13 kit check", "kit_check_patch",
             ("row_scan", "row_gather", "serial_stage", "sample_play"))):
        t0 = time.perf_counter()
        kit_launches[phase], held = phase_kit(stt, kernels, card, name,
                                              phase, names)
        kit_held.append(held)
        log(f"[{phase}] {time.perf_counter() - t0:.1f} s")
    errs["noise_lanes"] = 0.0   # held at phase 11's full width only
    for held in (rev_held, chk_held, *kit_held):  # full-width comparisons
        for name, err in held.items():
            errs[name] = max(errs[name], err)
    t0 = time.perf_counter()
    train_launches, train_ms, train_bounds = phase_train(stt, kernels, card)
    log(f"[14 train] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ab = phase_ab(stt, kernels, card)
    log(f"[15 a/b] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    one = phase_one_voice(stt, kernels, card)
    log(f"[16 one voice] {time.perf_counter() - t0:.1f} s")
    one_k1 = sum(one["subtractive_voice"]["launches"]["render"].values())
    one_k3 = one["reverb_patch"]["launches"]["render"]
    t0 = time.perf_counter()
    exact = phase_exact(stt, kernels, card)
    log(f"[17 exact] {time.perf_counter() - t0:.1f} s")
    for cell in ("headline", "reverb", "feedback"):  # full-width comparisons
        for name, err in exact[cell]["held"].items():
            errs[name] = max(errs[name], err)
    t0 = time.perf_counter()
    farm_mesh = phase_farm_mesh(stt, kernels, card)
    log(f"[18 farm] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    io = phase_io(stt, kernels, card)
    log(f"[19 io] {time.perf_counter() - t0:.1f} s")

    entries = []
    meta = {
        "fused_voice": ("srack_tpu/ops/fused.py:87", main_launches,
                        {"4 main": main_launches, "7 sequencer":
                         seq_launches, "16 one voice": one_k1}),
        "fused_voice_buffer": ("srack_tpu/ops/fused.py:314", buf_launches,
                               {"8 buffer": buf_launches}),
    }
    for name, (replaces, launches, by_phase) in meta.items():
        k = keep[name]
        b_ms, b_by, nbytes, ops = bound(k["compiled"], k["kernel"], VOICES,
                                        k["n"])
        kernel_ms, plain_ms = times[name]
        log(f"[bound] {name} V={VOICES} n={k['n']}: {nbytes} bytes, {ops} "
            f"f32 operations -> {b_ms:.4f} ms ({b_by}); the wrapped kernel "
            f"takes {kernel_ms / b_ms:.1f}x its bound")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "srack_tpu_torch/ops/fused.py",
            "replaces": replaces,
            "launches": launches,
            "launches_by_phase": by_phase,
            "max_abs_err": errs[name],
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
        if name == "fused_voice":
            entries[-1]["split"] = {c: ab[c] for c, n, _, _ in AB_CELLS
                                    if n != "feedback_buffer"}
            entries[-1]["one_voice"] = one["subtractive_voice"]
        else:
            entries[-1]["split"] = {"buffer": ab["buffer"]}
    sources = {
        "serial_stage": ("srack_tpu_torch/ops/fused.py",
                         "srack_tpu/ops/serial_kernel.py:65",
                         rev_launches["serial_stage"],
                         {"9 reverb": rev_launches["serial_stage"],
                          "10 block check": chk_launches["serial_stage"],
                          **{ph: c["serial_stage"]
                             for ph, c in kit_launches.items()},
                          "16 one voice": one_k3["serial_stage"]}),
        "row_scan": ("srack_tpu_torch/csrc/row_scan.cu",
                     "srack_tpu/ops/scan_kernel.py:138",
                     chk_launches["row_scan"],
                     {"10 block check": chk_launches["row_scan"],
                      "13 kit check": kit_launches["13 kit check"][
                          "row_scan"]}),
        "freeverb": ("srack_tpu_torch/csrc/freeverb.cu",
                     "srack_tpu/ops/freeverb_kernel.py:100",
                     rev_launches["freeverb"],
                     {"9 reverb": rev_launches["freeverb"],
                      "10 block check": chk_launches["freeverb"],
                      "16 one voice": one_k3["freeverb"]}),
        "ring_align": ("srack_tpu_torch/csrc/ring_align.cu",
                       "srack_tpu/ops/ring_roll.py:61",
                       rev_launches["ring_align"],
                       {"9 reverb": rev_launches["ring_align"],
                        "10 block check": chk_launches["ring_align"],
                        "16 one voice": one_k3["ring_align"]}),
        "row_gather": ("srack_tpu_torch/csrc/row_gather.cu",
                       "srack_tpu/ops/scan_kernel.py:221",
                       kit_launches["13 kit check"]["row_gather"],
                       {"13 kit check":
                        kit_launches["13 kit check"]["row_gather"]}),
        # K6 is the Sample's unfused read: no main path launches it (an
        # exact Sample takes K7, as in the JAX package, whose K7 takes the
        # exact Sample's f32 gate and table); phase 3 runs it under K7
        "row_gather_long": ("srack_tpu_torch/csrc/row_gather.cu",
                            "srack_tpu/ops/sample_gather.py:167", 0, {}),
        "sample_play": ("srack_tpu_torch/csrc/sample_play.cu",
                        "srack_tpu/ops/sample_kernel.py:380",
                        kit_launches["11 drums"]["sample_play"],
                        {ph: c["sample_play"]
                         for ph, c in kit_launches.items()}),
    }
    for name, (source, replaces, launches, by_phase) in sources.items():
        kernel_ms, plain_ms, lib_ms, (b_ms, b_by, nbytes, ops), shape = \
            btimes[name]
        log(f"[bound] {name} {shape}: {nbytes} bytes, {ops} f32 operations "
            f"-> {b_ms:.4f} ms ({b_by}); the kernel takes "
            f"{kernel_ms / b_ms:.1f}x its bound")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "launches_by_phase": by_phase,
            "max_abs_err": errs[name],
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib_ms,
        })
        if name == "freeverb":
            entries[-1]["launch_ms"] = k8_launch_ms
            entries[-1]["twin"] = {c: ab[f"k8 {c}"] for c in ("reverb",
                                                            "block check")}
            entries[-1]["wrapper"] = dict(K8_WRAPPER)
        if name == "serial_stage":
            entries[-1]["split"] = {c: ab[c] for c in STAGES}
            entries[-1]["one_voice"] = one["reverb_patch"]
        if name == "sample_play":
            entries[-1]["tiles"] = {c: ab[f"k7 {c}"] for c in KIT_NAMES}
        if name == "ring_align":
            entries[-1]["tiles"] = {c: ab[f"k9 {c}"] for c in ("reverb",
                                                             "block check")}
        if name == "row_scan":   # slice 12: the pipelined kernel
            entries[-1]["forms"] = K4_REC
            entries[-1]["builds"] = K4_SHAPE
        if name in F64_BUILDS:
            entries.append(f64_entry(name, source, replaces, errs, exact))
    # the Noise lanes' kernel ports no Pallas kernel: the JAX package draws
    # them with jax.random.uniform in XLA
    entries.append({
        "name": "noise_lanes",
        "route": "cuda",
        "source": "srack_tpu_torch/csrc/noise_lanes.cu",
        "replaces": "srack_tpu/modules/oscillator.py:331",
        "ports_pallas_call": False,
        "launches": kit_launches["11 drums"]["noise_lanes"],
        "launches_by_phase": {"11 drums":
                              kit_launches["11 drums"]["noise_lanes"]},
        "max_abs_err": errs["noise_lanes"],
        "ms": NOISE_REC["ms"],
        "plain_ms": NOISE_REC["plain_ms"],
        "bound_ms": NOISE_REC["bound"][0],
        "bound_by": NOISE_REC["bound"][1],
        "library_ms": None,
        "shape": NOISE_REC["shape"],
    })
    plain_ms = dict(zip(("fwd", "bwd"), vjp_plain))
    for i, (which, line) in enumerate((("fwd", 92), ("bwd", 212))):
        name = f"fused_vjp_{which}"
        b_ms, b_by = train_bounds[which]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "srack_tpu_torch/ops/fused.py",
            "replaces": f"srack_tpu/ops/fused_vjp.py:{line}",
            "launches": train_launches[name],     # per training step
            "launches_by_phase": {
                "14 train": train_launches[name] * TRAIN_STEPS},
            "train_steps": TRAIN_STEPS,
            "max_abs_err": errs[name],
            "ms": train_ms[i],
            "plain_ms": plain_ms[which],
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "shape": f"subtractive_voice [{VOICES}, {TRAIN_N}] at {SR} Hz",
            "plain_shape": (f"subtractive_voice [{VOICES}, {VJP_N}] at "
                            f"{SR} Hz"),
            "ms_at_plain_shape": vjp_check_ms[i],
        })
        entries[-1]["twin"] = ab[f"k10 {'train' if which == 'bwd' else which}"]
    for entry in entries:   # slice 11's phases, every kernel's count
        for label, counts in PHASE_LAUNCHES.items():
            entry["launches_by_phase"][label] = counts.get(entry["name"], 0)
    log(json.dumps({"slice11": {"farm": farm_mesh, "io": io}},
                   default=str))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
