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
   each K1 patch at n = 2048 and n = 2047 (lane_check_patch with Noise
   lanes from the generator, random Input-driver lanes and one automation
   lane) and K2 on feedback_patch, block 1,024, at n = 2048 and n = 3072,
   through the kernel and through the scan engine (the kernels' plain
   version); audio within 1e-5, int32 and bool state bit-exact, float
   state (K2's final fb ring included) within 1e-5;
4. the main path at full size: compile_patch(subtractive_voice(cfg))
   .render(480000, params=farm_params(patch, 1024), batched=True,
   device="cuda") with engine="auto" -- 1,024 voices x 10 s at 48 kHz;
   requires K1's launch count to move, finite audio, peak <= 1.002, and
   the first 2,048 samples equal to phase 3's plain render; times one
   render with CUDA events after a warm-up;
5. the farm: 16,384 voices x 192,000 samples (4 s) through the same path;
6. the plain versions' times at phase 3's shapes;
7. the sequencer at full width: stt.render_batch(sequencer_patch(cfg),
   480000, params=farm_params(patch, 1024)) on the default device --
   requires K1's launch count to move, finite audio, peak <= 1.002; timed;
8. buffer feedback at full width: stt.render_batch(feedback_patch(cfg with
   buffer_feedback=True, block 1,024), 491520, params=farm_params(patch,
   1024)) -- requires K2's launch count to move, finite audio, peak <=
   1.002; timed.

Each main path (phases 4, 5, 7, 8) runs with the launch counts set to 0
just before it and read just after.  Any failure raises and exits
non-zero.  The line before the last is a JSON record of the kernels; the
last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

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
BUFFER_BLOCK = 1024
BUFFER_CHECK_NS = (2048, 3072)
HEADLINE_N = 480000
FARM_VOICES, FARM_N = 16384, 192000
BUFFER_N = 491520  # 480 blocks of 1,024, 10.24 s
ATOL = 1e-5  # fused-vs-scan audio tolerance of the JAX package's tests
PEAK_MAX = 1.002
# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores,
# and device memory bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, repeats: int = 1) -> float:
    """Mean device time of ``fn()`` over ``repeats`` runs, in ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def ptxas(kernel) -> str:
    return " | ".join(ln.strip() for ln in kernel.build_log.splitlines()
                      if "registers" in ln or "spill" in ln)


# f32 operations per sample of each device function of csrc/modules.cuh,
# read off its source: one each f32 add, sub, mul, div, compare, select,
# min/max, abs, negation and int<->float conversion, on the path a sample
# takes.  Counted for the bound only.
def module_ops(compiled, mid) -> int:
    mdef, statics, inputs = compiled.instances[mid]
    t = mdef.type_name
    conn = [c is not None for c in inputs]
    auto = mid in compiled._auto_by_mid
    if t == "Oscillator":
        ops = 15 + (2 if conn[1] else 0)           # core, sync
        if statics[1]:
            ops += 22                               # polyBLEP square, saw
        if conn[0] or auto:
            ops += 30                               # exp2 pitch, fixed
        return ops
    if t == "Moog Filter":
        return 35 + (17 if conn[1] or auto else 0) + (2 if auto else 0)
    if t == "ADSR":
        return 20 + (6 if auto else 0)
    if t == "VCA":
        return 0 if not all(conn) else (1 if statics[1] else 3)
    if t == "Mono Mixer":
        return 2 * sum(conn)
    if t in ("Add", "Subtract", "Multiply"):
        return 1
    if t == "Non-Linear":
        return 23                                   # powf, sign fold
    if t == "Grid Sequencer":
        return 8
    if t == "Pattern Sequencer":
        return 19
    return 0                                        # Input, Noise, Output


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

    def build(name):
        t0 = time.perf_counter()
        kernels[name][2].build()
        return name, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        for name, secs in pool.map(build, kernels):
            kernel = kernels[name][2]
            log(f"[2 build] {name} ({kernel.name}): nvcc sm_90a built in "
                f"{secs:.2f} s; {ptxas(kernel)}")
    return kernels


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
        ns = BUFFER_CHECK_NS if kernel.buffer else CHECK_NS
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
            lanes = f", lanes {sorted(xs)}" if xs else ""
            fb = (f", final fb ring [{len(compiled.fb_keys)} x {VOICES} x "
                  f"{compiled.cfg.block_size}] compared as state"
                  if kernel.buffer else "")
            log(f"[3 compare] {name} ({kernel.name}) V={VOICES} n={n}: max "
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


def _timed_main(kernels, render, name):
    """Warm up, then one render timed with CUDA events, with every
    kernel's launch count set to 0 just before it and read just after."""
    audio, _, _ = render()
    del audio
    torch.cuda.synchronize()
    out = {}
    for _, _, kernel in kernels.values():
        kernel.launches = 0
    ms = cuda_ms(lambda: out.update(r=render()))
    counts = {}
    for _, _, kernel in kernels.values():
        counts[kernel.name] = counts.get(kernel.name, 0) + kernel.launches
    launches = counts.pop(name)
    check(launches >= 1, f"the main path did not launch {name}")
    check(not any(counts.values()),
          f"the main path launched other kernels: {counts}")
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
    log(f"[8 buffer] feedback_patch buffer_feedback=True block="
        f"{BUFFER_BLOCK} V={VOICES} n={BUFFER_N} via render_batch -> "
        f"fused_voice_buffer, {launches} launches; {ms:.3f} ms/render, "
        f"{rate / 1e9:.4f} G samples/s, aggregate real-time "
        f"{rate / SR:.0f}x, {ms * 1e6 / BUFFER_N:.1f} ns per sample per "
        f"thread, peak {peak:.5f}; ptxas: {ptxas(kernel)} [{card}]")
    del audio
    torch.cuda.empty_cache()
    return launches, ms


def main() -> int:
    card = phase_device()
    import srack_tpu_torch as stt

    t0 = time.perf_counter()
    kernels = phase_build(stt)
    log(f"[2 build] all kernels built in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    errs, keep = phase_compare(stt, kernels)
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
    log(f"[6 plain] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    seq_launches, _ = phase_sequencer(stt, kernels, card)
    log(f"[7 sequencer] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    buf_launches, _ = phase_buffer(stt, kernels, card)
    log(f"[8 buffer] {time.perf_counter() - t0:.1f} s")

    entries = []
    meta = {
        "fused_voice": ("srack_tpu/ops/fused.py:87", main_launches,
                        {"4 main": main_launches, "7 sequencer":
                         seq_launches}),
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
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
