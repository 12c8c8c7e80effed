#!/usr/bin/env python3
"""Smoke run of srack_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. the device: a CUDA card is required; prints its name and power limit
   (nvidia-smi) and turns TF32 off;
2. the build: builds the fused CUDA kernel (nvcc, sm_90a) for
   subtractive_voice, sine_patch, feedback_patch and kernel_check_patch at
   48 kHz from the sources in this checkout;
3. kernel vs plain version on the card: farm_params(patch, 1024) at
   n = 2048 and n = 2047 through the kernel and through the scan engine
   (the kernel's plain version); audio within 1e-5, int32 and bool state
   bit-exact, float state within 1e-5;
4. the main path at full size: compile_patch(subtractive_voice(cfg))
   .render(480000, params=farm_params(patch, 1024), batched=True,
   device="cuda") with engine="auto" -- 1,024 voices x 10 s at 48 kHz;
   requires the kernel's launch count to move, finite audio, peak <= 1.002,
   and the first 2,048 samples equal to phase 3's plain render; times one
   render with CUDA events after a warm-up;
5. the farm: 16,384 voices x 192,000 samples (4 s) through the same path;
6. the plain version's time at phase 3's shape.

Any failure raises and exits non-zero.  The line before the last is a JSON
record of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

SR = 48000
VOICES = 1024
CHECK_NS = (2048, 2047)
HEADLINE_N = 480000
FARM_VOICES, FARM_N = 16384, 192000
ATOL = 1e-5  # fused-vs-scan audio tolerance of the JAX package's tests
PEAK_MAX = 1.002


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


def phase_build(stt):
    cfg1 = stt.AudioConfig(sample_rate=SR, channels=1)
    patches = {
        "subtractive_voice": stt.presets.subtractive_voice(cfg1),
        "sine_patch": stt.presets.sine_patch(cfg1),
        "feedback_patch": stt.presets.feedback_patch(cfg1),
        "kernel_check_patch": stt.presets.kernel_check_patch(
            stt.AudioConfig(sample_rate=SR, channels=3)),
    }
    kernels = {}
    for name, patch in patches.items():
        compiled = stt.compile_patch(patch)
        kernel = compiled.fused()
        t0 = time.perf_counter()
        kernel.build()
        secs = time.perf_counter() - t0
        ptxas = [ln.strip() for ln in kernel.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[2 build] {name}: nvcc sm_90a built in {secs:.2f} s; "
            + " | ".join(ptxas))
        kernels[name] = (patch, compiled, kernel)
    return kernels


def _state_diff(got: dict, want: dict, where: str) -> float:
    """Largest float-state difference; int32 and bool state must match."""
    worst = 0.0
    for path_key in ("states", "fb"):
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


def phase_compare(stt, kernels):
    """Kernel vs its plain version on the card, same inputs."""
    max_err = 0.0
    keep = {}
    for name, (patch, compiled, kernel) in kernels.items():
        params = stt.compiler.tree_map(
            lambda a: a.cuda(), stt.presets.farm_params(patch, VOICES))
        state = stt.compiler.tree_map(
            lambda a: a.expand((VOICES,) + a.shape).contiguous().cuda(),
            compiled.init_state())
        for n in CHECK_NS:
            audio_k, final_k = kernel.render(params, state, n)
            torch.cuda.synchronize()
            with torch.no_grad():
                audio_p, final_p = compiled.render_scan(
                    params, state, n, batched=True, nograd=True)
            torch.cuda.synchronize()
            check(audio_k.shape == audio_p.shape,
                  f"{name} n={n}: audio {audio_k.shape} vs {audio_p.shape}")
            check(bool(torch.isfinite(audio_p).all()),
                  f"{name} n={n}: plain version not finite")
            err = (audio_k - audio_p).abs().max().item()
            check(err <= ATOL, f"{name} n={n}: audio off by {err}")
            serr = _state_diff(final_k, final_p, f"{name} n={n}")
            exact = torch.equal(audio_k, audio_p)
            log(f"[3 compare] {name} V={VOICES} n={n}: max |audio| err "
                f"{err:.3e} (bit-exact: {exact}), max float-state err "
                f"{serr:.3e}, int32/bool state bit-exact")
            max_err = max(max_err, err)
            if name == "subtractive_voice" and n == CHECK_NS[0]:
                keep = {"params": params, "state": state, "n": n,
                        "audio_plain": audio_p}
    # times at phase 3's shape, subtractive voice
    _, compiled, kernel = kernels["subtractive_voice"]
    p, s, n = keep["params"], keep["state"], keep["n"]
    kernel_ms = cuda_ms(lambda: kernel.render(p, s, n), repeats=5)
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: compiled.render_scan(
            p, s, n, batched=True, nograd=True))
    return max_err, kernel_ms, plain_ms, keep


def _render_main(stt, patch, params, n):
    return stt.compile_patch(patch).render(n, params=params, batched=True,
                                           device="cuda")


def phase_main(stt, kernels, card, keep):
    patch, compiled, kernel = kernels["subtractive_voice"]
    params = stt.presets.farm_params(patch, VOICES)
    kernel.launches = 0
    audio, _, _ = _render_main(stt, patch, params, HEADLINE_N)  # warm-up
    del audio
    out = {}
    ms = cuda_ms(lambda: out.update(r=_render_main(stt, patch, params,
                                                   HEADLINE_N)))
    launches = kernel.launches
    check(launches >= 1, "the main path did not launch the fused kernel")
    audio = out["r"][0]
    check(tuple(audio.shape) == (VOICES, 1, HEADLINE_N),
          f"headline audio shape {tuple(audio.shape)}")
    check(bool(torch.isfinite(audio).all()), "headline audio not finite")
    peak = audio.abs().max().item()
    check(peak <= PEAK_MAX, f"headline output clips: peak {peak}")
    n0 = keep["n"]
    prefix_err = (audio[:, :, :n0] - keep["audio_plain"]).abs().max().item()
    check(prefix_err <= ATOL,
          f"headline's first {n0} samples off the plain version by "
          f"{prefix_err}")
    rate = VOICES * HEADLINE_N / (ms / 1e3)
    log(f"[4 main] subtractive_voice V={VOICES} n={HEADLINE_N} "
        f"engine=auto -> fused, {launches} launches; {ms:.3f} ms/render, "
        f"{rate / 1e9:.4f} G samples/s, aggregate real-time "
        f"{rate / SR:.0f}x, peak {peak:.5f}, first {n0} samples within "
        f"{prefix_err:.3e} of the plain version [{card}]")
    del audio, out
    torch.cuda.empty_cache()
    return launches, ms


def phase_farm(stt, kernels, card):
    patch, _, kernel = kernels["subtractive_voice"]
    params = stt.presets.farm_params(patch, FARM_VOICES)
    before = kernel.launches
    audio, _, _ = _render_main(stt, patch, params, FARM_N)  # warm-up
    del audio
    out = {}
    ms = cuda_ms(lambda: out.update(r=_render_main(stt, patch, params,
                                                   FARM_N)))
    check(kernel.launches > before, "the farm did not launch the kernel")
    audio = out["r"][0]
    check(tuple(audio.shape) == (FARM_VOICES, 1, FARM_N),
          f"farm audio shape {tuple(audio.shape)}")
    check(bool(torch.isfinite(audio).all()), "farm audio not finite")
    peak = audio.abs().max().item()
    check(peak <= PEAK_MAX, f"farm output clips: peak {peak}")
    rate = FARM_VOICES * FARM_N / (ms / 1e3)
    log(f"[5 farm] subtractive_voice V={FARM_VOICES} n={FARM_N}: "
        f"{ms:.3f} ms/render, {rate / 1e9:.4f} G samples/s, aggregate "
        f"real-time {rate / SR:.0f}x, peak {peak:.5f} [{card}]")
    del audio, out
    torch.cuda.empty_cache()


def main() -> int:
    card = phase_device()
    import srack_tpu_torch as stt

    t0 = time.perf_counter()
    kernels = phase_build(stt)
    log(f"[2 build] all kernels built in {time.perf_counter() - t0:.2f} s")
    max_err, kernel_ms, plain_ms, keep = phase_compare(stt, kernels)
    launches, main_ms = phase_main(stt, kernels, card, keep)
    phase_farm(stt, kernels, card)
    log(f"[6 plain] subtractive_voice V={VOICES} n={CHECK_NS[0]}: plain "
        f"version (scan engine) {plain_ms:.3f} ms, fused kernel "
        f"{kernel_ms:.3f} ms (mean of 5) [{card}]")
    record = {"kernels": [{
        "name": "fused_voice",
        "route": "cuda",
        "source": "srack_tpu_torch/csrc/modules.cuh",
        "replaces": "srack_tpu/ops/fused.py:87",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
