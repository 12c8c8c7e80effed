"""Preset patches (counterpart: ``srack_tpu/presets.py``).

1. :func:`sine_patch`        -- single VCO -> Output sine, mono.
2. :func:`subtractive_voice` -- VCO -> Moog LP -> VCA with ADSR + LFO pitch
   mod; the gate is a slow square-wave oscillator.
3. :func:`feedback_patch`    -- cross-FM oscillator pair + filter feedback.
4. :func:`farm_params`       -- randomized parameter stacks for batch
   rendering, the same draws as the JAX package's.

The sequencer, drum, sampler and reverb presets wait for their modules.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import AudioConfig
from .patch import Patch


def sine_patch(cfg: AudioConfig | None = None) -> Patch:
    cfg = cfg or AudioConfig(channels=1)
    p = Patch(cfg)
    osc = p.add("Oscillator", val=0.0, name="vco")
    p.connect(osc, "Sine", p.output, 0)
    return p


def subtractive_voice(cfg: AudioConfig | None = None, *,
                      note: float = -1.0, gate_rate_oct: float = -5.5,
                      lfo_oct: float = -7.0, lfo_depth: float = 0.02,
                      cutoff: float = 0.35, res: float = 0.4) -> Patch:
    cfg = cfg or AudioConfig(channels=1)
    p = Patch(cfg)
    lfo = p.add("Oscillator", val=lfo_oct, name="lfo")
    depth = p.add("Multiply", constant=lfo_depth, name="lfo_depth")
    osc = p.add("Oscillator", val=note, name="vco")
    flt = p.add("Moog Filter", freq=cutoff, res=res, name="vcf")
    # the clock square only feeds gate edge detection: no band-limiting
    gate_clk = p.add("Oscillator", val=gate_rate_oct, name="gate_clock",
                     antialiasing=False)
    env = p.add("ADSR", a_sec=0.01, d_sec=0.08, s_val=0.5, r_sec=0.15,
                name="env")
    vca = p.add("VCA", name="vca")
    p.connect(lfo, "Sine", depth, "In1")
    p.connect(depth, 0, osc, "CV")
    p.connect(osc, "Sawtooth", flt, "Audio")
    p.connect(gate_clk, "Square", env, "Gate")
    p.connect(flt, 0, vca, "Audio")
    p.connect(env, 0, vca, "CV")
    p.connect(vca, 0, p.output, 0)
    if cfg.channels > 1:
        p.connect(vca, 0, p.output, 1)
    return p


def feedback_patch(cfg: AudioConfig | None = None) -> Patch:
    """Cross-FM oscillator pair + filter feedback loop."""
    cfg = cfg or AudioConfig(channels=1)
    p = Patch(cfg)
    a = p.add("Oscillator", val=-2.0, name="fm_a")
    b = p.add("Oscillator", val=-2.5, name="fm_b")
    sa = p.add("Multiply", constant=0.7, name="fm_a_amt")
    sb = p.add("Multiply", constant=0.9, name="fm_b_amt")
    p.connect(a, "Sine", sa, "In1")
    p.connect(sa, 0, b, "CV")
    p.connect(b, "Sine", sb, "In1")
    p.connect(sb, 0, a, "CV")

    mix = p.add("Mono Mixer", gains=(1.0, 0.4, 0.0, 0.0), name="fb_mix")
    flt = p.add("Moog Filter", freq=0.45, res=0.55, name="fb_vcf")
    p.connect(a, "Sine", mix, 0)
    p.connect(flt, 0, mix, 1)        # filter feedback loop
    p.connect(mix, 0, flt, "Audio")
    p.connect(flt, 0, p.output, 0)
    if cfg.channels > 1:
        p.connect(flt, 1, p.output, 1)
    return p


def farm_params(patch: Patch, n_voices: int, seed: int = 0) -> dict:
    """Randomized per-voice parameter stacks: random notes, cutoffs,
    resonances and envelope times over a shared topology.

    Draws the same numpy values in the same order as the JAX package's
    ``farm_params`` and rounds them to the same float32 values, so both
    packages render the same voices.  Clock oscillators keep the patch
    tempo; the test is the JAX package's case-sensitive ``"clock"`` in the
    module name.
    """
    rng = np.random.default_rng(seed)
    base = {mid: {k: v.numpy() for k, v in pd.items()}
            for mid, pd in patch.params().items()}
    # one list of per-voice values per leaf, filled in the JAX package's
    # draw order (voice by voice, module by module), stacked at the end
    cols = {mid: {k: [] for k in pd} for mid, pd in base.items()}
    f32 = np.float32
    for _ in range(n_voices):
        for inst in patch:
            pd = dict(base[inst.id])
            t = inst.mdef.type_name
            if t == "Oscillator" and "clock" not in (inst.name or ""):
                # an f32 param plus a Python float adds in f32, as in jnp
                pd["val"] = f32(pd["val"]) + f32(rng.uniform(-1.0, 1.0))
            elif t == "Moog Filter":
                pd["freq"] = f32(rng.uniform(0.1, 0.8))
                pd["res"] = f32(rng.uniform(0.0, 0.9))
            elif t == "ADSR":
                pd["a_sec"] = f32(rng.uniform(0.001, 0.1))
                pd["d_sec"] = f32(rng.uniform(0.01, 0.3))
                pd["s_val"] = f32(rng.uniform(0.1, 0.9))
                pd["r_sec"] = f32(rng.uniform(0.01, 0.3))
            for k, v in pd.items():
                cols[inst.id][k].append(v)
    return {mid: {k: torch.from_numpy(np.stack(vs).astype(base[mid][k].dtype))
                  for k, vs in pd.items()}
            for mid, pd in cols.items()}


def kernel_check_patch(cfg: AudioConfig | None = None, *,
                       patch_cls=Patch) -> Patch:
    """A 3-channel patch that drives every device function of the fused
    kernel and every input fallback: Sync- and CV-driven oscillators, a
    feedback loop into a pitch CV, a CV-modulated filter, Add / Subtract /
    Multiply with In1 or In2 unconnected, Non-Linear, a negative VCA, a VCA
    with its CV unconnected, a mixer with an open input and an unconnected
    output channel.  Non-Linear feeds only an output channel, so every
    pitch path stays bit-exact between engines.

    ``patch_cls`` builds the same patch (same module ids) with another
    package's ``Patch``, for parity tests.
    """
    cfg = cfg or AudioConfig(channels=3)
    p = patch_cls(cfg)
    clk = p.add("Oscillator", val=-4.0, antialiasing=False, name="clock")
    lfo = p.add("Oscillator", val=-6.0, name="lfo")
    add = p.add("Add", constant=0.25, name="lfo_offset")
    osc_b = p.add("Oscillator", val=-1.5, name="vco_b")
    osc_a = p.add("Oscillator", val=-1.0, name="vco_a")
    sub = p.add("Subtract", name="diff")
    flt = p.add("Moog Filter", freq=0.3, res=0.6, exp_amt=0.3, name="vcf")
    fm = p.add("Multiply", constant=0.1, name="fm_amt")
    env = p.add("ADSR", a_sec=0.005, d_sec=0.05, s_val=0.6, r_sec=0.05,
                name="env")
    vca_neg = p.add("VCA", negative=True, name="vca_neg")
    vca_off = p.add("VCA", name="vca_off")
    zero = p.add("Multiply", name="zero")
    shaper = p.add("Non-Linear", constant=1.5, name="shaper")
    mix = p.add("Mono Mixer", gains=(0.5, 0.5, 0.3, 0.2), name="mix")
    p.connect(lfo, "Sine", add, "In1")
    p.connect(add, 0, osc_b, "CV")
    p.connect(clk, "Square", osc_b, "Sync")
    p.connect(fm, 0, osc_a, "CV")            # feedback: osc_a -> ... -> fm
    p.connect(osc_a, "Sawtooth", sub, "In1")
    p.connect(osc_b, "Square", sub, "In2")
    p.connect(sub, 0, flt, "Audio")
    p.connect(lfo, "Sine", flt, "CV")
    p.connect(flt, 0, fm, "In1")
    p.connect(clk, "Square", env, "Gate")
    p.connect(flt, 1, vca_neg, "Audio")
    p.connect(env, 0, vca_neg, "CV")
    p.connect(flt, 2, vca_off, "Audio")
    p.connect(lfo, "Sine", zero, "In2")
    p.connect(vca_neg, 0, shaper, "In1")
    p.connect(vca_neg, 0, mix, 0)
    p.connect(vca_off, 0, mix, 1)
    p.connect(zero, 0, mix, 2)
    p.connect(mix, 0, p.output, 0)
    if cfg.channels > 1:
        p.connect(shaper, 0, p.output, 1)
    return p
