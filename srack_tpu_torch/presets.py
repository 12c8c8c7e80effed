"""Preset patches (counterpart: ``srack_tpu/presets.py``).

1. :func:`sine_patch`        -- single VCO -> Output sine, mono.
2. :func:`subtractive_voice` -- VCO -> Moog LP -> VCA with ADSR + LFO pitch
   mod; the gate is a slow square-wave oscillator.
3. :func:`sequencer_patch`   -- clock + grid and pattern sequencers driving
   an 8-voice polyphonic subtractive synth.
4. :func:`feedback_patch`    -- cross-FM oscillator pair + filter feedback.
5. :func:`farm_params`       -- randomized parameter stacks for batch
   rendering, the same draws as the JAX package's.

6. :func:`reverb_patch`      -- the subtractive voice into a stereo
   Freeverb; the fused kernel cannot take it, the block engine does.
7. :func:`drum_machine`      -- a pattern-sequenced kit: a kick voice, a
   filtered-noise snare and a 400-frame hat Sample.
8. :func:`sampler_kit`       -- a drum kit of three one-second Samples.

Also :func:`gate_cv_voice` (a voice played through Input driver lanes) and
the check patches :func:`kernel_check_patch` and :func:`lane_check_patch`,
which drive every device function of the fused kernels,
:func:`block_check_patch`, which drives every phase of the block engine,
:func:`kit_check_patch`, which drives the sequencers' and the Sample's
whole-block forms, and :func:`gradient_patch`, the JAX package's gradient
check patch.  Every table is synthesized with numpy.
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


def gate_cv_voice(cfg: AudioConfig | None = None, *, cutoff: float = 0.5,
                  res: float = 0.3, a: float = 0.01, d: float = 0.1,
                  s: float = 0.6, r: float = 0.2, wave: str = "Sawtooth"):
    """Subtractive voice driven by external gate and pitch-CV Inputs: bind
    driver lanes from ``utils.notes.note_track`` to the returned handles.
    Returns ``(patch, gate_input, cv_input)``."""
    cfg = cfg or AudioConfig(channels=1)
    p = Patch(cfg)
    gate = p.add("Input", name="gate")
    cv = p.add("Input", name="cv")
    osc = p.add("Oscillator", name="osc")
    flt = p.add("Moog Filter", freq=cutoff, res=res)
    env = p.add("ADSR", a_sec=a, d_sec=d, s_val=s, r_sec=r)
    vca = p.add("VCA")
    p.connect(cv, 0, osc, "CV")
    p.connect(gate, 0, env, "Gate")
    p.connect(osc, wave, flt, "Audio")
    p.connect(flt, 0, vca, "Audio")
    p.connect(env, 0, vca, "CV")
    p.connect(vca, 0, p.output, 0)
    if cfg.channels > 1:
        p.connect(vca, 0, p.output, 1)
    return p, gate, cv


def sequencer_patch(cfg: AudioConfig | None = None) -> Patch:
    """Clock and grid/pattern sequencers driving 8 subtractive voices."""
    cfg = cfg or AudioConfig(channels=1)
    p = Patch(cfg)
    clk = p.add("Oscillator", val=-5.0, name="clock")  # ~13.75 Hz square

    # melodic voice from the grid sequencer
    seq = [(i * 3 % 24, i % 3 != 0) for i in range(16)]
    grid = p.add("Grid Sequencer", sequence=seq, n_steps=16, name="grid")
    p.connect(clk, "Square", grid, "Step")

    lead_osc = p.add("Oscillator", val=-2.0, name="lead_vco")
    p.connect(grid, "CV", lead_osc, "CV")
    lead_env = p.add("ADSR", a_sec=0.005, d_sec=0.1, s_val=0.3, r_sec=0.05,
                     name="lead_env")
    p.connect(grid, "Gate", lead_env, "Gate")
    lead_flt = p.add("Moog Filter", freq=0.4, res=0.5, name="lead_vcf")
    p.connect(lead_osc, "Sawtooth", lead_flt, "Audio")
    lead_vca = p.add("VCA", name="lead_vca")
    p.connect(lead_flt, 0, lead_vca, "Audio")
    p.connect(lead_env, 0, lead_vca, "CV")

    # 7 percussive voices from the pattern sequencer rows
    pattern = [[(True if (s % (r + 2) == 0) else None) for s in range(16)]
               for r in range(8)]
    pat = p.add("Pattern Sequencer", pattern=pattern, n_steps=16, name="pat")
    p.connect(clk, "Square", pat, "Step")
    p.connect(grid, "Sync", pat, "Sync")

    # 4 voices per sub-mix at 0.25 each keeps every bus within full scale
    mixers = [p.add("Mono Mixer", gains=(0.25, 0.25, 0.25, 0.25),
                    name=f"mix{i}") for i in range(2)]
    p.connect(lead_vca, 0, mixers[0], 0)
    for r in range(7):
        osc = p.add("Oscillator", val=-3.0 + r * 0.5, name=f"perc_vco{r}")
        env = p.add("ADSR", a_sec=0.001, d_sec=0.05, s_val=0.0, r_sec=0.02,
                    name=f"perc_env{r}")
        vca = p.add("VCA", name=f"perc_vca{r}")
        p.connect(pat, str(r), env, "Gate")
        p.connect(osc, "Square" if r % 2 else "Sine", vca, "Audio")
        p.connect(env, 0, vca, "CV")
        p.connect(vca, 0, mixers[(r + 1) // 4], (r + 1) % 4)
    final = p.add("Mono Mixer", gains=(0.5, 0.5, 0.0, 0.0), name="final_mix")
    p.connect(mixers[0], 0, final, 0)
    p.connect(mixers[1], 0, final, 1)
    p.connect(final, 0, p.output, 0)
    if cfg.channels > 1:
        p.connect(final, 0, p.output, 1)
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


def reverb_patch(cfg: AudioConfig | None = None) -> Patch:
    """Subtractive voice into Freeverb (stereo): exercises delay lines.

    Freeverb's 8 feedback combs sum coherently at room_size 0.7 (~6x gain
    on sustained input); wet/dry are set for the worst-case farm voice
    (randomized cutoff/resonance) to stay inside full scale."""
    cfg = cfg or AudioConfig(channels=2)
    p = subtractive_voice(cfg)
    vca = next(i for i in p if i.name == "vca")
    rev = p.add("Freeverb", room_size=0.7, dampening=0.4, wet=0.12, dry=0.3,
                name="verb")
    p.connect(p.handle(vca.id), 0, rev, "Left")
    p.connect(p.handle(vca.id), 0, rev, "Right")
    p.connect(rev, "Left", p.output, 0)
    if cfg.channels > 1:
        p.connect(rev, "Right", p.output, 1)
    return p


def drum_machine(cfg: AudioConfig | None = None) -> Patch:
    """Noise and Sample percussion driven by a pattern sequencer: a kick
    (a decaying Sine through a VCA), a snare (Noise through the Moog's
    bandpass and a VCA) and a hat (a synthesized 400-frame metallic Sample
    played at rate 1)."""
    cfg = cfg or AudioConfig(channels=1)
    p = Patch(cfg)
    clk = p.add("Oscillator", val=-4.5, name="clock")
    pat = p.add("Pattern Sequencer", n_steps=16, name="pat",
                pattern=[
                    [True, None, None, None] * 4,            # kick
                    [None, None, True, None] * 4,            # snare
                    [True, True, False, True] * 4,           # hats
                ])
    p.connect(clk, "Square", pat, "Step")

    kick_env = p.add("ADSR", a_sec=0.001, d_sec=0.12, s_val=0.0,
                     r_sec=0.05, name="kick_env")
    kick_osc = p.add("Oscillator", val=-3.5, name="kick_osc")
    kick_vca = p.add("VCA", name="kick_vca")
    p.connect(pat, "0", kick_env, "Gate")
    p.connect(kick_osc, "Sine", kick_vca, "Audio")
    p.connect(kick_env, 0, kick_vca, "CV")

    noise = p.add("Noise", name="noise")
    sn_env = p.add("ADSR", a_sec=0.001, d_sec=0.08, s_val=0.0,
                   r_sec=0.03, name="snare_env")
    sn_flt = p.add("Moog Filter", freq=0.6, res=0.3, name="snare_flt")
    sn_vca = p.add("VCA", name="snare_vca")
    p.connect(noise, 0, sn_flt, "Audio")
    p.connect(pat, "1", sn_env, "Gate")
    p.connect(sn_flt, 1, sn_vca, "Audio")  # bandpass
    p.connect(sn_env, 0, sn_vca, "CV")

    t = np.linspace(0, 1, 400)
    metallic = (np.sin(2 * np.pi * 317 * t) * np.sin(2 * np.pi * 1021 * t)
                * np.exp(-10 * t)).astype(np.float32)
    hat = p.add("Sample", samples=metallic,
                wav_sample_rate=cfg.sample_rate, name="hat")
    p.connect(pat, "2", hat, "Gate")

    # the JAX preset's gains: the worst-case sum of the three buses at the
    # long-render snare peak stays inside full scale
    mix = p.add("Mono Mixer", gains=(0.36, 0.22, 0.2, 0.0), name="mix")
    p.connect(kick_vca, 0, mix, 0)
    p.connect(sn_vca, 0, mix, 1)
    p.connect(hat, 0, mix, 2)
    p.connect(mix, 0, p.output, 0)
    if cfg.channels > 1:
        p.connect(mix, 0, p.output, 1)
    return p


def sampler_kit(cfg: AudioConfig | None = None) -> Patch:
    """A drum kit of real-length Samples: kick, snare and hat, each a
    one-second (``sample_rate``-frame) waveform played at rate 1, gated by
    a pattern sequencer's rows.  The same numpy draws (``default_rng(7)``)
    as the JAX preset."""
    cfg = cfg or AudioConfig()
    sr = cfg.sample_rate
    p = Patch(cfg)
    clk = p.add("Oscillator", val=-4.5, name="clock")
    pat = p.add("Pattern Sequencer", n_steps=16, name="pat",
                pattern=[
                    [True, None, None, None] * 4,            # kick
                    [None, None, True, None] * 4,            # snare
                    [True, True, False, True] * 4,           # hats
                ])
    p.connect(clk, "Square", pat, "Step")

    t = np.arange(sr, dtype=np.float64) / sr                 # 1 s of frames
    rng = np.random.default_rng(7)
    kick_wave = (np.sin(2 * np.pi * (45.0 + 85.0 * np.exp(-18.0 * t)) * t)
                 * np.exp(-6.0 * t)).astype(np.float32)
    snare_wave = (rng.uniform(-1.0, 1.0, sr)
                  * np.exp(-22.0 * t)).astype(np.float32)
    hat_wave = (rng.uniform(-1.0, 1.0, sr) * np.exp(-55.0 * t)
                * np.sin(2 * np.pi * 5900.0 * t)).astype(np.float32)

    mix = p.add("Mono Mixer", gains=(0.5, 0.3, 0.2, 0.0), name="mix")
    for row, (name, wave) in enumerate(
            (("kick", kick_wave), ("snare", snare_wave), ("hat", hat_wave))):
        smp = p.add("Sample", samples=wave, wav_sample_rate=sr, name=name)
        p.connect(pat, str(row), smp, "Gate")
        p.connect(smp, 0, mix, row)
    p.connect(mix, 0, p.output, 0)
    if cfg.channels > 1:
        p.connect(mix, 0, p.output, 1)
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


PRESETS = {
    "sine": sine_patch,
    "subtractive": subtractive_voice,
    "sequencer": sequencer_patch,
    "feedback": feedback_patch,
    "reverb": reverb_patch,
    "drums": drum_machine,
    "sampler": sampler_kit,
}


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


def lane_check_patch(cfg: AudioConfig | None = None, *,
                     patch_cls=Patch):
    """A 2-channel patch that drives the lane, sequencer and automation
    paths of the fused kernel: a driven Input (Step of the pattern
    sequencer and Sync of the grid), an undriven Input (a constant pitch
    offset), Noise, a Grid
    Sequencer with slide cells and negative notes (capacity 8, 7 steps),
    a Pattern Sequencer with its Sync unconnected (6 steps), and three
    automated params that take the modules off their hoisted paths: the
    VCO's ``val`` (an Oscillator with its CV connected), the envelope's
    ``d_sec`` and the filter's ``freq`` (CV unconnected).

    Returns ``(patch, automation)``: ``automation`` is the (module id,
    param) pairs to pass to ``compile_patch(..., automation=)``.
    ``patch_cls`` builds the same patch with another package's ``Patch``.
    """
    cfg = cfg or AudioConfig(channels=2)
    p = patch_cls(cfg)
    clk = p.add("Oscillator", val=-3.0, antialiasing=False, name="clock")
    gate = p.add("Input", name="gate")
    offset = p.add("Input", value=0.25, name="offset")
    noise = p.add("Noise", seed=7, name="noise")
    seq = [(0, True), None, (-5, False), (7, True), (-13, False), None,
           (12, True)]
    grid = p.add("Grid Sequencer", sequence=seq, n_steps=7, name="grid")
    rows = [[True, None, False, True, None, False],
            [None, True, True, None, None, None],
            [False, False, None, None, True, None]]
    pat = p.add("Pattern Sequencer", pattern=rows, n_steps=6, name="pat")
    pitch = p.add("Add", name="pitch")
    vco = p.add("Oscillator", val=-1.0, name="vco")
    env = p.add("ADSR", a_sec=0.002, d_sec=0.02, s_val=0.5, r_sec=0.03,
                name="env")
    vcf = p.add("Moog Filter", freq=0.4, res=0.5, name="vcf")
    vca = p.add("VCA", name="vca")
    perc = p.add("VCA", name="perc")
    mix = p.add("Mono Mixer", gains=(0.5, 0.4, 0.2, 0.1), name="mix")
    p.connect(clk, "Square", grid, "Step")
    p.connect(gate, 0, grid, "Sync")
    p.connect(gate, 0, pat, "Step")
    p.connect(grid, "CV", pitch, "In1")
    p.connect(offset, 0, pitch, "In2")
    p.connect(pitch, 0, vco, "CV")
    p.connect(grid, "Gate", env, "Gate")
    p.connect(vco, "Sawtooth", vcf, "Audio")
    p.connect(vcf, 0, vca, "Audio")
    p.connect(env, 0, vca, "CV")
    p.connect(noise, 0, perc, "Audio")
    p.connect(pat, "0", perc, "CV")
    p.connect(vca, 0, mix, 0)
    p.connect(perc, 0, mix, 1)
    p.connect(pat, "1", mix, 2)
    p.connect(grid, "Sync", mix, 3)
    p.connect(mix, 0, p.output, 0)
    if cfg.channels > 1:
        p.connect(grid, "CV", p.output, 1)
    automation = ((vco.id, "val"), (env.id, "d_sec"), (vcf.id, "freq"))
    return p, automation


def block_check_patch(cfg: AudioConfig | None = None, *,
                      patch_cls=Patch):
    """A mono patch that drives every phase of the block engine: an LFO
    Oscillator into a Multiply that gives a VCO's pitch CV, the LFO's
    Square also on the VCO's Sync (so the VCO's whole-block phase takes
    the segmented prefix-sum path); the VCO into a Freeverb's Left, whose
    Right output feeds nothing; the Freeverb into a Moog Filter, a VCA and
    Output; an ADSR gated by a clock Oscillator on the VCA's CV; and two
    automated Freeverb params, ``room_size`` (held per chunk) and ``wet``
    (per sample).

    The block engine puts the LFO, the Multiply, the VCO and the Freeverb
    in its pre phase and the clock, the ADSR, the filter and the VCA in a
    stage whose input wire is the Freeverb's Left.

    Returns ``(patch, automation)``: ``automation`` is the (module id,
    param) pairs to pass to ``compile_patch(..., automation=)``.
    ``patch_cls`` builds the same patch with another package's ``Patch``.
    """
    cfg = cfg or AudioConfig(channels=1)
    p = patch_cls(cfg)
    lfo = p.add("Oscillator", val=-6.5, name="lfo")
    depth = p.add("Multiply", constant=0.05, name="lfo_depth")
    vco = p.add("Oscillator", val=-1.0, name="vco")
    verb = p.add("Freeverb", room_size=0.6, dampening=0.5, wet=0.1, dry=0.3,
                 name="verb")
    vcf = p.add("Moog Filter", freq=0.4, res=0.4, name="vcf")
    clk = p.add("Oscillator", val=-5.5, antialiasing=False, name="clock")
    env = p.add("ADSR", a_sec=0.01, d_sec=0.08, s_val=0.5, r_sec=0.15,
                name="env")
    vca = p.add("VCA", name="vca")
    p.connect(lfo, "Sine", depth, "In1")
    p.connect(depth, 0, vco, "CV")
    p.connect(lfo, "Square", vco, "Sync")
    p.connect(vco, "Sawtooth", verb, "Left")
    p.connect(verb, "Left", vcf, "Audio")
    p.connect(clk, "Square", env, "Gate")
    p.connect(vcf, 0, vca, "Audio")
    p.connect(env, 0, vca, "CV")
    p.connect(vca, 0, p.output, 0)
    for c in range(1, cfg.channels):
        p.connect(vca, 0, p.output, c)
    return p, ((verb.id, "room_size"), (verb.id, "wet"))


def kit_check_patch(cfg: AudioConfig | None = None, *,
                    patch_cls=Patch) -> Patch:
    """A mono patch that drives the whole-block forms the kit presets
    bypass: a clock Oscillator's Square steps a Grid Sequencer (16 steps of
    notes 0, 12 and -12, so its CV is exactly 0, 1 or -1) and a Pattern
    Sequencer; a Sample of 4,000 frames at half the sample rate takes its
    Gate from pattern row 0 and its pitch CV from the grid (rates 0.25, 0.5
    and 1: powers of two, so every order of summation is exact), into a
    Moog Filter, a VCA and Output; an ADSR gated by pattern row 1 drives
    the VCA.

    The block engine runs the clock, the sequencers and the Sample in its
    pre phase (the sequencers' block forms on the row scans and the row
    gather, the Sample on its player with the CV's prefix sum) and the
    filter, the envelope and the VCA in a stage with two input wires.
    ``patch_cls`` builds the same patch with another package's ``Patch``.
    """
    cfg = cfg or AudioConfig(channels=1)
    p = patch_cls(cfg)
    clk = p.add("Oscillator", val=-4.5, name="clock")
    grid = p.add("Grid Sequencer", n_steps=16, name="grid",
                 sequence=[(0, True), (12, True), None, (-12, False)] * 4)
    pat = p.add("Pattern Sequencer", n_steps=16, name="pat",
                pattern=[[True, None, None, None] * 4,
                         [True, None, True, None] * 4])
    wav_sr = cfg.sample_rate / 2
    t = np.arange(4000, dtype=np.float64) / wav_sr
    wave = (np.sin(2 * np.pi * 110.0 * t) * np.exp(-8.0 * t)).astype(
        np.float32)
    smp = p.add("Sample", samples=wave, wav_sample_rate=wav_sr, name="smp")
    flt = p.add("Moog Filter", freq=0.5, res=0.3, name="flt")
    env = p.add("ADSR", a_sec=0.002, d_sec=0.05, s_val=0.6, r_sec=0.05,
                name="env")
    vca = p.add("VCA", name="vca")
    p.connect(clk, "Square", grid, "Step")
    p.connect(clk, "Square", pat, "Step")
    p.connect(pat, "0", smp, "Gate")
    p.connect(grid, "CV", smp, "CV")
    p.connect(smp, 0, flt, "Audio")
    p.connect(pat, "1", env, "Gate")
    p.connect(flt, 0, vca, "Audio")
    p.connect(env, 0, vca, "CV")
    for c in range(cfg.channels):
        p.connect(vca, 0, p.output, c)
    return p


def gradient_patch(cfg: AudioConfig | None = None, *,
                   patch_cls=Patch) -> Patch:
    """The gradient check patch of the JAX package's tests
    (``tests/test_gradients.py::_patch``): a clock Oscillator's Square
    gates an ADSR whose stage times lie off the sample lattice, a VCO's
    Sawtooth runs through a Moog Filter and a VCA into the Output.  It
    drives the Oscillator's pitch path (through the shadow phase), the
    ladder and the whole ADSR trajectory, the parts finite differences pin.
    ``patch_cls`` builds the same patch with another package's ``Patch``.
    """
    cfg = cfg or AudioConfig(sample_rate=4800, channels=1)
    p = patch_cls(cfg)
    clk = p.add("Oscillator", val=-5.0, name="clock")
    osc = p.add("Oscillator", val=-1.0, name="vco")
    env = p.add("ADSR", a_sec=0.004, d_sec=0.0093, s_val=0.4, r_sec=0.0117,
                name="env")
    flt = p.add("Moog Filter", freq=0.5, res=0.3, name="vcf")
    vca = p.add("VCA", name="vca")
    p.connect(clk, "Square", env, "Gate")
    p.connect(osc, "Sawtooth", flt, "Audio")
    p.connect(flt, 0, vca, "Audio")
    p.connect(env, 0, vca, "CV")
    for c in range(cfg.channels):
        p.connect(vca, 0, p.output, c)
    return p
