"""Command-line entry point: the app-shell layer (counterpart:
``srack_tpu/__main__.py``).

The reference is a desktop app whose ``main()`` wires a workspace, an
Output module, and a cpal audio engine together (reference:
src/main.rs:13-22,125-169); its "user interface" to a patch is the egui
canvas plus File Load/Save.  This build is headless by blueprint (SURVEY.md
preamble), so the app shell becomes a CLI over the same capabilities:

* ``render``  -- load a patch (``.srk``, ``.json`` patchfile, or a named
  preset) and render it to a WAV file, replacing the cpal output stream
  (src/main.rs:59-90) with an offline render.
* ``info``    -- inspect a patch: modules, params, wiring, execution plan
  (the textual stand-in for the patch-cord canvas, src/ui.rs:285-418).
* ``modules`` -- the module catalog with port labels
  (src/synth.rs:421-515 ``get_catalog`` / the Modules menu,
  src/main.rs:149-165).
* ``presets`` -- the built-in benchmark patches ("model zoo").

Renders run on the CUDA card unless ``--device`` names another device
(``--device cpu`` on a machine without one).

Usage::

    python -m srack_tpu_torch render subtractive -o voice.wav --seconds 5
    python -m srack_tpu_torch render mypatch.srk -o out.wav
    python -m srack_tpu_torch midi song.mid -o song.wav --voices 8
    python -m srack_tpu_torch info mypatch.srk
    python -m srack_tpu_torch modules
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _load_patch(source: str, args):
    """Resolve a CLI patch source: preset name, .srk file, or .json file."""
    import dataclasses

    from .presets import PRESETS

    overrides = {}
    if args.sample_rate:
        overrides["sample_rate"] = args.sample_rate
    if args.channels:
        overrides["channels"] = args.channels
    if getattr(args, "precision", None):
        overrides["precision"] = args.precision
    if getattr(args, "buffer_feedback", False):
        overrides["buffer_feedback"] = True

    if source in PRESETS:
        patch = PRESETS[source](None)
    elif source.endswith(".srk"):
        from .io.srk import read_srk
        with open(source, "rb") as f:
            data = f.read()
        patch = read_srk(data)
    elif source.endswith(".json"):
        from .io.patchfile import load_patch
        patch = load_patch(source)
    else:
        raise SystemExit(
            f"unknown patch source {source!r}: expected a preset name "
            f"({', '.join(sorted(PRESETS))}), a .srk file, or a .json "
            f"patchfile")
    if overrides:
        # replace only the overridden fields, preserving the source's own
        # defaults (e.g. the sine preset is mono; --sample-rate must not
        # silently flip it to the dataclass default of 2 channels).
        # set_audio_config mirrors the reference's Output-disconnect
        # behaviour (output.rs:39-44), which would leave the patch silent
        # -- re-apply the saved wiring wherever the port still exists.
        saved = patch.connections()
        patch.set_audio_config(dataclasses.replace(patch.config, **overrides))
        for src, sport, sink, sport2 in saved:
            inst = patch[sink]
            if sport2 < len(inst.inputs) and inst.inputs[sport2] is None:
                patch.connect(patch.handle(src), sport,
                              patch.handle(sink), sport2)
        # channel upscaling: mirror channel 0 into newly added output
        # ports (the presets' own stereo convention) instead of leaving
        # them silently disconnected
        out_inst = patch[patch.output]
        if out_inst.inputs and out_inst.inputs[0] is not None:
            src, sport = out_inst.inputs[0]
            for c in range(1, len(out_inst.inputs)):
                if out_inst.inputs[c] is None:
                    patch.connect(patch.handle(src), sport, patch.output, c)
    return patch


def _cmd_render(args) -> int:
    from . import engine
    from .io.wav import write_wav

    patch = _load_patch(args.source, args)
    sr = patch.config.sample_rate
    if args.samples is not None:
        n = int(args.samples)
    else:
        n = int(round(args.seconds * sr))
    if n <= 0:
        raise SystemExit("nothing to render: n_samples <= 0")

    t0 = time.perf_counter()
    segment = 48000 * 20
    if n > segment:
        audio, _ = engine.render_long(patch, n, key=args.seed,
                                      segment=segment, engine=args.engine,
                                      device=args.device)
    else:
        audio, _, _ = engine.render(patch, n, key=args.seed,
                                    engine=args.engine, device=args.device)
    audio = audio.cpu().numpy()
    dt = time.perf_counter() - t0

    out = args.output or "out.wav"
    write_wav(out, audio, sr, bits=args.bits)
    peak = float(np.abs(audio).max()) if audio.size else 0.0
    rtf = (n / sr) / dt if dt > 0 else float("inf")
    print(f"rendered {n} samples ({n / sr:.2f}s) x{audio.shape[0]}ch "
          f"in {dt:.2f}s ({rtf:.1f}x real-time), peak {peak:.3f} -> {out}")
    return 0


def _cmd_midi(args) -> int:
    """Render a .mid file through gate/CV-driven subtractive voices
    (polyphonic: notes are allocated onto ``--voices`` monophonic lanes and
    batch-rendered, one voice per lane)."""
    from . import engine
    from .config import AudioConfig
    from .io.midi import read_midi
    from .io.wav import write_wav
    from .presets import gate_cv_voice
    from .utils.notes import allocate_voices, note_tracks

    events = read_midi(args.source, channel=args.channel)
    if not events:
        raise SystemExit("no notes found in MIDI file")
    sr = args.sample_rate or 48000
    tail = 0.5  # let the release ring out
    n = int(round((max(s + d for _, s, d in events) + tail) * sr))

    cfg = AudioConfig(sample_rate=sr, channels=1, precision="fast")
    p, gate_in, cv_in = gate_cv_voice(cfg)

    v = max(1, args.voices)
    lanes = allocate_voices(events, v)
    gates, cvs = note_tracks(lanes, n, sr)
    params = engine.replicate_params(p.params(), v)

    # segment long renders (a call holds its whole output in device
    # memory); state carries across segments so envelopes and oscillators
    # continue
    seg = 48000 * 20
    mixed = np.zeros((cfg.channels, n), np.float32)
    state = None
    done = 0
    while done < n:
        m = min(seg, n - done)
        audio, _, state = engine.render_batch(
            p, m, params=params, state=state,
            drivers={gate_in: gates[:, done:done + m],
                     cv_in: cvs[:, done:done + m]},
            engine=args.engine, device=args.device)
        mixed[:, done:done + m] = audio.cpu().numpy().sum(axis=0)
        done += m
    peak = float(np.abs(mixed).max())
    if peak > 1.0:
        mixed = mixed / (peak * 1.02)
    out = args.output or "out.wav"
    write_wav(out, mixed, sr, bits=args.bits)
    print(f"rendered {len(events)} notes on {v} voices, {n / sr:.2f}s, "
          f"mix peak {peak:.3f}, written peak "
          f"{float(np.abs(mixed).max()):.3f} -> {out}")
    return 0


def _cmd_info(args) -> int:
    from .planner import plan_execution

    patch = _load_patch(args.source, args)
    cfg = patch.config
    print(f"config: {cfg.sample_rate} Hz, {cfg.channels} ch, "
          f"block {cfg.block_size}, precision={cfg.precision}, "
          f"buffer_feedback={cfg.buffer_feedback}")
    print(f"modules ({len(patch)}):")
    for inst in patch:
        ps = ", ".join(f"{k}={v.tolist()}"
                       for k, v in sorted(inst.params.items()))
        print(f"  {inst.id}  [{inst.mdef.type_name}]"
              + (f"  {ps}" if ps else ""))
    conns = patch.connections()
    print(f"connections ({len(conns)}):")
    for src, sport, sink, sport2 in conns:
        print(f"  {src}:{sport} -> {sink}:{sport2}")
    plan, broken = plan_execution(patch)
    print("plan: " + " -> ".join(plan))
    if broken:
        print("feedback edges (read previous "
              + ("block" if cfg.buffer_feedback else "sample") + "):")
        for sink, src in sorted(broken):
            print(f"  {src} ~> {sink}")
    return 0


def _cmd_modules(args) -> int:
    from .config import AudioConfig
    from .modules import CATALOG

    cfg = AudioConfig()
    for name in sorted(CATALOG):
        mdef = CATALOG[name]
        try:
            statics, params = mdef.make(cfg)
        except TypeError:
            # needs construction args (e.g. Sample wants a waveform)
            print(f"{name}: (requires construction arguments)")
            continue
        nin = mdef.num_inputs(cfg, statics)
        nout = mdef.num_outputs(cfg, statics)
        inl = mdef.input_labels(cfg, statics)
        outl = mdef.output_labels(cfg, statics)
        fmt = lambda labels: ", ".join(
            (l if l is not None else str(i)) for i, l in enumerate(labels))
        print(f"{name}: in[{nin}]=({fmt(inl)}) out[{nout}]=({fmt(outl)})"
              + (f" params: {', '.join(sorted(params))}" if params else ""))
    return 0


def _cmd_presets(args) -> int:
    from .presets import PRESETS
    for name in sorted(PRESETS):
        doc = (PRESETS[name].__doc__ or "").strip().splitlines()
        print(f"{name}: {doc[0] if doc else ''}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="srack_tpu_torch",
        description="modular synthesis on PyTorch and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_source_opts(p):
        p.add_argument("source", help="preset name, .srk file, or .json "
                       "patchfile")
        p.add_argument("--sample-rate", type=int, default=None)
        p.add_argument("--channels", type=int, default=None)
        p.add_argument("--precision", choices=("fast", "exact"), default=None)
        p.add_argument("--buffer-feedback", action="store_true",
                       help="reference-exact previous-buffer feedback timing")

    rp = sub.add_parser("render", help="render a patch to a WAV file")
    add_source_opts(rp)
    rp.add_argument("-o", "--output", default=None, help="output WAV path")
    rp.add_argument("--seconds", type=float, default=5.0)
    rp.add_argument("--samples", type=int, default=None,
                    help="exact sample count (overrides --seconds)")
    rp.add_argument("--engine", choices=("auto", "scan", "block", "fused"),
                    default="auto")
    rp.add_argument("--seed", type=int, default=0)
    rp.add_argument("--bits", type=int, default=16, choices=(16, 32))
    rp.add_argument("--device", default=None,
                    help="render device (default: the CUDA card)")
    rp.set_defaults(fn=_cmd_render)

    ip = sub.add_parser("info", help="inspect a patch")
    add_source_opts(ip)
    ip.set_defaults(fn=_cmd_info)

    mid = sub.add_parser("midi", help="render a .mid file through a "
                         "built-in subtractive voice")
    mid.add_argument("source", help=".mid file")
    mid.add_argument("-o", "--output", default=None, help="output WAV path")
    mid.add_argument("--channel", type=int, default=None,
                     help="only this MIDI channel (default: all)")
    mid.add_argument("--voices", type=int, default=8,
                     help="polyphony (monophonic lanes, oldest-note steal)")
    mid.add_argument("--sample-rate", type=int, default=None)
    mid.add_argument("--engine", choices=("auto", "scan", "block", "fused"),
                     default="auto")
    mid.add_argument("--bits", type=int, default=16, choices=(16, 32))
    mid.add_argument("--device", default=None,
                     help="render device (default: the CUDA card)")
    mid.set_defaults(fn=_cmd_midi)

    mp = sub.add_parser("modules", help="list the module catalog")
    mp.set_defaults(fn=_cmd_modules)

    pp = sub.add_parser("presets", help="list built-in presets")
    pp.set_defaults(fn=_cmd_presets)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
