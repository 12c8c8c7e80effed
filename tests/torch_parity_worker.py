"""Reference renders of the JAX package for the torch port's parity tests.

    python tests/torch_parity_worker.py OUT.npz CASE [CASE ...]

Renders each case with ``srack_tpu`` on the CPU from the JAX
``farm_params`` of 4 voices at 4,800 Hz and saves params, initial state,
lanes, audio, probes and final state to ``OUT.npz`` (keys
``<case>/<what>/<path>``).  Cases:

* a preset name (``subtractive_voice``, ``sine_patch``, ``feedback_patch``,
  ``sequencer_patch``) or ``kernel_check_patch``: the scan engine at
  n=256 and the fused Pallas kernel K1 in interpret mode at n=32 and n=23
  (the kernel's padded tail, t_chunk=16);
* ``lane_check_patch``: the same runs with numpy driver lanes on its
  driven Input and its Noise module, automation arrays on the VCO's
  ``val`` and the envelope's ``d_sec`` (the filter's automated ``freq``
  holds its static value), and probes on the scan run;
* ``feedback_buffer``: feedback_patch in buffer-feedback mode, block 32,
  the scan engine at n=128 and kernel K2 in interpret mode at n=64.

The block engine's cases (slice 3a) make their inputs here from numpy
seeds and save them beside the results:

* ``reverb_patch`` and ``block_check_patch`` (with ``@block`` appended):
  the JAX block engine at n=512 (block_check_patch with automation lanes
  on the Freeverb's ``room_size`` and ``wet``), and the stage on kernel
  K3 in interpret mode (``make_serial_kernel``, t_chunk=64, unroll=4) at
  n=70 and n=64, from random oscillator phases and random stage-in lanes;
* ``freeverb``: the Freeverb ``_step`` over 256 samples from random rings
  with non-zero write indices; ``_block`` at n=512 and n=300 with
  automated ``room_size`` and ``wet``; and kernel K8 in interpret mode
  (``freeverb_kernel.entry`` at the shapes of
  ``tests/test_freeverb_kernel.py``);
* ``osc_block``: the Oscillator's ``_osc_block`` free-running, with a CV,
  with a Sync, with both, and with an automated ``val``;
* ``scan``: the ``ops/basic`` scan wrappers off the TPU (log-doubling) and
  kernel K4 in interpret mode (``scan_kernel._scan_rows``), four kinds;
* ``ring_roll``: kernel K9 in interpret mode (``ring_roll._align_rows``).

Slice 3b's cases, inputs made here from numpy seeds as well:

* ``drum_machine``, ``sampler_kit`` and ``kit_check_patch`` with ``@block``
  appended: the JAX block engine at n=512 from a state with random
  oscillator phases, sequencer steps and Sample positions (drum_machine's
  Noise fed one numpy lane as a driver);
* ``feedback_patch``, ``drum_machine`` and ``reverb_patch`` with
  ``@buffer`` appended: the JAX block engine's buffer-feedback mode, block
  64, n=512;
* ``sample``: the Sample's ``_step`` over 512 samples, its ``_block`` (the
  unfused XLA form off the TPU) at n=512 and 300, and kernel K7 in
  interpret mode (``sample_kernel.play_rows``) at the shapes of
  ``tests/test_sample_kernel.py``;
* ``gather``: kernels K5 (``scan_kernel._gather_rows``) and K6
  (``sample_gather._gather_rows``) in interpret mode;
* ``seq_block``: the sequencers' ``_grid_block`` and ``_pat_block``.

Slice 5's cases (gradients and training), inputs from numpy seeds:

* ``grad:<name>`` (``gradient_patch``, ``subtractive_voice`` with a fast
  gate clock, ``feedback_patch``): ``jax.grad`` through the scan engine of
  a weighted sum of the audio and the final float state, V=2, n=256;
* ``vjp``: the JAX fused VJP, both Pallas kernels in interpret mode
  (``make_fused_vjp``, t_chunk=16), V=2, n=32;
* ``vjp_long``: its forward over n=300 in chunks of t_chunk=128, V=2:
  the audio and the final state;
* ``losses``: ``utils/losses.py`` and its gradients in float64;
* ``train``: three ``batched_train_step`` steps with ``optax.adam(1e-3)``.

Exact precision's cases (``precision="exact"``, 4,800 Hz, x64), inputs
from numpy seeds:

* ``<name>@exact`` for ``subtractive_voice``, ``feedback_patch``,
  ``feedback_buffer`` (feedback_patch in buffer-feedback mode, block 64),
  ``reverb_patch`` and ``drum_machine``: the scan engine and the block
  engine at n=384 from one state, every Oscillator at a random f64 phase,
  every Freeverb line, index and filter state random, the sequencers at
  random steps and the Samples at random frames (drum_machine's Noise fed
  one numpy lane);
* ``osc_exact``: the Oscillator's exact ``_osc_block`` free-running, with
  a CV, a Sync, both, and an automated ``val``;
* ``freeverb_exact``: the Freeverb's exact ``_step`` over 256 samples and
  its exact ``_block`` at n=512 and n=300 (automated ``room_size`` and
  ``wet``), from random f64 rings with non-zero write indices;
* ``drift``: subtractive_voice at 4,800 Hz, 2 voices of farm_params, 1 s,
  the scan engine in fast and in exact precision;
* ``drift48``: the same voice at 48 kHz, 4 voices of farm_params, 1 s
  (48,000 samples), the scan engine in fast and in exact precision, in
  three renders cut at ``DRIFT48_WINDOW``; each precision's audio and its
  state at the window's start.

The port's farm, io and CLI twins (slice 11):

* ``farm``: ``srack_tpu.parallel.render_farm`` on the 8-device CPU mesh
  of ``make_mesh()`` (the worker asks XLA for 8 host devices when this
  case is named): exact subtractive_voice at 4,800 Hz, 16 voices of
  farm_params, 256 samples, per voice and mixed down;
* ``srk_fixture``: ``tests/data/reference_all_modules.srk`` read at 48
  kHz, stereo, block 16, and rendered by the scan engine over 256
  samples, its Noise fed one numpy lane (saved beside the audio);
* ``cli_sine``: the bytes of the WAV that ``python -m srack_tpu render
  sine --samples 4096`` writes.

It runs in its own process because XLA's CPU backend contracts ``a*b+c``
into one fused multiply-add when the host has FMA, which rounds the
polynomials once where the port (and the TPU) round twice, and the XLA flag
that prevents it, ``--xla_cpu_max_isa=AVX``, is read once per process.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_max_isa=AVX").strip()
if "farm" in sys.argv[2:]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import srack_tpu as st  # noqa: E402
from srack_tpu import presets  # noqa: E402
from srack_tpu.ops import fused  # noqa: E402

VOICES = 4
SCAN_N = 256
KERNEL_NS = (32, 23)  # 23: the kernel's padded-tail path (t_chunk=16)
BUFFER_BLOCK, BUFFER_SCAN_N, BUFFER_KERNEL_N = 32, 128, 64
LANE_PROBES = (("grid", 0), ("grid", 1), ("pat", 0), ("pat", 8),
               ("noise", 0), ("offset", 0), ("env", 0))


def build(name: str):
    """``(patch, automation)`` for a case, built with the JAX ``Patch``."""
    if name == "kernel_check_patch":
        from srack_tpu_torch.presets import kernel_check_patch
        cfg = st.AudioConfig(sample_rate=4800, block_size=64, channels=3,
                             precision="fast")
        return kernel_check_patch(cfg, patch_cls=st.Patch), ()
    if name == "lane_check_patch":
        from srack_tpu_torch.presets import lane_check_patch
        cfg = st.AudioConfig(sample_rate=4800, block_size=64, channels=2,
                             precision="fast")
        return lane_check_patch(cfg, patch_cls=st.Patch)
    if name == "feedback_buffer":
        cfg = st.AudioConfig(sample_rate=4800, block_size=BUFFER_BLOCK,
                             channels=1, precision="fast",
                             buffer_feedback=True)
        return presets.feedback_patch(cfg), ()
    cfg = st.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                         precision="fast")
    return getattr(presets, name)(cfg), ()


def lane_drivers(patch, n: int) -> dict:
    """numpy lanes ``[V, n]`` for the lane check patch, from a seed."""
    rng = np.random.default_rng(1234)
    ids = {inst.name: inst.id for inst in patch}
    gate = np.zeros((VOICES, n), np.float32)
    for v in range(VOICES):
        t, hi = 0, bool(v % 2)
        while t < n:
            run = int(rng.integers(1, 12))
            gate[v, t:t + run] = rng.uniform(0.1, 1.0) if hi else 0.0
            t, hi = t + run, not hi
    return {
        ids["gate"]: gate,
        ids["noise"]: ((rng.uniform(0.0, 1.0, (VOICES, n)) - 0.5)
                       * 2.0).astype(np.float32),
        f"{ids['vco']}~val": rng.uniform(-1.5, 0.5,
                                         (VOICES, n)).astype(np.float32),
        f"{ids['env']}~d_sec": rng.uniform(0.005, 0.05,
                                           (VOICES, n)).astype(np.float32),
    }


def flat(prefix: str, tree, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{k[0]}:{k[1]}" if isinstance(k, tuple) else str(k)
            flat(f"{prefix}/{key}", v, out)
    else:
        out[prefix] = np.asarray(tree)


BLOCK_N, STAGE_NS = 512, (70, 64)


def _seeded_state(compiled, v, rng, params=None):
    """init_state for V voices with every oscillator at a random phase,
    every sequencer at a random step below its length and every Sample at
    a random whole-frame position (so that the scan engine's running sum
    and the block form's prefix sum agree exactly), playing or not, its
    gate edge state random."""
    state = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                         compiled.init_state())
    for mid, (mdef, _, _) in compiled.instances.items():
        sd = state["states"][mid]
        if mdef.type_name == "Oscillator":
            sd["pos"] = jnp.asarray(rng.integers(
                -2 ** 31, 2 ** 31 - 1, v, dtype=np.int64).astype(np.int32))
        elif mdef.type_name.endswith("Sequencer"):
            steps = np.asarray(params[mid]["n_steps"])
            sd["current_step"] = jnp.asarray(
                (rng.integers(0, 1 << 20, v) % steps).astype(np.int32))
        elif mdef.type_name == "Sample":
            length = np.asarray(params[mid]["length"])
            sd["pos"] = jnp.asarray(
                (rng.integers(0, 1 << 20, v) % length).astype(np.float32))
            sd["playing"] = jnp.asarray(rng.uniform(size=v) < 0.5)
            sd["gate_last"] = jnp.asarray(rng.uniform(size=v) < 0.5)
    return state


KIT_CASES = ("drum_machine", "sampler_kit", "kit_check_patch")


def kit_build(name: str, **kw):
    """A slice-3b patch at 4,800 Hz, mono, block 64, built with the JAX
    ``Patch``."""
    cfg = st.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                         precision="fast", **kw)
    if name == "kit_check_patch":
        from srack_tpu_torch.presets import kit_check_patch
        return kit_check_patch(cfg, patch_cls=st.Patch)
    return getattr(presets, name)(cfg)


def noise_drivers(patch, n: int, rng) -> dict:
    """One numpy lane ``[V, n]`` for each Noise module, fed to both
    packages (their generators differ by design)."""
    return {inst.id: rng.uniform(-1.0, 1.0, (VOICES, n)).astype(np.float32)
            for inst in patch if inst.mdef.type_name == "Noise"}


def kit_case(name: str, out: dict, buffer: bool) -> None:
    """The JAX block engine on a slice-3b case, sample or buffer mode."""
    tag = f"{name}@{'buffer' if buffer else 'block'}"
    if name in KIT_CASES:
        patch = kit_build(name, buffer_feedback=buffer)
    else:
        cfg = st.AudioConfig(sample_rate=4800, block_size=64,
                             channels=2 if name == "reverb_patch" else 1,
                             precision="fast", buffer_feedback=buffer)
        patch = getattr(presets, name)(cfg)
    compiled = st.compile_patch(patch)
    rng = np.random.default_rng(31)
    params = presets.farm_params(patch, VOICES)
    state = _seeded_state(compiled, VOICES, rng, params)
    drivers = noise_drivers(patch, BLOCK_N, rng)
    keys = jax.random.split(jax.random.PRNGKey(0), VOICES)
    flat(f"{tag}/params", params, out)
    flat(f"{tag}/state", state, out)
    flat(f"{tag}/drivers", drivers, out)
    out[f"{tag}/plan"] = np.asarray(compiled.plan)
    audio, _, final = compiled._get_fn(BLOCK_N, True, "block")(
        params, state, keys, {k: jnp.asarray(a) for k, a in drivers.items()})
    flat(f"{tag}/block{BLOCK_N}/audio", audio, out)
    flat(f"{tag}/block{BLOCK_N}/final", final, out)


def block_case(name: str, out: dict) -> None:
    """The JAX block engine and kernel K3 in interpret mode."""
    from srack_tpu import block_engine
    from srack_tpu.ops import serial_kernel
    from srack_tpu_torch.presets import block_check_patch
    if name == "reverb_patch":
        cfg = st.AudioConfig(sample_rate=4800, block_size=64, channels=2,
                             precision="fast")
        patch, autos = presets.reverb_patch(cfg), ()
    else:
        cfg = st.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                             precision="fast")
        patch, autos = block_check_patch(cfg, patch_cls=st.Patch)
    tag = f"{name}@block"
    compiled = st.compile_patch(patch, automation=autos)
    rng = np.random.default_rng(99)
    params = presets.farm_params(patch, VOICES)
    state = _seeded_state(compiled, VOICES, rng)
    drivers = {}
    for mid, p in autos:
        lo, hi = (0.3, 0.9) if p == "room_size" else (0.05, 0.3)
        drivers[f"{mid}~{p}"] = rng.uniform(
            lo, hi, (VOICES, BLOCK_N)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), VOICES)
    flat(f"{tag}/params", params, out)
    flat(f"{tag}/state", state, out)
    flat(f"{tag}/drivers", drivers, out)
    out[f"{tag}/plan"] = np.asarray(compiled.plan)
    audio, _, final = compiled._get_fn(BLOCK_N, True, "block")(
        params, state, keys, {k: jnp.asarray(a) for k, a in drivers.items()})
    flat(f"{tag}/block{BLOCK_N}/audio", audio, out)
    flat(f"{tag}/block{BLOCK_N}/final", final, out)

    prog = compiled.block_program()

    def wire_key(w):
        return f"{w[0]}#{w[1]}"

    def eval_key(k):
        mid, port = k.rsplit("#", 1)
        return (mid, int(port))

    def kernel_step(k_params, k_state, ins_dict):
        # as block_engine.BlockProgram.make_run makes it (sample mode)
        ext = {eval_key(k): v for k, v in ins_dict.items()}
        new_states, fb_out, outs, _ = prog._stage_step(
            k_params, k_state["states"], k_state["fb"], ext)
        return ({"states": new_states, "fb": fb_out},
                {wire_key(w): outs[w] for w in prog.stage_out})

    derived = compiled.derived_params(params)
    stage_params = {m: derived[m] for m in prog.stage_plan}
    stage_state = {"states": {m: state["states"][m]
                              for m in prog.stage_plan},
                   "fb": state["fb"]}
    assert block_engine.PALLAS_SAFE and prog.pallas_ok
    for n in STAGE_NS:
        lanes = {wire_key(w): rng.uniform(-1, 1, (VOICES, n)).astype(
            np.float32) for w in prog.stage_in}
        kern = serial_kernel.make_serial_kernel(
            kernel_step, n, [wire_key(w) for w in prog.stage_out],
            t_chunk=64, unroll=4, interpret=True)
        outs, final = jax.jit(kern)(
            stage_params, stage_state,
            {k: jnp.asarray(a) for k, a in lanes.items()})
        flat(f"{tag}/k3_{n}/lanes", lanes, out)
        flat(f"{tag}/k3_{n}/outs", outs, out)
        flat(f"{tag}/k3_{n}/final", final, out)


def freeverb_case(out: dict) -> None:
    """The Freeverb's step and block form, and K8 in interpret mode."""
    from srack_tpu.modules import freeverb as jfv
    from srack_tpu.ops import freeverb_kernel as fvk
    cfg = st.AudioConfig(sample_rate=4800, channels=2, precision="fast")
    statics, p0 = jfv.FREEVERB.make(cfg, room_size=0.7, dampening=0.4,
                                    wet=0.3, dry=0.2)
    rng = np.random.default_rng(5)
    v = VOICES
    state = {}
    for k, a in jfv._init_state(cfg, statics).items():
        if k.endswith("_idx"):
            continue
        state[k] = (rng.standard_normal((v,) + a.shape) * 0.1).astype(
            np.float32)
        if a.ndim:
            state[f"{k}_idx"] = rng.integers(0, a.shape[0], v).astype(
                np.int32)
    params = {k: np.broadcast_to(np.asarray(a), (v,)).copy()
              for k, a in p0.items()}
    params["room_size"] = rng.uniform(0.3, 0.9, v).astype(np.float32)
    params["dampening"] = rng.uniform(0.0, 1.0, v).astype(np.float32)
    flat("freeverb/state", state, out)
    flat("freeverb/params", params, out)

    n = 256
    lanes = (rng.standard_normal((2, v, n)) * 0.3).astype(np.float32)
    out["freeverb/step/lanes"] = lanes

    def run_steps(p, s, lr):
        def body(carry, x):
            carry, outs = jfv.FREEVERB.step(cfg, statics, p, carry,
                                            [x[0], x[1]])
            return carry, jnp.stack(outs)
        final, ys = jax.lax.scan(body, s, lr.T)
        return ys.T, final

    audio, final = jax.jit(jax.vmap(run_steps, in_axes=(0, 0, 1)))(
        params, state, jnp.asarray(lanes))
    flat("freeverb/step/audio", audio, out)
    flat("freeverb/step/final", final, out)

    for n in (512, 300):
        lanes = (rng.standard_normal((2, v, n)) * 0.3).astype(np.float32)
        autos = {"room_size": rng.uniform(0.3, 0.9, (v, n)).astype(
                     np.float32),
                 "wet": rng.uniform(0.1, 0.5, (v, n)).astype(np.float32)}
        out[f"freeverb/block{n}/lanes"] = lanes
        flat(f"freeverb/block{n}/autos", autos, out)

        def run_block(p, a, s, lr, n=n):
            return jfv._block(cfg, statics, {**p, **a}, s, [lr[0], lr[1]],
                              None, n)

        final, audio = jax.jit(jax.vmap(run_block, in_axes=(0, 0, 0, 1)))(
            params, autos, state, jnp.asarray(lanes))
        flat(f"freeverb/block{n}/audio", jnp.stack(audio, axis=1), out)
        flat(f"freeverb/block{n}/final", final, out)

    # K8 in interpret mode, one voice, tests/test_freeverb_kernel.py shapes
    comb_lens = (202, 215, 231, 246, 258, 270, 282, 293,
                 206, 219, 235, 250, 262, 274, 286, 297)
    ap_lens = (100, 80, 61, 40, 104, 84, 65, 44)
    n, t_c = 256, 128
    mixed = (rng.normal(size=n) * 0.1).astype(np.float32)
    fs0 = (rng.normal(size=16) * 0.1).astype(np.float32)
    damp, feed = np.float32(0.35), np.float32(0.84)
    hists = [(rng.normal(size=length) * 0.1).astype(np.float32)
             for length in comb_lens + ap_lens]
    outs = fvk.entry(comb_lens, ap_lens, n, t_c)(
        jnp.asarray(mixed), jnp.asarray(fs0), jnp.asarray(damp),
        jnp.asarray(feed), *[jnp.asarray(h) for h in hists])
    out["freeverb/k8/mixed"] = mixed
    out["freeverb/k8/fs0"] = fs0
    out["freeverb/k8/damp_feed"] = np.asarray([damp, feed], np.float32)
    for j, h in enumerate(hists):
        out[f"freeverb/k8/hist{j}"] = h
    out["freeverb/k8/out"] = np.stack([np.asarray(outs[0]),
                                       np.asarray(outs[1])])
    out["freeverb/k8/fs"] = np.asarray(outs[2])
    for j, h in enumerate(outs[3:]):
        out[f"freeverb/k8/final{j}"] = np.asarray(h)


def osc_block_case(out: dict) -> None:
    """``_osc_block`` over [V, n] rows for each input combination."""
    from srack_tpu.modules import oscillator as josc
    cfg = st.AudioConfig(sample_rate=4800, precision="fast")
    rng = np.random.default_rng(11)
    v, n = VOICES, 300
    statics = ("antialias", True)
    for case in ("free", "cv", "sync", "cv_sync", "auto_val"):
        state = {
            "pos": rng.integers(-2 ** 31, 2 ** 31 - 1, v,
                                dtype=np.int64).astype(np.int32),
            "pos_g": rng.uniform(0, 3, v).astype(np.float32),
            "sync_last": rng.uniform(size=v) < 0.5}
        params = {"val": rng.uniform(-3, 1, v).astype(np.float32)}
        cv = (rng.uniform(-1, 1, (v, n)).astype(np.float32)
              if "cv" in case else None)
        sync = None
        if "sync" in case:
            sync = np.where(rng.uniform(size=(v, n)) < 0.05, 1.0,
                            -0.5).astype(np.float32)
        if case == "auto_val":
            params["val"] = rng.uniform(-3, 1, (v, n)).astype(np.float32)
        flat(f"osc_block/{case}/state", state, out)
        flat(f"osc_block/{case}/params", params, out)
        if cv is not None:
            out[f"osc_block/{case}/cv"] = cv
        if sync is not None:
            out[f"osc_block/{case}/sync"] = sync

        def one(p, s, c, y, case=case):
            if case == "free":
                p = {**p, **josc._osc_derive(cfg, statics, p, (False, False))}
            return josc._osc_block(cfg, statics, p, s, (c, y), None, n)

        final, waves = jax.jit(jax.vmap(one, in_axes=(
            0, 0, None if cv is None else 0, None if sync is None else 0)))(
            params, state, None if cv is None else jnp.asarray(cv),
            None if sync is None else jnp.asarray(sync))
        flat(f"osc_block/{case}/waves", jnp.stack(waves, axis=1), out)
        flat(f"osc_block/{case}/final", final, out)


def scan_case(out: dict) -> None:
    """The scan wrappers off the TPU and K4 in interpret mode."""
    from srack_tpu.ops import basic, scan_kernel
    rng = np.random.default_rng(13)
    shape = (3, 2500)
    xf = rng.standard_normal(shape).astype(np.float32)
    xi = rng.integers(-2 ** 31, 2 ** 31 - 1, shape,
                      dtype=np.int64).astype(np.int32)
    yf = rng.standard_normal(shape).astype(np.float32)
    mask = rng.uniform(size=shape) < 0.01
    mask[1] = False
    a = rng.uniform(0.9, 1.0, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    mono = np.cumsum(rng.integers(0, 7, shape), axis=-1).astype(np.int32)
    ins = dict(xf=xf, xi=xi, yf=yf, mask=mask, a=a, b=b, mono=mono)
    for k, arr in ins.items():
        out[f"scan/in/{k}"] = arr
    j = {k: jnp.asarray(arr) for k, arr in ins.items()}
    wrap = {
        "sum_f32": (basic.fast_cumsum(j["xf"], axis=-1),),
        "sum_i32": (basic.fast_cumsum(j["xi"], axis=-1),),
        "max_f32": (basic.fast_cummax(j["xf"], axis=-1),),
        "max_i32": (basic.fast_cummax(j["xi"], axis=-1),),
        "fill_f32": basic.forward_fill_multi((j["xf"], j["yf"]), j["mask"],
                                             axis=-1),
        "fill_i32": basic.forward_fill(j["xi"], j["mask"], axis=-1),
        "affine_f32": basic.affine_scan(j["a"], j["b"], axis=-1),
        "monotone_i32": basic.monotone_fill(j["mono"], j["mask"], axis=-1),
        "linrec_f32": basic.linear_recurrence(jnp.float32(0.95), j["b"],
                                              axis=-1),
    }
    for k, v in wrap.items():
        flat(f"scan/wrap/{k}", {str(i): x for i, x in enumerate(
            jax.tree.leaves(v))}, out)
    m32 = j["mask"].astype(jnp.int32)
    kern = {
        "sum_f32": ("sum", (j["xf"],)),
        "sum_i32": ("sum", (j["xi"],)),
        "max_f32": ("max", (j["xf"],)),
        "max_i32": ("max", (j["xi"],)),
        "fill_f32": ("fill", (j["xf"], j["yf"], m32)),
        "fill_i32": ("fill", (j["xi"], m32)),
        "affine_f32": ("affine", (j["a"], j["b"])),
    }
    for k, (kind, arrs) in kern.items():
        idents = tuple(scan_kernel._idents(kind, list(arrs)))
        res = scan_kernel._scan_rows(kind, tuple(arrs), idents, True)
        flat(f"scan/k4/{k}", {str(i): x for i, x in enumerate(res)}, out)


def ring_roll_case(out: dict) -> None:
    """K9 in interpret mode on several lengths and row counts."""
    from srack_tpu.ops import ring_roll
    rng = np.random.default_rng(17)
    for rows, length in ((3, 5), (33, 121), (7, 178), (4, 1)):
        buf = rng.standard_normal((rows, length)).astype(np.float32)
        idx = rng.integers(0, length, rows).astype(np.int32)
        res = ring_roll._align_rows(jnp.asarray(buf), jnp.asarray(idx),
                                    True)
        out[f"ring_roll/{rows}x{length}/buf"] = buf
        out[f"ring_roll/{rows}x{length}/idx"] = idx
        out[f"ring_roll/{rows}x{length}/out"] = np.asarray(res)


SAMPLE_K, SAMPLE_STEP_N = 300, 512


def _sample_inputs(rng, v, k, n, cv: bool):
    """Per-voice tables, lengths (one of them 0), rates 1, 0.5, 2 and 1
    (wav_sr over 4,800 Hz), gate runs and integer CVs (rates stay powers
    of two times the base)."""
    tbl = rng.standard_normal((v, k)).astype(np.float32)
    length = np.array([k, k * 2 // 5, 0, k * 5 // 6][:v], np.int32)
    wav_sr = np.array([4800.0, 2400.0, 9600.0, 4800.0][:v], np.float32)
    gate = np.zeros((v, n), np.float32)
    for r in range(v):
        t, hi = 0, bool(r % 2)
        while t < n:
            run = int(rng.integers(5, 90))
            gate[r, t:t + run] = rng.uniform(0.1, 1.0) if hi else 0.0
            t, hi = t + run, not hi
    cvl = (rng.integers(-1, 2, (v, n)).astype(np.float32) if cv else None)
    state = {"pos": rng.integers(0, k, v).astype(np.float32),
             "playing": rng.uniform(size=v) < 0.5,
             "gate_last": rng.uniform(size=v) < 0.5}
    return tbl, length, wav_sr, gate, cvl, state


def sample_case(out: dict) -> None:
    """The Sample's step and block form, and K7 in interpret mode."""
    from srack_tpu.modules import sample as jsmp
    from srack_tpu.ops import sample_kernel
    cfg = st.AudioConfig(sample_rate=4800, precision="fast")
    statics = ("sample", SAMPLE_K)
    rng = np.random.default_rng(41)
    v = VOICES

    # _step over 512 samples, CV connected
    tbl, length, wav_sr, gate, cvl, state = _sample_inputs(
        rng, v, SAMPLE_K, SAMPLE_STEP_N, True)
    params = {"samples": tbl, "length": length, "wav_sr": wav_sr}
    flat("sample/step/params", params, out)
    flat("sample/step/state", state, out)
    out["sample/step/gate"], out["sample/step/cv"] = gate, cvl

    def run_steps(p, s, g, c):
        def body(carry, x):
            carry, (o,) = jsmp.SAMPLE.step(cfg, statics, p, carry,
                                           [x[0], x[1]])
            return carry, o
        final, ys = jax.lax.scan(body, s, jnp.stack([g, c], axis=1))
        return ys, final

    audio, final = jax.jit(jax.vmap(run_steps))(params, state,
                                                jnp.asarray(gate),
                                                jnp.asarray(cvl))
    out["sample/step/out"] = np.asarray(audio)
    flat("sample/step/final", final, out)

    # _block, the unfused XLA form off the TPU
    for n in (512, 300):
        for cv in (False, True):
            tag = f"sample/block{n}_{'cv' if cv else 'const'}"
            tbl, length, wav_sr, gate, cvl, state = _sample_inputs(
                rng, v, SAMPLE_K, n, cv)
            params = {"samples": tbl, "length": length, "wav_sr": wav_sr}
            flat(f"{tag}/params", params, out)
            flat(f"{tag}/state", state, out)
            out[f"{tag}/gate"] = gate
            if cv:
                out[f"{tag}/cv"] = cvl

            def one(p, s, g, c, n=n):
                return jsmp._block(cfg, statics, p, s, (g, c), None, n)

            final, (res,) = jax.jit(jax.vmap(one, in_axes=(
                0, 0, 0, 0 if cv else None)))(
                params, state, jnp.asarray(gate),
                jnp.asarray(cvl) if cv else None)
            out[f"{tag}/out"] = np.asarray(res)
            flat(f"{tag}/final", final, out)

    # K7 in interpret mode: tests/test_sample_kernel.py's shapes
    runs = (("k400_const1", 400, 4608, None, 1.0, False),
            ("k400_const2", 400, 4608, None, 2.0, False),
            ("k400_cv", 400, 4608, "int", 0.5, True),
            ("k400_fuzz", 400, 4608, "fuzz", 0.937, False),
            ("k5000_const1", 5000, 4196, None, 1.0, False),
            ("k5000_cv", 5000, 4196, "int", 0.5, True))
    for tag, k, n, cv, base, carried in runs:
        tbl = rng.normal(size=(v, k)).astype(np.float32)
        p_trig = 1 / 900 if k == 5000 else 0.002
        gate = (rng.random((v, n)) < p_trig).astype(np.float32)
        cvl = None
        if cv == "int":
            cvl = rng.integers(-1, 2, (v, n)).astype(np.float32)
        elif cv == "fuzz":
            cvl = (rng.random((v, n)) * 0.2 - 0.1).astype(np.float32)
        if carried:
            pos = np.array([10.0, k - 600.0, 0.0, k - 1.0], np.float32)
            playing = np.array([True, True, False, True])
            last = np.array([False, True, False, False])
        else:
            pos = np.zeros(v, np.float32)
            playing = np.zeros(v, bool)
            last = np.ones(v, bool)
        length = np.array([k, k, k // 3, k], np.int32)
        ins = {"table": tbl, "gate": gate, "pos": pos, "playing": playing,
               "last": last, "length": length,
               "base": np.full(v, base, np.float32)}
        if cvl is not None:
            ins["cv"] = cvl
        flat(f"sample/k7_{tag}/in", ins, out)
        res = sample_kernel.play_rows(
            jnp.asarray(gate), None if cvl is None else jnp.asarray(cvl),
            jnp.asarray(tbl), jnp.asarray(ins["base"]), jnp.asarray(pos),
            jnp.asarray(playing), jnp.asarray(last), jnp.asarray(length))
        flat(f"sample/k7_{tag}/out", {str(i): x for i, x in enumerate(res)},
             out)


def gather_case(out: dict) -> None:
    """K5 and K6 in interpret mode; K5 also at indices at or past K."""
    from srack_tpu.ops import sample_gather, scan_kernel
    rng = np.random.default_rng(43)
    v, n = VOICES, 2100
    for k in (16, 64, 400):
        tbl = rng.integers(-1000, 1000, (v, k)).astype(np.int32)
        # in range, and past the table (the quirk case)
        idx = rng.integers(0, k, (v, n)).astype(np.int32)
        past = rng.integers(k, 2 * k + 5, (v, n)).astype(np.int32)
        for dt, t in (("f32", (tbl * 0.37).astype(np.float32)),
                      ("i32", tbl)):
            out[f"gather/k5_{k}_{dt}/table"] = t
            out[f"gather/k5_{k}_{dt}/idx"] = idx
            out[f"gather/k5_{k}_{dt}/past"] = past
            for what, ix in (("out", idx), ("out_past", past)):
                out[f"gather/k5_{k}_{dt}/{what}"] = np.asarray(
                    scan_kernel._gather_rows(jnp.asarray(t), jnp.asarray(ix),
                                             True))
    for k, pattern in ((400, "ramp"), (5000, "ramp"), (5000, "uniform")):
        tbl = rng.standard_normal((v, k)).astype(np.float32)
        if pattern == "ramp":   # monotone ramps with restarts
            t = np.arange(n)[None] * 1.3 + np.arange(v)[:, None] * 777
            idx = (t % (k - 1)).astype(np.int32)
        else:
            idx = rng.integers(0, k, (v, n)).astype(np.int32)
        tag = f"gather/k6_{k}_{pattern}"
        out[f"{tag}/table"], out[f"{tag}/idx"] = tbl, idx
        out[f"{tag}/out"] = np.asarray(sample_gather._gather_rows(
            jnp.asarray(tbl), jnp.asarray(idx), True))


SEQ_CAP = 8


def seq_block_case(out: dict) -> None:
    """``_grid_block`` and ``_pat_block`` over [V, n] from random carried
    states, Step runs and sparse Sync pulses."""
    from srack_tpu.modules import sequencer as jseq
    cfg = st.AudioConfig(sample_rate=4800, precision="fast")
    rng = np.random.default_rng(47)
    v, n = VOICES, 300
    n_steps = np.int32([5, SEQ_CAP, 7, 3])
    for kind in ("grid", "pat"):
        step = np.zeros((v, n), np.float32)
        for r in range(v):
            t, hi = 0, bool(r % 2)
            while t < n:
                run = int(rng.integers(1, 7))
                step[r, t:t + run] = rng.uniform(0.1, 1.0) if hi else -0.5
                t, hi = t + run, not hi
        sync = np.where(rng.uniform(size=(v, n)) < 0.03,
                        rng.uniform(0.1, 1.0, (v, n)), 0.0).astype(np.float32)
        state = {"current_step": (rng.integers(0, 100, v)
                                  % n_steps).astype(np.int32),
                 "step_last": rng.uniform(size=v) < 0.5,
                 "sync_last": rng.uniform(size=v) < 0.5}
        if kind == "grid":
            params = {"notes": rng.integers(-30, 30, (v, SEQ_CAP)).astype(
                          np.int32),
                      "cells": rng.integers(0, 3, (v, SEQ_CAP)).astype(
                          np.int32),
                      "n_steps": n_steps,
                      "steps_per_octave": np.int32([12, 7, 24, 5])}
            state["last_cv"] = rng.uniform(-1, 1, v).astype(np.float32)
            statics, mdef = ("gridseq", 2, SEQ_CAP), jseq.GRID_SEQUENCER
        else:
            params = {"cells": rng.integers(0, 3, (v, jseq.N_ROWS,
                                                   SEQ_CAP)).astype(np.int32),
                      "n_steps": n_steps}
            statics, mdef = ("patseq", jseq.N_ROWS, SEQ_CAP), \
                jseq.PATTERN_SEQUENCER
        tag = f"seq_block/{kind}"
        flat(f"{tag}/params", params, out)
        flat(f"{tag}/state", state, out)
        out[f"{tag}/step"], out[f"{tag}/sync"] = step, sync

        def one(p, s, a, b, mdef=mdef, statics=statics):
            p = {**p, **mdef.derive(cfg, statics, p, (True, True))}
            return mdef.block(cfg, statics, p, s, (a, b), None, n)

        final, outs = jax.jit(jax.vmap(one))(params, state, jnp.asarray(step),
                                             jnp.asarray(sync))
        out[f"{tag}/outs"] = np.asarray(jnp.stack(outs, axis=1))
        flat(f"{tag}/final", final, out)


GRAD_V, GRAD_N = 2, 256
GRAD_NAMES = ("gradient_patch", "subtractive_voice", "feedback_patch")


def grad_build(name: str):
    """A slice-5 gradient case at 4,800 Hz, mono, built with the JAX
    ``Patch``: the JAX tests' gradient patch, the subtractive voice with a
    fast gate clock (its envelope cycles in 256 samples), feedback_patch."""
    cfg = st.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                         precision="fast")
    if name == "gradient_patch":
        from srack_tpu_torch.presets import gradient_patch
        return gradient_patch(cfg, patch_cls=st.Patch)
    if name == "subtractive_voice":
        return presets.subtractive_voice(cfg, gate_rate_oct=-1.0)
    return getattr(presets, name)(cfg)


def _floats(leaves):
    return [i for i, leaf in enumerate(leaves)
            if jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.floating)]


def _float_tree(treedef, n_leaves, idx, values):
    """The tree of ``values`` at the float leaves ``idx``, the int and bool
    leaves dropped."""
    full = [None] * n_leaves
    for k, i in enumerate(idx):
        full[i] = values[k]

    def prune(t):
        if isinstance(t, dict):
            return {k: prune(v) for k, v in t.items() if v is not None}
        return t
    return prune(jax.tree.unflatten(treedef, full))


def grad_case(name: str, out: dict) -> None:
    """``jax.grad`` through the JAX scan engine of ``sum(audio * w) + sum
    over the float final-state leaves of leaf * wf`` with respect to every
    float param and every float initial-state leaf, V=2, n=256, from the
    JAX ``farm_params`` and random weights."""
    patch = grad_build(name)
    compiled = st.compile_patch(patch)
    rng = np.random.default_rng(61)
    v, n = GRAD_V, GRAD_N
    params = presets.farm_params(patch, v)
    state = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                         compiled.init_state())
    keys = jax.random.split(jax.random.PRNGKey(0), v)
    fn = compiled.make_render_fn(n, batched=True)
    w = rng.standard_normal((v, patch.config.channels, n)).astype(np.float32)
    p_leaves, p_def = jax.tree.flatten(params)
    s_leaves, s_def = jax.tree.flatten(state)
    pf, sf = _floats(p_leaves), _floats(s_leaves)
    wf = [rng.standard_normal(np.shape(s_leaves[i])).astype(np.float32)
          for i in sf]

    def loss(pfl, sfl):
        pl, sl = list(p_leaves), list(s_leaves)
        for k, i in enumerate(pf):
            pl[i] = pfl[k]
        for k, i in enumerate(sf):
            sl[i] = sfl[k]
        audio, _, fin = fn(jax.tree.unflatten(p_def, pl),
                           jax.tree.unflatten(s_def, sl), keys, {})
        fl = jax.tree.leaves(fin)
        total = jnp.sum(audio * w)
        for k, i in enumerate(sf):
            total = total + jnp.sum(fl[i] * wf[k])
        return total

    gp, gs = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        [p_leaves[i] for i in pf], [s_leaves[i] for i in sf])
    tag = f"grad/{name}"
    flat(f"{tag}/params", params, out)
    flat(f"{tag}/state", state, out)
    out[f"{tag}/w"] = w
    flat(f"{tag}/wf", _float_tree(s_def, len(s_leaves), sf, wf), out)
    flat(f"{tag}/gp", _float_tree(p_def, len(p_leaves), pf, list(gp)), out)
    flat(f"{tag}/gs", _float_tree(s_def, len(s_leaves), sf, list(gs)), out)


def vjp_case(out: dict) -> None:
    """The JAX fused VJP (``make_fused_vjp``, both Pallas kernels in
    interpret mode) on the subtractive voice with a fast gate clock, V=2,
    n=32, t_chunk=16: the audio and the gradient of ``mean(audio ** 2)``
    with respect to the params."""
    from srack_tpu.ops.fused_vjp import make_fused_vjp
    patch = grad_build("subtractive_voice")
    compiled = st.compile_patch(patch)
    v, n = 2, 32
    params = presets.farm_params(patch, v)
    state = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                         compiled.init_state())
    keys = jax.random.split(jax.random.PRNGKey(0), v)
    render = make_fused_vjp(compiled, n, t_chunk=16, unroll=4,
                            interpret=True)

    def loss(prm):
        audio, _, _ = render(prm, state, keys, {})
        return (audio ** 2).mean()

    flat("vjp/params", params, out)
    flat("vjp/state", state, out)
    flat("vjp/audio", render(params, state, keys, {})[0], out)
    flat("vjp/grads", jax.grad(loss)(params), out)


def vjp_long_case(out: dict) -> None:
    """The JAX fused VJP's forward (``make_fused_vjp``, interpret mode) over
    n=300 samples in checkpoint chunks of t_chunk=128 (three chunks, the
    last ragged) on the subtractive voice with a fast gate clock, V=2: the
    audio and the final state."""
    from srack_tpu.ops.fused_vjp import make_fused_vjp
    patch = grad_build("subtractive_voice")
    compiled = st.compile_patch(patch)
    v, n = 2, 300
    params = presets.farm_params(patch, v)
    state = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                         compiled.init_state())
    keys = jax.random.split(jax.random.PRNGKey(0), v)
    render = make_fused_vjp(compiled, n, t_chunk=128, unroll=4,
                            interpret=True)
    audio, _, final = render(params, state, keys, {})
    flat("vjp_long/params", params, out)
    flat("vjp_long/state", state, out)
    flat("vjp_long/audio", audio, out)
    flat("vjp_long/final", final, out)


def losses_case(out: dict) -> None:
    """``srack_tpu/utils/losses.py`` in float64 on random signals (in
    float32 both packages' FFT gradients sit ~1e-6 from the float64 one,
    each its own way): the STFT magnitudes, each loss and its gradient,
    and the per-voice mean the trainer takes."""
    from srack_tpu.utils import losses
    rng = np.random.default_rng(71)
    pred = rng.standard_normal((2, 1, 2048)) * 0.3
    target = rng.standard_normal((2, 1, 2048)) * 0.3
    out["losses/pred"], out["losses/target"] = pred, target
    p, t = jnp.asarray(pred), jnp.asarray(target)
    assert p.dtype == jnp.float64
    for frame, hop in ((256, 64), (1024, 256), (300, 100)):
        out[f"losses/stft_{frame}_{hop}"] = np.asarray(
            losses.stft_mag(p[0, 0], frame, hop))
    for name, fn in (("msl", losses.multiscale_spectral_loss),
                     ("l2", losses.waveform_l2)):
        val, g = jax.value_and_grad(lambda x, fn=fn: fn(x, t))(p)
        out[f"losses/{name}/value"] = np.asarray(val)
        out[f"losses/{name}/grad"] = np.asarray(g)
        val, g = jax.value_and_grad(
            lambda x, fn=fn: jax.vmap(fn)(x, t).mean())(p)
        out[f"losses/{name}/vmap_value"] = np.asarray(val)
        out[f"losses/{name}/vmap_grad"] = np.asarray(g)


TRAIN_V, TRAIN_N, TRAIN_STEPS = 2, 256, 3


def train_case(out: dict) -> None:
    """Three ``batched_train_step`` steps (fast=False, ``optax.adam(1e-3)``,
    ``waveform_l2``) on the subtractive voice with a fast gate clock, from
    the patch's default params against random targets: the first step's
    gradients, the losses and the params after the steps."""
    import optax
    from srack_tpu.utils import losses
    from srack_tpu.utils.train import SoundMatcher, batched_train_step
    patch = grad_build("subtractive_voice")
    compiled = st.compile_patch(patch)
    v, n = TRAIN_V, TRAIN_N
    ts = SoundMatcher(patch, n).init()
    rng = np.random.default_rng(81)
    targets = (rng.standard_normal((v, 1, n)) * 0.1).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), v)
    opt = optax.adam(1e-3)
    step = jax.jit(batched_train_step(compiled, opt, n, fast=False))

    def loss_of(train):
        params = SoundMatcher._merge(train, ts["frozen"])

        def one(key):
            audio, _, _ = compiled.make_render_fn(n)(
                params, compiled.init_state(), key, {})
            return audio
        audio = jax.vmap(one)(keys)
        return jax.vmap(losses.waveform_l2)(audio, jnp.asarray(targets)).mean()

    flat("train/train0", ts["train"], out)
    flat("train/frozen", ts["frozen"], out)
    out["train/targets"] = targets
    flat("train/grads0", jax.grad(loss_of)(ts["train"]), out)
    train, opt_state, vals = ts["train"], opt.init(ts["train"]), []
    for _ in range(TRAIN_STEPS):
        train, opt_state, loss = step(train, ts["frozen"], opt_state,
                                      jnp.asarray(targets), keys)
        vals.append(float(loss))
    out["train/losses"] = np.asarray(vals, np.float64)
    flat(f"train/train{TRAIN_STEPS}", train, out)


SPECIAL = {"freeverb": freeverb_case, "osc_block": osc_block_case,
           "scan": scan_case, "ring_roll": ring_roll_case,
           "sample": sample_case, "gather": gather_case,
           "seq_block": seq_block_case, "vjp": vjp_case,
           "vjp_long": vjp_long_case,
           "losses": losses_case, "train": train_case,
           **{f"grad:{name}": (lambda out, name=name: grad_case(name, out))
              for name in GRAD_NAMES}}


EXACT_N = 384
EXACT_CASES = ("subtractive_voice", "feedback_patch", "feedback_buffer",
               "reverb_patch", "drum_machine")


def exact_build(name: str):
    """An exact-precision case at 4,800 Hz, block 64, built with the JAX
    ``Patch`` (``feedback_buffer``: feedback_patch in buffer mode)."""
    base = "feedback_patch" if name == "feedback_buffer" else name
    cfg = st.AudioConfig(sample_rate=4800, block_size=64,
                         channels=2 if base == "reverb_patch" else 1,
                         precision="exact",
                         buffer_feedback=name == "feedback_buffer")
    return getattr(presets, base)(cfg)


def exact_state(compiled, v, rng, params):
    """An exact state for V voices: random f64 Oscillator phases in [0,
    1), random Freeverb lines (f64), write indices and filter states, and
    the sequencers' and Samples' seeding of :func:`_seeded_state`."""
    state = jax.tree.map(np.asarray, _seeded_state(compiled, v, rng, params))
    for mid, (mdef, _, _) in compiled.instances.items():
        sd = state["states"][mid]
        if mdef.type_name == "Oscillator":
            sd["pos"] = rng.uniform(0.0, 1.0, v)
        elif mdef.type_name == "Freeverb":
            for k, a in list(sd.items()):
                if k.endswith("_idx"):
                    length = sd[k[:-4]].shape[-1]
                    sd[k] = rng.integers(0, length, v).astype(np.int32)
                else:
                    sd[k] = rng.standard_normal(a.shape) * 0.05
    return state


def exact_case(name: str, out: dict) -> None:
    """The JAX scan engine and block engine in exact precision."""
    tag = f"{name}@exact"
    patch = exact_build(name)
    compiled = st.compile_patch(patch)
    rng = np.random.default_rng(47)
    params = presets.farm_params(patch, VOICES)
    state = exact_state(compiled, VOICES, rng, params)
    drivers = noise_drivers(patch, EXACT_N, rng)
    keys = jax.random.split(jax.random.PRNGKey(0), VOICES)
    flat(f"{tag}/params", params, out)
    flat(f"{tag}/state", state, out)
    flat(f"{tag}/drivers", drivers, out)
    jstate = jax.tree.map(jnp.asarray, state)
    jdrv = {k: jnp.asarray(a) for k, a in drivers.items()}
    for engine in ("scan", "block"):
        audio, _, final = compiled._get_fn(EXACT_N, True, engine)(
            params, jstate, keys, jdrv)
        flat(f"{tag}/{engine}/audio", audio, out)
        flat(f"{tag}/{engine}/final", final, out)


def osc_exact_case(out: dict) -> None:
    """The exact ``_osc_block`` over [V, n] rows for each input
    combination."""
    from srack_tpu.modules import oscillator as josc
    cfg = st.AudioConfig(sample_rate=4800, precision="exact")
    rng = np.random.default_rng(23)
    v, n = 3, 300
    statics = ("antialias", True)
    for case in ("free", "cv", "sync", "cv_sync", "auto_val"):
        state = {"pos": rng.uniform(0.0, 1.0, v),
                 "sync_last": rng.uniform(size=v) < 0.5}
        params = {"val": rng.uniform(-3, 1, v).astype(np.float32)}
        cv = (rng.uniform(-1, 1, (v, n)).astype(np.float32)
              if "cv" in case else None)
        sync = None
        if "sync" in case:
            sync = np.where(rng.uniform(size=(v, n)) < 0.05, 1.0,
                            -0.5).astype(np.float32)
        if case == "auto_val":
            params["val"] = rng.uniform(-3, 1, (v, n)).astype(np.float32)
        flat(f"osc_exact/{case}/state", state, out)
        flat(f"osc_exact/{case}/params", params, out)
        if cv is not None:
            out[f"osc_exact/{case}/cv"] = cv
        if sync is not None:
            out[f"osc_exact/{case}/sync"] = sync

        def one(p, s, c, y, case=case):
            if case == "free":
                p = {**p, **josc._osc_derive(cfg, statics, p, (False, False))}
            return josc._osc_block(cfg, statics, p, s, (c, y), None, n)

        final, waves = jax.jit(jax.vmap(one, in_axes=(
            0, 0, None if cv is None else 0, None if sync is None else 0)))(
            params, state, None if cv is None else jnp.asarray(cv),
            None if sync is None else jnp.asarray(sync))
        flat(f"osc_exact/{case}/waves", jnp.stack(waves, axis=1), out)
        flat(f"osc_exact/{case}/final", final, out)


def freeverb_exact_case(out: dict) -> None:
    """The Freeverb's exact step and block form (the f64 core)."""
    from srack_tpu.modules import freeverb as jfv
    cfg = st.AudioConfig(sample_rate=4800, channels=2, precision="exact")
    statics, p0 = jfv.FREEVERB.make(cfg, room_size=0.7, dampening=0.4,
                                    wet=0.3, dry=0.2)
    rng = np.random.default_rng(29)
    v = 3
    state = {}
    for k, a in jfv._init_state(cfg, statics).items():
        if k.endswith("_idx"):
            continue
        state[k] = rng.standard_normal((v,) + a.shape) * 0.1
        if a.ndim:
            state[f"{k}_idx"] = rng.integers(0, a.shape[0], v).astype(
                np.int32)
    params = {k: np.broadcast_to(np.asarray(a), (v,)).copy()
              for k, a in p0.items()}
    params["room_size"] = rng.uniform(0.3, 0.9, v).astype(np.float32)
    params["dampening"] = rng.uniform(0.0, 1.0, v).astype(np.float32)
    flat("freeverb_exact/state", state, out)
    flat("freeverb_exact/params", params, out)
    n = 256
    lanes = (rng.standard_normal((2, v, n)) * 0.3).astype(np.float32)
    out["freeverb_exact/step/lanes"] = lanes

    def run_steps(p, s, lr):
        def body(carry, x):
            carry, outs = jfv.FREEVERB.step(cfg, statics, p, carry,
                                            [x[0], x[1]])
            return carry, jnp.stack(outs)
        final, ys = jax.lax.scan(body, s, lr.T)
        return ys.T, final

    audio, final = jax.jit(jax.vmap(run_steps, in_axes=(0, 0, 1)))(
        params, state, jnp.asarray(lanes))
    flat("freeverb_exact/step/audio", audio, out)
    flat("freeverb_exact/step/final", final, out)
    for n in (512, 300):
        lanes = (rng.standard_normal((2, v, n)) * 0.3).astype(np.float32)
        autos = {"room_size": rng.uniform(0.3, 0.9, (v, n)).astype(
                     np.float32),
                 "wet": rng.uniform(0.1, 0.5, (v, n)).astype(np.float32)}
        out[f"freeverb_exact/block{n}/lanes"] = lanes
        flat(f"freeverb_exact/block{n}/autos", autos, out)

        def run_block(p, a, s, lr, n=n):
            return jfv._block(cfg, statics, {**p, **a}, s, [lr[0], lr[1]],
                              None, n)

        final, audio = jax.jit(jax.vmap(run_block, in_axes=(0, 0, 0, 1)))(
            params, autos, state, jnp.asarray(lanes))
        flat(f"freeverb_exact/block{n}/audio", jnp.stack(audio, axis=1),
             out)
        flat(f"freeverb_exact/block{n}/final", final, out)


def drift_case(out: dict) -> None:
    """The reference's own fast-against-exact difference over 1 s."""
    for precision in ("fast", "exact"):
        cfg = st.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                             precision=precision)
        patch = presets.subtractive_voice(cfg)
        compiled = st.compile_patch(patch)
        params = presets.farm_params(patch, 2)
        state = jax.tree.map(lambda a: jnp.broadcast_to(a, (2,) + a.shape),
                             compiled.init_state())
        keys = jax.random.split(jax.random.PRNGKey(0), 2)
        audio, _, _ = compiled._get_fn(4800, True, "scan")(params, state,
                                                           keys, {})
        out[f"drift/{precision}"] = np.asarray(audio)


DRIFT48_WINDOW = (12288, 13312)  # where the first voice drifts past 1e-3


def drift48_case(out: dict) -> None:
    """The reference's own fast-against-exact difference over 1 s at 48
    kHz, rendered on from the state at each cut of ``DRIFT48_WINDOW``."""
    v, sr = 4, 48000
    for precision in ("fast", "exact"):
        cfg = st.AudioConfig(sample_rate=sr, channels=1, precision=precision)
        patch = presets.subtractive_voice(cfg)
        compiled = st.compile_patch(patch)
        params = presets.farm_params(patch, v)
        state = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                             compiled.init_state())
        keys = jax.random.split(jax.random.PRNGKey(0), v)
        pieces, t = [], 0
        for cut in DRIFT48_WINDOW + (sr,):
            if t == DRIFT48_WINDOW[0]:
                flat(f"drift48/{precision}/state", state, out)
            audio, _, state = compiled._get_fn(cut - t, True, "scan")(
                params, state, keys, {})
            pieces.append(np.asarray(audio))
            t = cut
        out[f"drift48/{precision}/audio"] = np.concatenate(pieces, axis=-1)


SPECIAL.update({"osc_exact": osc_exact_case, "drift": drift_case,
                "drift48": drift48_case,
                "freeverb_exact": freeverb_exact_case,
                **{f"{name}@exact": (lambda out, name=name:
                                     exact_case(name, out))
                   for name in EXACT_CASES}})


FARM_VOICES, FARM_N = 16, 256
SRK_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "reference_all_modules.srk")
SRK_N = 256


def farm_case(out: dict) -> None:
    """The JAX farm on its 8-device mesh, per voice and mixed down."""
    from srack_tpu.parallel import make_mesh, render_farm
    cfg = st.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                         precision="exact")
    patch = presets.subtractive_voice(cfg)
    params = presets.farm_params(patch, FARM_VOICES)
    mesh = make_mesh()
    audio, _, _ = render_farm(patch, FARM_N, params=params, mesh=mesh)
    mixed, _, _ = render_farm(patch, FARM_N, params=params, mesh=mesh,
                              mixdown=True)
    out["farm/audio"] = np.asarray(audio)
    out["farm/mixed"] = np.asarray(mixed)
    out["farm/slots"] = np.asarray(mesh.devices.shape)


def srk_fixture_case(out: dict) -> None:
    """The .srk fixture through the JAX scan engine, Noise fed a lane."""
    from srack_tpu.io import read_srk
    cfg = st.AudioConfig(sample_rate=48000, block_size=16, channels=2)
    patch = read_srk(SRK_FIXTURE, cfg)
    rng = np.random.default_rng(77)
    drivers = {inst.id: rng.uniform(-1.0, 1.0, SRK_N).astype(np.float32)
               for inst in patch if inst.mdef.type_name == "Noise"}
    audio, _, _ = st.render(patch, SRK_N, engine="scan", drivers=drivers)
    out["srk_fixture/audio"] = np.asarray(audio)
    flat("srk_fixture/drivers", drivers, out)


def cli_sine_case(out: dict) -> None:
    """The WAV bytes of the JAX CLI's render of the sine preset."""
    import tempfile
    from srack_tpu.__main__ import main as cli
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sine.wav")
        cli(["render", "sine", "--samples", "4096", "-o", path])
        with open(path, "rb") as f:
            out["cli_sine/wav"] = np.frombuffer(f.read(), np.uint8)


SPECIAL.update({"farm": farm_case, "srk_fixture": srk_fixture_case,
                "cli_sine": cli_sine_case})


def main(path: str, names) -> None:
    out = {}
    for name in names:
        if name in SPECIAL:
            SPECIAL[name](out)
            continue
        if name.endswith("@buffer"):
            kit_case(name[:-len("@buffer")], out, True)
            continue
        if name.endswith("@block"):
            base = name[:-len("@block")]
            if base in KIT_CASES:
                kit_case(base, out, False)
            else:
                block_case(base, out)
            continue
        patch, autos = build(name)
        compiled = st.compile_patch(patch, automation=autos)
        params = presets.farm_params(patch, VOICES)
        state = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (VOICES,) + a.shape),
            compiled.init_state())
        keys = jax.random.split(jax.random.PRNGKey(0), VOICES)
        flat(f"{name}/params", params, out)
        flat(f"{name}/state", state, out)
        out[f"{name}/plan"] = np.asarray(compiled.plan)
        buffer = name == "feedback_buffer"
        scan_n = BUFFER_SCAN_N if buffer else SCAN_N
        drivers = lane_drivers(patch, scan_n) if autos else {}
        flat(f"{name}/drivers", drivers, out)
        scanned = compiled
        if autos:
            ids = {inst.name: inst.id for inst in patch}
            probes = [(ids[m], p) for m, p in LANE_PROBES]
            scanned = st.compile_patch(patch, probes=probes,
                                       automation=autos)
        audio, probe_vals, final = scanned._get_fn(scan_n, True, "scan")(
            params, state, keys, {k: jnp.asarray(a)
                                  for k, a in drivers.items()})
        flat(f"{name}/scan{scan_n}/audio", audio, out)
        flat(f"{name}/scan{scan_n}/probes", probe_vals, out)
        flat(f"{name}/scan{scan_n}/final", final, out)
        if buffer:
            runs = [("k2", BUFFER_KERNEL_N, fused.make_fused_render_buffer)]
        else:
            runs = [("k1", n, fused.make_fused_render) for n in KERNEL_NS]
        for tag, n, make in runs:
            run = make(compiled, n, t_chunk=16, unroll=4, interpret=True)
            drv = {k: jnp.asarray(a[:, :n]) for k, a in drivers.items()}
            audio, _, final = jax.jit(run)(params, state, keys, drv)
            flat(f"{name}/{tag}_{n}/audio", audio, out)
            flat(f"{name}/{tag}_{n}/final", final, out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
