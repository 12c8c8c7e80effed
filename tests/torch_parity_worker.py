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


def main(path: str, names) -> None:
    out = {}
    for name in names:
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
