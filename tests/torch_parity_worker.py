"""Reference renders of the JAX package for the torch port's parity tests.

    python tests/torch_parity_worker.py OUT.npz

Renders each slice-1 patch with ``srack_tpu`` on the CPU -- the scan engine
at n=256 and the fused Pallas kernel in interpret mode at n=32 and n=23 --
from the JAX ``farm_params`` of 4 voices, and saves params, initial state,
audio and final state to ``OUT.npz`` (keys ``<patch>/<what>/<path>``).

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


def build(name: str):
    if name == "kernel_check_patch":
        from srack_tpu_torch.presets import kernel_check_patch
        cfg = st.AudioConfig(sample_rate=4800, block_size=64, channels=3,
                             precision="fast")
        return kernel_check_patch(cfg, patch_cls=st.Patch)
    cfg = st.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                         precision="fast")
    return getattr(presets, name)(cfg)


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
        patch = build(name)
        compiled = st.compile_patch(patch)
        params = presets.farm_params(patch, VOICES)
        state = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (VOICES,) + a.shape),
            compiled.init_state())
        keys = jax.random.split(jax.random.PRNGKey(0), VOICES)
        flat(f"{name}/params", params, out)
        flat(f"{name}/state", state, out)
        out[f"{name}/plan"] = np.asarray(compiled.plan)
        audio, _, final = compiled._get_fn(SCAN_N, True, "scan")(
            params, state, keys, {})
        flat(f"{name}/scan{SCAN_N}/audio", audio, out)
        flat(f"{name}/scan{SCAN_N}/final", final, out)
        for n in KERNEL_NS:
            run = fused.make_fused_render(compiled, n, t_chunk=16, unroll=4,
                                          interpret=True)
            audio, _, final = jax.jit(run)(params, state, keys, {})
            flat(f"{name}/k1_{n}/audio", audio, out)
            flat(f"{name}/k1_{n}/final", final, out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
