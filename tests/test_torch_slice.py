"""The torch port's slice 1 against the JAX package, end to end on the CPU.

For subtractive_voice, sine_patch, feedback_patch and kernel_check_patch
(every device function of the fused kernel), with the JAX ``farm_params``
of 4 voices at 4,800 Hz carried across through ``interop``:

* the port's scan engine equals the JAX scan engine at n=256;
* the port's scan engine (the fused kernel's plain version, ``nograd``)
  equals the JAX fused Pallas kernel in interpret mode at n=32 and at n=23,
  the padded-tail case;
* audio within ``atol=1e-5`` (the JAX package's fused-vs-scan tolerance),
  int32 and bool state bit-exact, float state within 1e-5, leaf by leaf.

The JAX renders come from ``tests/torch_parity_worker.py`` in a process of
their own: XLA's CPU backend contracts ``a*b+c`` into FMA on hosts that have
it, and ``--xla_cpu_max_isa=AVX``, which stops that, is read once per
process.  With it the two packages agree bit for bit.

Also here: ``farm_params`` equality, the no-jax import, and the engine
choice (no fallback).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import srack_tpu as st
from srack_tpu import presets as jpresets

import srack_tpu_torch as stt
from srack_tpu_torch import interop
from srack_tpu_torch.ops import fused

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_parity_worker.py"
NAMES = ("subtractive_voice", "sine_patch", "feedback_patch",
         "kernel_check_patch")
ATOL = 1e-5


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    proc = subprocess.run([sys.executable, str(WORKER), str(out), *NAMES],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _tree(ref: dict, prefix: str) -> dict:
    """Rebuild a nested dict from the worker's flat ``a/b/c`` keys; fb keys
    ``src:port`` become ``(src, port)`` tuples."""
    tree = {}
    for key, arr in ref.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        leaf = parts[-1]
        if parts[0] == "fb" and len(parts) == 2:
            src, port = leaf.split(":")
            leaf = (src, int(port))
        node[leaf] = arr
    return tree


def _complete(tree: dict, mids, state: bool) -> dict:
    """npz keeps no empty dicts: restore the modules without params or
    state, and the empty feedback dict."""
    if state:
        tree.setdefault("fb", {})
        tree["states"] = {m: tree.get("states", {}).get(m, {}) for m in mids}
        return tree
    return {m: tree.get(m, {}) for m in mids}


def _port(name: str):
    if name == "kernel_check_patch":
        cfg = stt.AudioConfig(sample_rate=4800, block_size=64, channels=3,
                              precision="fast")
        return stt.presets.kernel_check_patch(cfg)
    cfg = stt.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                          precision="fast")
    return getattr(stt.presets, name)(cfg)


def assert_state_close(got: dict, want: dict, where: str) -> None:
    """int32 and bool leaves bit-exact, float leaves within ATOL."""
    got = interop.to_numpy(got)
    assert set(got["states"]) == set(want["states"]), where
    assert set(got["fb"]) == set(want["fb"]), where
    pairs = [(f"states.{m}.{k}", got["states"][m][k], w)
             for m, sd in want["states"].items() for k, w in sd.items()]
    pairs += [(f"fb.{k}", got["fb"][k], w)
              for k, w in want["fb"].items()]
    for name, g, w in pairs:
        assert g.dtype == w.dtype and g.shape == w.shape, (where, name)
        if w.dtype in (np.int32, np.bool_):
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {name}")
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0,
                                       err_msg=f"{where} {name}")


@pytest.mark.parametrize("ref_run", ["scan256", "k1_32", "k1_23"])
@pytest.mark.parametrize("name", NAMES)
def test_port_scan_matches_jax(jax_ref, name, ref_run):
    patch = _port(name)
    compiled = stt.compile_patch(patch)
    assert list(compiled.plan) == list(jax_ref[f"{name}/plan"])
    mids = compiled.instances
    params = interop.params_from_numpy(
        _complete(_tree(jax_ref, f"{name}/params"), mids, state=False))
    state = interop.state_from_numpy(
        _complete(_tree(jax_ref, f"{name}/state"), mids, state=True))
    n = int(ref_run[4:]) if ref_run.startswith("scan") else \
        int(ref_run.split("_")[1])
    # the Pallas kernel runs the nograd step; the JAX scan engine the full
    # step (with the straight-through shadow) -- bit-identical either way
    audio, final = compiled.render_scan(params, state, n, batched=True,
                                        nograd=ref_run.startswith("k1"))
    want_audio = jax_ref[f"{name}/{ref_run}/audio"]
    assert tuple(audio.shape) == want_audio.shape
    np.testing.assert_allclose(audio.numpy(), want_audio, atol=ATOL, rtol=0)
    want_final = _complete(_tree(jax_ref, f"{name}/{ref_run}/final"), mids,
                           state=True)
    assert_state_close(final, want_final, f"{name} {ref_run}")


@pytest.mark.parametrize("name", ["subtractive_voice", "sine_patch",
                                  "feedback_patch", "sampler_kit"])
def test_farm_params_equal_jax(name):
    jcfg = st.AudioConfig(sample_rate=48000, channels=1)
    tcfg = stt.AudioConfig(sample_rate=48000, channels=1)
    want = getattr(jpresets, name)(jcfg)
    got = stt.presets.farm_params(getattr(stt.presets, name)(tcfg), 8)
    want = jpresets.farm_params(want, 8)
    assert set(got) == set(want)
    for mid in want:
        assert set(got[mid]) == set(want[mid])
        for key, leaf in want[mid].items():
            w = np.asarray(leaf)
            g = got[mid][key].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w, err_msg=f"{mid}.{key}")


def test_import_and_render_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import srack_tpu_torch as stt\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or "
        "m.startswith('srack_tpu.') or m == 'srack_tpu' "
        "for m in sys.modules if sys.modules[m] is not None)\n"
        "cfg = stt.AudioConfig(sample_rate=4800, channels=1)\n"
        "p = stt.presets.subtractive_voice(cfg)\n"
        "audio, _, state = stt.render(p, 64, device='cpu')\n"
        "assert tuple(audio.shape) == (1, 64)\n"
        "p = stt.presets.sequencer_patch(cfg)\n"
        "audio, _, _ = stt.render_batch(p, 64, device='cpu',\n"
        "    params=stt.presets.farm_params(p, 2))\n"
        "assert tuple(audio.shape) == (2, 1, 64)\n"
        "cfg = stt.AudioConfig(sample_rate=4800, block_size=16, channels=1,\n"
        "                      buffer_feedback=True)\n"
        "p = stt.presets.feedback_patch(cfg)\n"
        "audio, _, state = stt.render(p, 64, device='cpu')\n"
        "assert tuple(audio.shape) == (1, 64)\n"
        "assert all(tuple(f.shape) == (16,) for f in state['fb'].values())\n"
        "cfg = stt.AudioConfig(sample_rate=4800, channels=2)\n"
        "p = stt.presets.reverb_patch(cfg)\n"
        "audio, _, _ = stt.render_batch(\n"
        "    p, 300, device='cpu', engine='block',\n"
        "    params=stt.presets.farm_params(p, 2))\n"
        "assert tuple(audio.shape) == (2, 2, 300)\n"
        "cfg = stt.AudioConfig(sample_rate=4800, channels=1)\n"
        "p = stt.presets.sampler_kit(cfg)\n"
        "audio, _, state = stt.render_batch(\n"
        "    p, 300, device='cpu', engine='block',\n"
        "    params=stt.presets.farm_params(p, 2))\n"
        "assert tuple(audio.shape) == (2, 1, 300)\n"
        "assert bool(audio.isfinite().all())\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_engine_choice_has_no_fallback():
    patch = _port("subtractive_voice")
    compiled = stt.compile_patch(patch)
    assert compiled.fused_eligible()
    assert compiled.auto_engine(True, "cpu") == "scan"
    # one unbatched voice on the card runs as a batch of one
    assert compiled.auto_engine(False, "cuda") == "fused"
    assert compiled.auto_engine(False, "cpu") == "scan"
    assert compiled.auto_engine(True, "cuda") == "fused"
    params = stt.presets.farm_params(patch, 2)
    audio, _, _ = compiled.render(16, params=params, batched=True,
                                  device="cpu")
    assert tuple(audio.shape) == (2, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        compiled.render(16, params=params, batched=True, engine="fused",
                        device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        compiled.fused().render(params, compiled.init_state(), 16)
    assert compiled.fused().launches == 0


def test_generated_source_is_deterministic_and_in_plan_order():
    a = fused.generate_source(stt.compile_patch(_port("subtractive_voice")))
    b = fused.generate_source(stt.CompiledPatch(_port("subtractive_voice")))
    assert a == b
    compiled = stt.compile_patch(_port("kernel_check_patch"))
    src = fused.generate_source(compiled)
    loop = src[src.index("for (int t = 0; t < n; ++t)"):]
    # each module's call, found by its output wires (the call's last
    # argument) or, for Output, by the audio write
    calls = [loop.index("srk_output(a0, t," if mid == compiled.output_id
                        else f", w_{mid});")
             for mid in compiled.plan]
    assert calls == sorted(calls)
    # the feedback carry is read before it is rewritten at the loop's end
    (src_mid, port), = compiled.fb_keys
    assert loop.rindex(f"fb_{src_mid}_{port} = w_{src_mid}[{port}];") > \
        loop.index(f"fb_{src_mid}_{port}")


def test_unported_module_type_names_the_roadmap():
    """Every module type is ported since slice 3b (the Sample player) and
    the block engine takes buffer mode: an unknown type raises KeyError
    naming the catalog, and buffer mode renders.  Exact precision, which
    once raised naming slice 4, is ported since slice 10: every preset
    builds in it, with the f64 phase."""
    p = stt.Patch(stt.AudioConfig(channels=1))
    assert not stt.modules.NOT_PORTED
    assert set(st.modules.CATALOG) == set(stt.CATALOG)
    for type_name in ("Sampler", "Wavetable"):
        with pytest.raises(KeyError, match="catalog"):
            p.add(type_name)
    fb = stt.presets.feedback_patch(stt.AudioConfig(
        sample_rate=4800, block_size=16, channels=1, buffer_feedback=True))
    audio_b, _, state_b = stt.render(fb, 32, engine="block", device="cpu")
    audio_s, _, state_s = stt.render(fb, 32, engine="scan", device="cpu")
    assert torch.equal(audio_b, audio_s)
    assert all(torch.equal(state_b["fb"][k], f)
               for k, f in state_s["fb"].items())
    exact = stt.AudioConfig(channels=1, precision="exact")
    osc = stt.Patch(exact).add("Oscillator")
    assert osc.id
    for build in (stt.presets.sine_patch, stt.presets.subtractive_voice,
                  stt.presets.feedback_patch):
        state = stt.compile_patch(build(exact)).init_state()
        assert {s["pos"].dtype for s in state["states"].values()
                if "pos" in s} == {torch.float64}
