"""The fused kernel's generated source, checked on the CPU.

``csrc/modules.cuh`` is ``__host__ __device__``, and the generated ``.cu``
has a host entry (``srk_fused_host``, a loop over voices) beside the CUDA
launch.  Built with ``g++ -O2 -ffp-contract=off`` it runs the very
per-voice loop the card runs, so its arithmetic and the generator's code
(layout, wiring, feedback carries, unconnected inputs, sequencer tables,
lanes and automation overlays, K2's feedback ring, the final state) are
checked here against the kernels' plain version, the scan engine, with
the tolerances the card run uses: audio within 1e-5, int32 and bool state
bit-exact, float state within 1e-5.  The cases: K1 for the slice-1
patches, ``sequencer_patch`` and ``lane_check_patch`` (a driven Input,
Noise drawn by the port's generator and an automation lane), and K2 for
``feedback_patch`` in buffer-feedback mode.  The main path never uses
this host build.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import srack_tpu_torch as stt
from srack_tpu_torch.compiler import tree_map
from srack_tpu_torch.modules.base import ModuleDef
from srack_tpu_torch.ops import fused

HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
              "-shared", "-fPIC")
ATOL = 1e-5
PATCHES = ("subtractive_voice", "sine_patch", "feedback_patch",
           "kernel_check_patch", "sequencer_patch", "lane_check_patch",
           "feedback_buffer")


@pytest.fixture(scope="module")
def gxx():
    path = shutil.which("g++")
    if path is None:
        pytest.skip("g++ unavailable")
    return path


def _patch(name, n=256):
    """``(patch, automation)`` for a case; ``feedback_buffer`` is
    feedback_patch in buffer-feedback mode with a block that divides n."""
    if name == "kernel_check_patch":
        return stt.presets.kernel_check_patch(
            stt.AudioConfig(sample_rate=4800, channels=3)), ()
    if name == "lane_check_patch":
        return stt.presets.lane_check_patch(
            stt.AudioConfig(sample_rate=4800, channels=2))
    if name == "feedback_buffer":
        block = 32 if n % 32 == 0 else 17
        return stt.presets.feedback_patch(stt.AudioConfig(
            sample_rate=4800, block_size=block, channels=1,
            buffer_feedback=True)), ()
    return getattr(stt.presets, name)(
        stt.AudioConfig(sample_rate=4800, channels=1)), ()


def _lanes(compiled, patch, params, v, n, seed):
    """The lane check patch's lanes: a random step gate on the driven
    Input, a pitch lane on the VCO's automated ``val``, and the Noise
    module's own draws from the port's generator."""
    if not compiled.xs_modules:
        return {}
    rng = np.random.default_rng(seed)
    gate = next(i.id for i in patch if i.name == "gate")
    vco = next(i.id for i in patch if i.name == "vco")
    drivers = {
        gate: torch.from_numpy(
            (rng.uniform(size=(v, n)) < 0.3).astype(np.float32)),
        compiled._auto_key(vco, "val"): torch.from_numpy(
            rng.uniform(-1.5, 0.5, (v, n)).astype(np.float32)),
    }
    return compiled._make_xs(params, seed, n, drivers)


def host_render(kernel, lib_path, params, state, n, xs=None):
    """The wrapper's packing around the host entry instead of the launch."""
    pf, pi, sf, si, lanes, ring, v = kernel.pack(params, state, n, xs or {})
    audio = torch.empty((v, kernel.compiled.cfg.channels, n),
                        dtype=torch.float32)
    sf_out, si_out = torch.empty_like(sf), torch.empty_like(si)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.srk_fused_host
    fn.argtypes, fn.restype = fused.ARGTYPES, ctypes.c_int
    err = fn(pf.data_ptr(), pi.data_ptr(), sf.data_ptr(), si.data_ptr(),
             lanes.data_ptr(), ring.data_ptr(), audio.data_ptr(),
             sf_out.data_ptr(), si_out.data_ptr(), v, n)
    assert err == 0
    return audio, kernel.finish(sf_out, si_out, ring, v)


def assert_state_close(got, want):
    for mid, sd in want["states"].items():
        for key, w in sd.items():
            g = got["states"][mid][key]
            assert g.dtype == w.dtype and g.shape == w.shape, (mid, key)
            if w.dtype in (torch.int32, torch.bool):
                assert torch.equal(g, w), (mid, key)
            else:
                torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    assert set(got["fb"]) == set(want["fb"])
    for k, w in want["fb"].items():
        torch.testing.assert_close(got["fb"][k], w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [256, 255])
@pytest.mark.parametrize("name", PATCHES)
def test_generated_kernel_on_host_matches_plain_version(gxx, tmp_path, name,
                                                        n):
    patch, autos = _patch(name, n)
    compiled = stt.compile_patch(patch, automation=autos)
    v = 6
    params = stt.presets.farm_params(patch, v, seed=n)
    state = tree_map(lambda a: a.expand((v,) + a.shape).contiguous(),
                     compiled.init_state())
    xs = _lanes(compiled, patch, params, v, n, seed=n)
    kernel = compiled.fused(xs)
    lib_path, _ = fused.build(kernel.source, compiler=gxx, flags=HOST_FLAGS,
                              root=tmp_path)
    audio, final = host_render(kernel, lib_path, params, state, n, xs)
    want_audio, want_final = compiled.render_scan(
        params, state, n, batched=True, nograd=True, xs=xs)
    torch.testing.assert_close(audio, want_audio, atol=ATOL, rtol=0)
    assert_state_close(final, want_final)
    # a render continues from its final state: two halves equal the whole
    # (in buffer mode, cut at a block boundary)
    block = compiled.cfg.block_size if compiled.cfg.buffer_feedback else 1
    half = n // block // 2 * block
    cut = {k: (x[..., :half].contiguous(), x[..., half:].contiguous())
           for k, x in xs.items()}
    a1, s1 = host_render(kernel, lib_path, params, state, half,
                         {k: c[0] for k, c in cut.items()})
    a2, _ = host_render(kernel, lib_path, params, s1, n - half,
                        {k: c[1] for k, c in cut.items()})
    torch.testing.assert_close(torch.cat([a1, a2], dim=-1), audio, atol=0,
                               rtol=0)
    assert kernel.launches == 0  # the host entry is not a kernel launch


def test_build_reuses_a_library_by_source_hash(gxx, tmp_path):
    kernel = stt.compile_patch(_patch("sine_patch")[0]).fused()
    first, _ = fused.build(kernel.source, compiler=gxx, flags=HOST_FLAGS,
                           root=tmp_path)
    mtime = first.stat().st_mtime_ns
    again, _ = fused.build(kernel.source, compiler=gxx, flags=HOST_FLAGS,
                           root=tmp_path)
    assert again == first and again.stat().st_mtime_ns == mtime
    other, _ = fused.build(
        stt.compile_patch(_patch("feedback_patch")[0]).fused().source,
        compiler=gxx, flags=HOST_FLAGS, root=tmp_path)
    assert other.parent != first.parent


def test_build_error_raises(gxx, tmp_path):
    with pytest.raises(RuntimeError, match="building the fused kernel"):
        fused.build("this is not C++\n", compiler=gxx, flags=HOST_FLAGS,
                    root=tmp_path)


def test_module_without_device_function_is_not_kernel_eligible():
    base = stt.CATALOG["VCA"]
    custom = ModuleDef(
        type_name="Scan Only VCA", make=base.make,
        num_inputs=base.num_inputs, num_outputs=base.num_outputs,
        input_labels=base.input_labels, output_labels=base.output_labels,
        init_state=base.init_state, step=base.step)
    stt.register_module(custom)
    try:
        p = stt.Patch(stt.AudioConfig(sample_rate=4800, channels=1))
        osc = p.add("Oscillator")
        vca = p.add("Scan Only VCA")
        p.connect(osc, "Sine", vca, "Audio")
        p.connect(osc, "Sine", vca, "CV")
        p.connect(vca, 0, p.output, 0)
        compiled = stt.compile_patch(p)
        assert not compiled.fused_eligible()
        # a stateless module without a device function runs in a block
        # phase of the block engine, as torch ops over whole rows
        assert compiled.auto_engine(True, "cuda") == "block"
        assert compiled.auto_engine(True, "cpu") == "scan"
        with pytest.raises(ValueError, match="not eligible"):
            compiled.fused()
        params = stt.replicate_params(p.params(), 2)
        audio, _, _ = compiled.render(8, params=params, batched=True,
                                      device="cpu")
        assert tuple(audio.shape) == (2, 1, 8)
        assert np.isfinite(audio.numpy()).all()
    finally:
        stt.unregister_module("Scan Only VCA")
