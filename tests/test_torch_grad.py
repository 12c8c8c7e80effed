"""Gradients of the torch port (slice 5) on the CPU.

* The port's scan engine under autograd against ``jax.grad`` through the
  JAX scan engine, for ``gradient_patch`` (the JAX tests' gradient patch),
  the subtractive voice with a fast gate clock and ``feedback_patch``, at
  V=2, n=256, 4,800 Hz: the gradient of a weighted sum of the audio and of
  the final float state with respect to every float param and every float
  initial-state leaf.  Per leaf the bound is ``atol = 1e-8 + 1e-4 *
  max|ref|``, the rule of the JAX package's
  ``test_fused_vjp_interpret_matches_scan_grads``.
* The port against central finite differences, with the JAX tests' pins
  and bounds (``tests/test_gradients.py``), through the scan engine and
  through kernel K10's host build.
* Kernel K10's generated forward and backward sources, built with g++ on
  the host (as ``test_torch_fused_host.py`` builds K1): the audio equals
  the scan engine bit for bit, and the param and initial-state cotangents
  meet the rule above against the port's scan autograd, on five patches
  (``kernel_check_patch`` with its Non-Linear's exponent at 2.0: at 1.5
  the powf of a negative base makes JAX's gradient, and the port's, NaN
  everywhere upstream), a render of n=23 in chunks of 16 with a loss on
  the final state only, and against the JAX fused VJP in interpret mode.

The JAX references come from ``tests/torch_parity_worker.py`` (cases
``grad:<name>`` and ``vjp``) in a process of its own.
"""

import ctypes
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import srack_tpu_torch as stt
from srack_tpu_torch import interop
from srack_tpu_torch.compiler import tree_items, tree_leaves, tree_map
from srack_tpu_torch.modules.base import ModuleDef
from srack_tpu_torch.ops import fused
from srack_tpu_torch.ops.fused import _get
from srack_tpu_torch.ops.fused_vjp import FusedVJPKernel, make_fused_vjp

from test_torch_slice import ROOT, WORKER, _complete, _env, _tree

HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
              "-shared", "-fPIC")
GRAD_NAMES = ("gradient_patch", "subtractive_voice", "feedback_patch")
HOST_PATCHES = ("subtractive_voice", "gradient_patch", "feedback_patch",
                "lane_check_patch", "kernel_check_patch")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    cases = [f"grad:{name}" for name in GRAD_NAMES] + ["vjp"]
    proc = subprocess.run([sys.executable, str(WORKER), str(out), *cases],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def gxx():
    path = shutil.which("g++")
    if path is None:
        pytest.skip("g++ unavailable")
    return path


def assert_rule_b(got, want, where: str) -> None:
    """``got`` within ``1e-8 + 1e-4 * max|want|`` of ``want``; NaN where
    ``want`` is NaN."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    nan = np.isnan(want)
    assert np.array_equal(nan, np.isnan(got)), f"{where}: NaN pattern"
    if nan.all():
        return
    np.testing.assert_allclose(
        got[~nan], want[~nan], atol=1e-8 + 1e-4 * np.abs(want[~nan]).max(),
        err_msg=where)


def float_grads(render, params, state, w, wf=None):
    """Run ``render(params, state) -> (audio, final)`` under autograd and
    return ``(audio, {path: d loss / d leaf})`` for every float param
    (``(mid, key)``) and float state leaf (``("states", mid, key)``,
    ``("fb", k)``), with ``loss = sum(audio * w) + sum over wf's paths of
    sum(final leaf * weight)``."""
    p = tree_map(lambda a: a.detach().clone().requires_grad_(
        a.is_floating_point()), params)
    s = tree_map(lambda a: a.detach().clone().requires_grad_(
        a.is_floating_point()), state)
    audio, final = render(p, s)
    loss = (audio * w).sum() if w is not None else 0.0
    for path, weight in (wf or {}).items():
        loss = loss + (_get(final, path) * weight).sum()
    leaves = [(path, t) for path, t in tree_items(p) + tree_items(s)
              if t.requires_grad]
    grads = torch.autograd.grad(loss, [t for _, t in leaves],
                                allow_unused=True)
    return audio.detach(), {
        path: (torch.zeros_like(t) if g is None else g)
        for (path, t), g in zip(leaves, grads)}


def host_k10(compiled, lanes, t_chunk, gxx, root):
    """A fresh K10 wrapper whose launches go to the host entries of its
    g++ build (the same generated sources, a loop over voices)."""
    kernel = FusedVJPKernel(compiled, lanes, t_chunk)
    libs = {}
    for lib in (kernel.fwd, kernel.bwd):
        path, _ = fused.build(lib.source, compiler=gxx, flags=HOST_FLAGS,
                              root=root)
        libs[lib.name] = ctypes.CDLL(str(path))

    def call(lib, entry, argtypes, operands, v, n):
        fn = getattr(libs[lib.name], entry + "_host")
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        assert fn(*[t.data_ptr() for t in operands], v, n) == 0

    kernel._call = call
    return kernel


def scan(compiled, xs, n):
    return lambda p, s: compiled._run(p, s, xs, n, True)[::2]


# -- the port's scan autograd against JAX's ----------------------------------

def _port_grad_patch(name):
    cfg = stt.AudioConfig(sample_rate=4800, block_size=64, channels=1)
    if name == "gradient_patch":
        return stt.presets.gradient_patch(cfg)
    if name == "subtractive_voice":
        return stt.presets.subtractive_voice(cfg, gate_rate_oct=-1.0)
    return getattr(stt.presets, name)(cfg)


@pytest.mark.parametrize("name", GRAD_NAMES)
def test_scan_grads_match_jax(jax_ref, name):
    patch = _port_grad_patch(name)
    compiled = stt.compile_patch(patch)
    mids = list(compiled.instances)
    tag = f"grad/{name}"
    params = interop.params_from_numpy(
        _complete(_tree(jax_ref, f"{tag}/params"), mids, state=False))
    state = interop.state_from_numpy(
        _complete(_tree(jax_ref, f"{tag}/state"), mids, state=True))
    w = torch.from_numpy(jax_ref[f"{tag}/w"])
    wf_tree = _tree(jax_ref, f"{tag}/wf")
    wf = {path: torch.from_numpy(a) for path, a in tree_items(wf_tree)}
    n = w.shape[-1]
    _, grads = float_grads(scan(compiled, {}, n), params, state, w, wf)
    want = dict(tree_items(_tree(jax_ref, f"{tag}/gp")))
    want.update(tree_items(_tree(jax_ref, f"{tag}/gs")))
    assert set(grads) == set(want), sorted(set(grads) ^ set(want))
    nonzero = 0
    for path, g in grads.items():
        assert_rule_b(g.numpy(), want[path], f"{name} {path}")
        nonzero += bool(np.abs(want[path]).max() > 0)
    assert nonzero >= 6


# -- finite differences -------------------------------------------------------

FD_N = 256
PINNED = [("vcf", "freq", 1e-3), ("vcf", "res", 1e-3),
          ("env", "a_sec", 1e-5), ("env", "d_sec", 1e-5),
          ("env", "s_val", 1e-3), ("env", "r_sec", 1e-5)]
VAL_PIN = ("vco", "val", 1e-4)


@pytest.mark.parametrize("engine", ["scan", "k10_host"])
def test_grads_match_finite_differences(engine, gxx, tmp_path):
    """The JAX tests' pins: every pinned param within ``2e-2 * max + 1e-2``
    of central differences (eps as there), the fast-mode pitch through the
    shadow phase within ``5e-2 * max + 1e-3``, its difference above 1."""
    patch = stt.presets.gradient_patch(
        stt.AudioConfig(sample_rate=4800, block_size=64, channels=1))
    compiled = stt.compile_patch(patch)
    ids = {inst.name: inst.id for inst in patch}
    base = compiled.default_params
    pins = PINNED + [VAL_PIN]
    # voice 0 at the defaults, then each pin at +eps and -eps
    voices = [base]
    for mod, name, eps in pins:
        for sign in (1.0, -1.0):
            p2 = {m: dict(d) for m, d in base.items()}
            v0 = float(base[ids[mod]][name])
            p2[ids[mod]][name] = torch.tensor(v0 + sign * eps,
                                              dtype=torch.float32)
            voices.append(p2)
    params = stt.stack_params(voices)
    v = len(voices)
    init = compiled.init_state()
    state = tree_map(lambda a: a.expand((v,) + a.shape).contiguous(), init)
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, FD_N)).astype(np.float32))
    with torch.no_grad():
        audio, _ = compiled.render_scan(params, state, FD_N, batched=True,
                                        nograd=True)
    losses = [float((audio[i] * w).sum()) for i in range(v)]
    one = tree_map(lambda a: a[:1], params)
    state1 = tree_map(lambda a: a[:1], state)
    if engine == "scan":
        render = scan(compiled, {}, FD_N)
    else:
        kernel = host_k10(compiled, (), 64, gxx, tmp_path)
        render = (lambda p, s: kernel.apply(p, s, FD_N, {}))
    got_audio, grads = float_grads(render, one, state1, w[None])
    torch.testing.assert_close(got_audio[0], audio[0], atol=0, rtol=0)
    for k, (mod, name, eps) in enumerate(pins):
        g_fd = (losses[1 + 2 * k] - losses[2 + 2 * k]) / (2.0 * eps)
        g_ad = float(grads[(ids[mod], name)][0])
        if (mod, name, eps) == VAL_PIN:
            tol = 5e-2 * max(abs(g_fd), abs(g_ad)) + 1e-3
            assert abs(g_fd) > 1.0
        else:
            tol = 2e-2 * max(abs(g_fd), abs(g_ad)) + 1e-2
        assert abs(g_ad - g_fd) <= tol, (
            f"{engine} {mod}.{name}: autodiff {g_ad:.6g} vs FD {g_fd:.6g}")


# -- kernel K10 on the host ---------------------------------------------------

HOST_V = 3


def _host_case(name, n):
    """``(patch, compiled, params, state, xs)`` for a K10 host case at
    4,800 Hz: farm_params of 3 voices; lane_check_patch with a random gate
    driver, a pitch lane on its VCO's automated ``val`` and its Noise
    drawn by the port's generator (the envelope's ``d_sec`` and the
    filter's ``freq`` are automated without arrays); kernel_check_patch
    with its Non-Linear's exponent at 2.0."""
    v = HOST_V
    if name == "lane_check_patch":
        patch, autos = stt.presets.lane_check_patch(
            stt.AudioConfig(sample_rate=4800, channels=2))
    elif name == "kernel_check_patch":
        patch, autos = stt.presets.kernel_check_patch(
            stt.AudioConfig(sample_rate=4800, channels=3)), ()
    else:
        patch, autos = _port_grad_patch(name), ()
    compiled = stt.compile_patch(patch, automation=autos)
    params = stt.presets.farm_params(patch, v, seed=5)
    state = tree_map(lambda a: a.expand((v,) + a.shape).contiguous(),
                     compiled.init_state())
    drivers = {}
    if name == "kernel_check_patch":
        shaper = next(i.id for i in patch if i.name == "shaper")
        params[shaper]["constant"] = torch.full((v,), 2.0)
    if name == "lane_check_patch":
        rng = np.random.default_rng(9)
        ids = {inst.name: inst.id for inst in patch}
        drivers = {
            ids["gate"]: torch.from_numpy(
                (rng.uniform(size=(v, n)) < 0.1).astype(np.float32)),
            compiled._auto_key(ids["vco"], "val"): torch.from_numpy(
                rng.uniform(-1.5, 0.5, (v, n)).astype(np.float32))}
    xs = compiled._make_xs(params, 3, n, drivers)
    return patch, compiled, params, state, xs


def _final_weights(compiled, state, seed):
    rng = np.random.default_rng(seed)
    return {path: torch.from_numpy(rng.standard_normal(
        tuple(t.shape)).astype(np.float32))
        for path, t in tree_items(state) if t.is_floating_point()}


def _compare_k10(kernel, compiled, params, state, xs, n, w, wf, where):
    audio_k, got = float_grads(
        lambda p, s: kernel.apply(p, s, n, xs), params, state, w, wf)
    audio_s, want = float_grads(scan(compiled, xs, n), params, state, w, wf)
    assert torch.equal(audio_k, audio_s), where
    assert set(got) == set(want)
    for path, g in want.items():
        assert_rule_b(got[path].numpy(), g.numpy(), f"{where} {path}")
    assert kernel.fwd.launches == 0 and kernel.bwd.launches == 0
    return want


@pytest.mark.parametrize("name", HOST_PATCHES)
def test_k10_host_matches_scan_autograd(gxx, tmp_path, name):
    """n=256 in chunks of 48 (the last one ragged), a loss on the audio and
    on the final state."""
    n = 256
    patch, compiled, params, state, xs = _host_case(name, n)
    kernel = host_k10(compiled, xs, 48, gxx, tmp_path)
    w = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (HOST_V, compiled.cfg.channels, n)).astype(np.float32))
    wf = _final_weights(compiled, state, 13)
    want = _compare_k10(kernel, compiled, params, state, xs, n, w, wf, name)
    flowing = sum(bool(g.abs().max() > 0) for g in want.values()
                  if not torch.isnan(g).any())
    assert flowing >= 5, name


@pytest.mark.parametrize("name", HOST_PATCHES)
def test_k10_host_final_state_cotangent(gxx, tmp_path, name):
    """n=23 in chunks of 16: the final state's cotangent enters at sample
    n-1, not at a chunk end (a loss on the final float state only)."""
    n = 23
    patch, compiled, params, state, xs = _host_case(name, n)
    kernel = host_k10(compiled, xs, 16, gxx, tmp_path)
    wf = _final_weights(compiled, state, 17)
    want = _compare_k10(kernel, compiled, params, state, xs, n, None, wf,
                        name)
    assert sum(bool(g.abs().max() > 0) for g in want.values()) >= 2


def test_k10_host_matches_jax_fused_vjp(jax_ref, gxx, tmp_path):
    """Against the JAX package's fused VJP in interpret mode
    (``make_fused_vjp``, t_chunk=16): subtractive voice, V=2, n=32, the
    gradient of ``mean(audio ** 2)`` with respect to the params."""
    patch = _port_grad_patch("subtractive_voice")
    compiled = stt.compile_patch(patch)
    mids = list(compiled.instances)
    params = interop.params_from_numpy(
        _complete(_tree(jax_ref, "vjp/params"), mids, state=False))
    state = interop.state_from_numpy(
        _complete(_tree(jax_ref, "vjp/state"), mids, state=True))
    n = 32
    kernel = host_k10(compiled, (), 16, gxx, tmp_path)
    assert kernel.fwd.name == "fused_vjp_fwd"
    p = tree_map(lambda a: a.clone().requires_grad_(True), params)
    audio, _ = kernel.apply(p, state, n, {})
    np.testing.assert_array_equal(audio.detach().numpy(),
                                  jax_ref["vjp/audio"])
    (audio ** 2).mean().backward()
    want = dict(tree_items(_tree(jax_ref, "vjp/grads")))
    nonzero = 0
    for path, leaf in tree_items(p):
        assert_rule_b(leaf.grad.numpy(), want[path], str(path))
        nonzero += bool(np.abs(want[path]).max() > 0)
    assert nonzero >= 4


# -- the Function, its wrapper and the dispatch -------------------------------

def test_make_fused_vjp_returns_an_autograd_function():
    compiled = stt.compile_patch(_port_grad_patch("subtractive_voice"))
    fn = make_fused_vjp(compiled, 64)
    assert issubclass(fn, torch.autograd.Function)
    assert fn.n == 64 and fn.kernel is compiled.fused_vjp()
    assert make_fused_vjp(compiled, 64) is fn
    source = fn.kernel.bwd.source
    assert "srk_vjp_bwd_launch" in source and "srk_vjp_bwd_host" in source
    assert "#define SRK_T_CHUNK 128" in source


def test_k10_wrapper_raises_for_cpu_tensors():
    """The wrapper launches for CUDA tensors or raises: CPU tensors take
    the plain version in ``grad_render_fn``, never in the wrapper."""
    patch = _port_grad_patch("subtractive_voice")
    compiled = stt.compile_patch(patch)
    kernel = FusedVJPKernel(compiled)
    params = stt.presets.farm_params(patch, 2)
    state = tree_map(lambda a: a.expand((2,) + a.shape).contiguous(),
                     compiled.init_state())
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.apply(params, state, 8, {})
    assert kernel.fwd.launches == 0 and kernel.bwd.launches == 0


def test_grad_render_fn_on_cpu_is_scan_autograd():
    patch = _port_grad_patch("subtractive_voice")
    compiled = stt.compile_patch(patch)
    params = stt.presets.farm_params(patch, 2)
    state = tree_map(lambda a: a.expand((2,) + a.shape).contiguous(),
                     compiled.init_state())
    n = 64
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 1, n)).astype(np.float32))
    fn = compiled.grad_render_fn(n)
    audio, got = float_grads(lambda p, s: fn(p, s, 0, {})[::2], params,
                             state, w)
    want_audio, want = float_grads(scan(compiled, {}, n), params, state, w)
    assert torch.equal(audio, want_audio)
    for path, g in want.items():
        torch.testing.assert_close(got[path], g, atol=0, rtol=0)


def test_patch_without_adjoint_is_not_k10_eligible():
    """A module type with a device function but no adjoint: the fused
    kernel takes the patch, K10 does not, and gradients go through the
    scan engine."""
    base = stt.CATALOG["VCA"]
    custom = ModuleDef(
        type_name="No Adjoint VCA", make=base.make,
        num_inputs=base.num_inputs, num_outputs=base.num_outputs,
        input_labels=base.input_labels, output_labels=base.output_labels,
        init_state=base.init_state, step=base.step, cuda_fn=base.cuda_fn)
    stt.register_module(custom)
    try:
        p = stt.Patch(stt.AudioConfig(sample_rate=4800, channels=1))
        osc = p.add("Oscillator", val=-1.0)
        vca = p.add("No Adjoint VCA")
        p.connect(osc, "Sine", vca, "Audio")
        p.connect(osc, "Sine", vca, "CV")
        p.connect(vca, 0, p.output, 0)
        compiled = stt.compile_patch(p)
        assert compiled.fused_eligible() and not compiled.vjp_eligible()
        with pytest.raises(ValueError, match="not eligible for the fused "
                                             "VJP"):
            make_fused_vjp(compiled, 16)
        params = stt.replicate_params(p.params(), 2)
        params = tree_map(lambda a: a.clone().requires_grad_(
            a.is_floating_point()), params)
        state = tree_map(lambda a: a.expand((2,) + a.shape).contiguous(),
                         compiled.init_state())
        audio, _, _ = compiled.grad_render_fn(16)(params, state, 0, {})
        audio.sum().backward()
        assert all(t.grad is not None for t in tree_leaves(params)
                   if t.requires_grad)
    finally:
        stt.unregister_module("No Adjoint VCA")


def test_buffer_mode_is_not_k10_eligible():
    compiled = stt.compile_patch(stt.presets.feedback_patch(
        stt.AudioConfig(sample_rate=4800, block_size=32, channels=1,
                        buffer_feedback=True)))
    assert compiled.fused_eligible() and not compiled.vjp_eligible()
    with pytest.raises(ValueError, match="sample-mode"):
        fused.generate_source(compiled, mode="bwd")


# -- the derivative conventions the adjoints follow ---------------------------

def test_clip_derivative_matches_jax():
    """``ops/basic.py::clip`` takes ``jnp.clip``'s derivative: 1/2 at a
    bound, where ``torch.clamp`` takes 1 (a saturated ladder meets its
    bounds exactly)."""
    import jax
    import jax.numpy as jnp
    from srack_tpu_torch.ops.basic import clip
    xs = np.float32([-3.0, -1.0, -0.5, 0.0, 0.9, 1.0, 2.0])
    x = torch.from_numpy(xs).requires_grad_(True)
    clip(x, -1.0, 1.0).sum().backward()
    want = jax.vmap(jax.grad(lambda v: jnp.clip(v, -1.0, 1.0)))(xs)
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert x.grad[1] == 0.5
    with torch.no_grad():
        assert torch.equal(clip(x, -1.0, 1.0), torch.clamp(x, -1.0, 1.0))


def test_poly_blep_derivative_matches_jax():
    """d|u|/du is +1 at u = 0 in JAX (every phase starts there); the
    port's polyBLEP takes the same derivative."""
    import jax
    from srack_tpu.ops.basic import poly_blep_signed as jax_blep
    from srack_tpu_torch.ops.basic import poly_blep_signed
    us = np.float32([-1.5, -1.0, -0.5, -0.0, 0.0, 0.25, 1.0, 1.5])
    u = torch.from_numpy(us).requires_grad_(True)
    poly_blep_signed(u).sum().backward()
    want = jax.vmap(jax.grad(jax_blep))(us)
    np.testing.assert_array_equal(u.grad.numpy(), np.asarray(want))
    assert u.grad[4] == 2.0
