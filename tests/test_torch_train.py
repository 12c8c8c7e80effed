"""The port's trainer (``srack_tpu_torch/utils/train.py``) on the CPU.

Three ``batched_train_step`` steps of the port (``fast=False``,
``torch.optim.Adam(lr=1e-3)``) against the JAX package's (``optax.adam(
1e-3)``) from the same start, the subtractive voice with a fast gate clock
at 4,800 Hz, V=2, n=256, random targets: the losses within rtol 1e-5, the
first step's gradients within ``1e-8 + 1e-4 * max|ref|`` per leaf, and the
params after three steps within 1e-5.  Adam's ``g / (|g| + eps)`` magnifies
the rounding of a gradient below 1e-4, so leaves whose first gradient is
that small are left out of the last check (their count is printed).

The JAX run comes from ``tests/torch_parity_worker.py`` (case ``train``).
"""

import functools
import subprocess
import sys

import numpy as np
import pytest
import torch

import srack_tpu_torch as stt
from srack_tpu_torch import interop
from srack_tpu_torch.compiler import tree_items, tree_map
from srack_tpu_torch.ops.basic import fold_in
from srack_tpu_torch.parallel import make_mesh
from srack_tpu_torch.utils import train as T

from test_torch_grad import assert_rule_b
from test_torch_slice import ROOT, WORKER, _env, _tree

ADAM = functools.partial(torch.optim.Adam, lr=1e-3)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    proc = subprocess.run([sys.executable, str(WORKER), str(out), "train"],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _voice(sample_rate=4800):
    return stt.presets.subtractive_voice(
        stt.AudioConfig(sample_rate=sample_rate, block_size=64, channels=1),
        gate_rate_oct=-1.0)


def _init(patch):
    """``(train, frozen)`` from the patch's defaults, as JAX's bench makes
    them: ``SoundMatcher(...).init()``."""
    ts = T.SoundMatcher(patch, 64, device="cpu").init()
    return ts["train"], ts["frozen"]


def _start(jax_ref, compiled):
    mids = list(compiled.instances)
    train = {m: {} for m in mids}
    train.update(_tree(jax_ref, "train/train0"))
    frozen = {m: {} for m in mids}
    frozen.update(_tree(jax_ref, "train/frozen"))
    return interop.train_from_numpy(train, frozen)


def test_batched_train_step_matches_jax(jax_ref, capsys):
    compiled = stt.compile_patch(_voice())
    train, frozen = _start(jax_ref, compiled)
    targets = torch.from_numpy(jax_ref["train/targets"])
    n = targets.shape[-1]
    step = T.batched_train_step(compiled, ADAM, n, device="cpu")
    opt, losses, grads0 = None, [], None
    for i in range(3):
        train, opt, loss = step(train, frozen, opt, targets, 0)
        losses.append(float(loss))
        if i == 0:
            # a param no loss path reaches (the gate clock's pitch feeds
            # only its unused Sine and Sawtooth) has no grad: JAX's is 0
            grads0 = {path: (torch.zeros_like(leaf) if leaf.grad is None
                             else leaf.grad.clone())
                      for path, leaf in tree_items(train)}
    np.testing.assert_allclose(losses, jax_ref["train/losses"], rtol=1e-5)
    want_g = dict(tree_items(_tree(jax_ref, "train/grads0")))
    assert set(grads0) == set(want_g)
    for path, g in grads0.items():
        assert_rule_b(g.numpy(), want_g[path], f"grad {path}")
    want_p = dict(tree_items(_tree(jax_ref, "train/train3")))
    skipped = 0
    for path, leaf in tree_items(train):
        if np.abs(want_g[path]).max() < 1e-4:
            skipped += 1
            continue
        np.testing.assert_allclose(leaf.detach().numpy(), want_p[path],
                                   atol=1e-5, rtol=0, err_msg=str(path))
    with capsys.disabled():
        print(f"\n[train parity] {skipped} of {len(want_p)} leaves left out "
              "of the params check (first gradient below 1e-4)")
    assert len(want_p) - skipped >= 4


def test_fast_step_on_cpu_equals_scan_step():
    """``fast=True`` on CPU tensors differentiates through the scan engine
    (K10 needs the card): the same losses and params as ``fast=False``."""
    patch = _voice()
    compiled = stt.compile_patch(patch)
    targets = torch.zeros((2, 1, 96))
    runs = []
    for fast in (False, True):
        train, frozen = _init(patch)
        run = T.multi_train_step(compiled, ADAM, 96, 3, fast=fast,
                                 device="cpu")
        train, _, losses = run(train, frozen, None, targets, 5)
        runs.append((losses, train))
    torch.testing.assert_close(runs[0][0], runs[1][0], atol=0, rtol=0)
    for (path, a), (_, b) in zip(tree_items(runs[0][1]), tree_items(runs[1][1])):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=str(path))
    assert bool(runs[0][0][-1] < runs[0][0][0])


def test_multi_train_step_folds_the_key_per_step():
    """Step i of ``multi_train_step`` draws its Noise from ``fold_in(key,
    i)``: the same run as single steps with those keys."""
    p = stt.Patch(stt.AudioConfig(sample_rate=4800, channels=1))
    noise = p.add("Noise", name="noise")
    flt = p.add("Moog Filter", freq=0.4, res=0.2, name="vcf")
    p.connect(noise, 0, flt, "Audio")
    p.connect(flt, 0, p.output, 0)
    compiled = stt.compile_patch(p)
    targets = torch.zeros((2, 1, 64))
    train, frozen = _init(p)
    run = T.multi_train_step(compiled, ADAM, 64, 3, device="cpu")
    _, _, losses = run(train, frozen, None, targets, 11)
    train, frozen = _init(p)
    step = T.batched_train_step(compiled, ADAM, 64, device="cpu")
    opt, singles = None, []
    for i in range(3):
        train, opt, loss = step(train, frozen, opt, targets, fold_in(11, i))
        singles.append(loss)
    torch.testing.assert_close(losses, torch.stack(singles), atol=0, rtol=0)
    assert len(set(float(x) for x in losses)) == 3


@pytest.mark.parametrize("kwargs", [{"mesh": 3}, {"packed": True}])
def test_mesh_and_packed_raise(kwargs):
    """``packed=True`` (the TPU kernels' layout) raises
    ``NotImplementedError``.  ``mesh=`` is ported
    (``tests/test_torch_parallel.py``): a step raises where the mesh's
    slots do not split the voices evenly (3 slots, 4 voices)."""
    compiled = stt.compile_patch(_voice())
    if "mesh" in kwargs:
        mesh = make_mesh(devices=["cpu"] * kwargs["mesh"])
        ts = T.SoundMatcher(_voice(), 64, device="cpu").init()
        targets = torch.zeros(4, 1, 64)
        for step in (T.batched_train_step(compiled, ADAM, 64, fast=True,
                                          mesh=mesh, device="cpu"),
                     T.multi_train_step(compiled, ADAM, 64, 2, fast=True,
                                        mesh=mesh, device="cpu")):
            with pytest.raises(ValueError, match="do not split evenly"):
                step(ts["train"], ts["frozen"], None, targets, 0)
        return
    with pytest.raises(NotImplementedError):
        T.batched_train_step(compiled, ADAM, 64, fast=True, device="cpu",
                             **kwargs)
    with pytest.raises(NotImplementedError):
        T.multi_train_step(compiled, ADAM, 64, 2, fast=True, device="cpu",
                           **kwargs)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    compiled = stt.compile_patch(_voice())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.batched_train_step(compiled, ADAM, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.SoundMatcher(_voice(), 64)


def test_sound_matcher_lowers_the_loss():
    """One unbatched render per step through the scan engine; only the
    params the predicate accepts move."""
    patch = _voice()
    ids = {inst.name: inst.id for inst in patch}
    sm = T.SoundMatcher(patch, 128, loss_fn=stt.utils.waveform_l2,
                        trainable=lambda mid, name: mid == ids["vcf"],
                        device="cpu")
    ts = sm.init()
    assert set(ts["train"][ids["vcf"]]) == {"freq", "res", "exp_amt"}
    assert all(not ts["train"][m] for m in ts["train"] if m != ids["vcf"])
    before = tree_map(lambda a: a.detach().clone(), sm.params(ts))
    target = torch.zeros((1, 128))
    losses = []
    for _ in range(4):
        ts, loss = sm.step(ts, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    after = sm.params(ts)
    assert not torch.equal(after[ids["vcf"]]["freq"],
                           before[ids["vcf"]]["freq"])
    assert torch.equal(after[ids["env"]]["a_sec"],
                       before[ids["env"]]["a_sec"])


def test_train_from_numpy_carries_a_jax_train_state(jax_ref):
    compiled = stt.compile_patch(_voice())
    train, frozen = _start(jax_ref, compiled)
    for path, leaf in tree_items(train):
        assert leaf.requires_grad and leaf.is_leaf and leaf.dtype == \
            torch.float32, path
        np.testing.assert_array_equal(
            leaf.detach().numpy(), dict(tree_items(_tree(
                jax_ref, "train/train0")))[path])
    assert not any(t.requires_grad for _, t in tree_items(frozen))
