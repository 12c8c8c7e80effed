"""The port's audio losses (``srack_tpu_torch/utils/losses.py``) against
``srack_tpu/utils/losses.py`` on random signals from a numpy seed: the STFT
magnitudes, each loss and its gradient, and the per-voice mean the trainer
takes.  Both run in float64, so the comparison sees the algorithm: in
float32 each package's FFT gradient is ~1e-6 (3e-5 of the largest) off
the float64 one, in its own way.  Scalars within rtol 1e-5; arrays within
rtol 1e-5 plus an atol of 1e-5 of their largest magnitude (a near-zero bin
carries the FFT's rounding, which no relative bound holds).  Also: the
port's float32 gradient stays within 1e-4 of its largest element of the
float64 reference."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from srack_tpu_torch.utils import losses

from test_torch_slice import ROOT, WORKER, _env

RTOL = 1e-5
LOSSES = {"msl": losses.multiscale_spectral_loss, "l2": losses.waveform_l2}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    proc = subprocess.run([sys.executable, str(WORKER), str(out), "losses"],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def assert_close(got, want, where):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, where
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=where)


def _inputs(jax_ref, dtype=torch.float64):
    return (torch.from_numpy(jax_ref["losses/pred"]).to(dtype),
            torch.from_numpy(jax_ref["losses/target"]).to(dtype))


@pytest.mark.parametrize("frame,hop", [(256, 64), (1024, 256), (300, 100)])
def test_stft_mag_matches_jax(jax_ref, frame, hop):
    pred, _ = _inputs(jax_ref)
    got = losses.stft_mag(pred[0, 0], frame, hop)
    assert got.dtype == torch.float64
    assert losses.stft_mag(pred[0, 0].float(), frame, hop).dtype == \
        torch.float32
    assert_close(got.numpy(), jax_ref[f"losses/stft_{frame}_{hop}"],
                 f"stft {frame}/{hop}")


@pytest.mark.parametrize("vmapped", [False, True])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_gradient_match_jax(jax_ref, name, vmapped):
    """The loss of the whole batch, or (``vmapped``) the mean of the
    per-voice losses, as ``batched_train_step`` takes it."""
    pred, target = _inputs(jax_ref)
    pred = pred.clone().requires_grad_(True)
    fn = LOSSES[name]
    val = (torch.func.vmap(fn)(pred, target).mean() if vmapped
           else fn(pred, target))
    val.backward()
    tag = f"losses/{name}/" + ("vmap_" if vmapped else "")
    np.testing.assert_allclose(float(val.detach()),
                               float(jax_ref[tag + "value"]), rtol=RTOL)
    assert_close(pred.grad.numpy(), jax_ref[tag + "grad"], f"{name} grad")


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_float32_gradient_is_near_the_float64_one(jax_ref, name):
    pred, target = _inputs(jax_ref, torch.float32)
    pred.requires_grad_(True)
    LOSSES[name](pred, target).backward()
    want = jax_ref[f"losses/{name}/grad"]
    np.testing.assert_allclose(pred.grad.double().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_multiscale_loss_skips_frames_longer_than_the_signal():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    only_256 = losses.multiscale_spectral_loss(x, y, frames=(256,))
    assert float(losses.multiscale_spectral_loss(x, y)) == float(only_256)
    assert float(losses.multiscale_spectral_loss(x[:100], y[:100])) == 0.0
