"""Audio losses for differentiable sound matching (counterpart:
``srack_tpu/utils/losses.py``).

Every render of the port is differentiable with respect to the module
params, so a patch can be fitted to a target sound by gradient descent
(``utils/train.py``).  The functions take one voice's ``[..., n]`` signal;
the trainer maps them over the voices.
"""

from __future__ import annotations

from typing import Sequence

import torch


def stft_mag(x: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    """Magnitude STFT of a ``[..., n]`` signal with a symmetric Hann window
    (``jnp.hanning``): ``[..., n_frames, frame // 2 + 1]``."""
    n = x.shape[-1]
    n_frames = max(1, (n - frame) // hop + 1)
    idx = (torch.arange(n_frames, device=x.device)[:, None] * hop
           + torch.arange(frame, device=x.device)[None, :])
    window = torch.hann_window(frame, periodic=False, dtype=x.dtype,
                               device=x.device)
    return torch.fft.rfft(x[..., idx] * window, dim=-1).abs()


def multiscale_spectral_loss(
        pred: torch.Tensor, target: torch.Tensor,
        frames: Sequence[int] = (256, 512, 1024),
        eps: float = 1e-6) -> torch.Tensor:
    """Multi-resolution STFT loss: L1 on the magnitudes plus L1 on the log
    magnitudes, at each frame length the signal holds (hop = frame / 4)."""
    loss = torch.zeros((), dtype=pred.dtype, device=pred.device)
    for frame in frames:
        if pred.shape[-1] < frame:
            continue
        hop = frame // 4
        pm = stft_mag(pred, frame, hop)
        tm = stft_mag(target, frame, hop)
        loss = loss + (pm - tm).abs().mean()
        loss = loss + (torch.log(pm + eps) - torch.log(tm + eps)).abs().mean()
    return loss


def waveform_l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared difference of the waveforms."""
    return ((pred - target) ** 2).mean()
