"""Batched EEG preprocessing in torch (counterpart of
sie_tpu/data/preprocess.py, which runs one jitted XLA program).

The reference's per-trial pipeline (`data_factory/eeg_processor.py:
258-381`), quirks included, on a batch of trials at once:

1. "Downsample" 500 -> 256 Hz is an identity (`int(500/256) == 1`, and the
   reference falls back to stride-1 indexing).
2. Channel crop or zero-pad to target_channels.
3. Time: crop to target_timepoints if longer (CHISCO: 1651 -> the first
   845 samples); if shorter, Fourier resample upward as
   scipy.signal.resample does.
4. Volts -> microvolts (x 1e6), float32.
5. Per-channel z-score over time with the ddof-1 std.

It runs on the CPU in float32 (`preprocess_trials_host`), as the JAX
package runs it on its host backend: the raw float64 trials never go to
the card, and the processed float32 splits go there once.
"""

from __future__ import annotations

import numpy as np
import torch


def fourier_resample(x: torch.Tensor, num: int, axis: int = -1) -> torch.Tensor:
    """scipy.signal.resample of real input: the rfft spectrum truncated or
    zero-padded to the new length, with scipy's Nyquist-bin cases, scaled
    by num/n; float64 input stays float64, anything else is float32."""
    dtype = x.dtype if x.dtype == torch.float64 else torch.float32
    x = x.to(dtype).movedim(axis, -1)
    n = x.shape[-1]
    xf = torch.fft.rfft(x, dim=-1)
    nyq_out = num // 2 + 1
    nyq_in = n // 2 + 1
    if num < n:   # downsample: truncate the spectrum
        yf = xf[..., :nyq_out].clone()
        if num % 2 == 0:   # fold the energy above the new Nyquist
            yf[..., -1] *= 2.0
    elif num > n:   # upsample: zero-pad the spectrum
        yf = torch.nn.functional.pad(xf, (0, nyq_out - nyq_in))
        if n % 2 == 0:   # split the old Nyquist bin
            yf[..., nyq_in - 1] *= 0.5
    else:
        yf = xf
    y = torch.fft.irfft(yf, num, dim=-1) * (num / n)
    return y.to(dtype).movedim(-1, axis)


def _crop_or_pad_axis(x: torch.Tensor, target: int, axis: int) -> torch.Tensor:
    cur = x.shape[axis]
    if cur > target:
        return x.narrow(axis, 0, target)
    if cur < target:
        pads = [0, 0] * x.ndim
        pads[2 * (x.ndim - 1 - axis) + 1] = target - cur
        return torch.nn.functional.pad(x, pads)
    return x


def preprocess_trials(raw: torch.Tensor, target_channels: int = 122,
                      target_timepoints: int = 845,
                      resample_short: bool = True,
                      normalize: bool = True) -> torch.Tensor:
    """raw: (N, C_raw, T_raw) volts -> (N, target_channels,
    target_timepoints) float32 microvolts, z-scored per channel when
    `normalize`."""
    x = raw.to(torch.float32)
    x = _crop_or_pad_axis(x, target_channels, axis=1)
    t = x.shape[2]
    if t > target_timepoints:
        x = x[:, :, :target_timepoints]
    elif t < target_timepoints:
        if resample_short:
            x = fourier_resample(x, target_timepoints, axis=2)
        else:
            x = _crop_or_pad_axis(x, target_timepoints, axis=2)
    x = x * 1e6
    if normalize:
        mean = x.mean(dim=-1, keepdim=True)
        tt = x.shape[-1]
        var = x.var(dim=-1, keepdim=True, unbiased=False) * (tt / max(tt - 1, 1))
        x = (x - mean) / torch.sqrt(var)
    return x


def preprocess_trials_host(raw, target_channels: int = 122,
                           target_timepoints: int = 845,
                           resample_short: bool = True,
                           normalize: bool = True) -> np.ndarray:
    """`preprocess_trials` on the CPU, from and to numpy: the raw trials
    are cast to float32 on the host and never cross to the card."""
    raw32 = torch.from_numpy(np.ascontiguousarray(raw, dtype=np.float32))
    with torch.no_grad():
        return preprocess_trials(raw32, target_channels, target_timepoints,
                                 resample_short, normalize).numpy()


def validate_trials(x: np.ndarray) -> np.ndarray:
    """Data QA (reference eeg_processor.py:402-426): per trial, a nonzero
    |mean| somewhere, all |mean| < 1e5, a nonzero std somewhere, all std <
    1e5. Returns a boolean keep-mask per trial."""
    mean = np.abs(x.mean(axis=-1))       # (N, C)
    std = x.std(axis=-1)                 # (N, C)
    ok = ((mean.max(axis=1) > 0)
          & (mean < 1e5).all(axis=1)
          & (std.max(axis=1) > 0)
          & (std < 1e5).all(axis=1))
    return ok
