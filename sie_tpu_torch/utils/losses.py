"""Forecast losses (counterpart of sie_tpu/utils/losses.py, the N-BEATS
mape/smape/mase objectives) in torch. `_div_no_nan` replaces every
non-finite quotient by 0, as the JAX package's does."""

from __future__ import annotations

import torch


def _div_no_nan(a, b) -> torch.Tensor:
    out = torch.as_tensor(a) / b
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def mape_loss(forecast, target, mask=1.0):
    weights = _div_no_nan(mask, target)
    return torch.mean(torch.abs((forecast - target) * weights))


def smape_loss(forecast, target, mask=1.0):
    return 200.0 * torch.mean(
        _div_no_nan(torch.abs(forecast - target),
                    torch.abs(forecast) + torch.abs(target)) * mask)


def mase_loss(insample, freq: int, forecast, target, mask=1.0):
    masep = torch.mean(torch.abs(insample[:, freq:] - insample[:, :-freq]),
                       dim=1)
    return torch.mean(torch.abs(target - forecast)
                      * _div_no_nan(mask, masep[:, None]))
