"""ETSformer blocks: exponential-smoothing attention, growth, Fourier
season, level (counterpart of sie_tpu/models/extra/etsformer.py).

- `next_fast_len`: the smallest 5-smooth integer >= n (scipy.fftpack's,
  copied: the port does not import scipy).
- `conv1d_fft`: FFT cross-correlation of f against g over `dim` at that
  fast length, its last N lags.
- `ExponentialSmoothing`: out_t = alpha^(t+1) v0 + sum_s (1 - alpha)
  alpha^(t-s) v_s by one FFT correlation, alpha = sigmoid(
  `smoothing_weight`) per head; `v0` N(0, 1).
- `GrowthLayer` (`z0`, `in_proj`, `es`, `out_proj`), `FourierLayer` (the
  k strongest non-DC frequencies of each (row, channel), extrapolated as
  amp * cos(2 pi f t + phase); the top-k bins gathered by index, distinct
  within a row, so the backward is deterministic), `LevelLayer`,
  `DampingLayer` (`damping_factor`) and the encoder and decoder stacks.
- `transform_augment`: the scale, shift and jitter augmentation, drawn
  from a torch.Generator (the JAX package draws it with jax.random; no
  model calls it).

Float32 throughout, as in the JAX package (no compute dtype).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from sie_tpu_torch.models.layers import (dense, dropout, layer_norm,
                                         layer_norm_module, lecun_linear,
                                         normal_param)

F32 = torch.float32


def next_fast_len(n: int) -> int:
    """The smallest integer >= n whose prime factors are 2, 3 and 5."""
    if n <= 6:
        return max(n, 1)
    best = 2 * n
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            q = -(-n // p35)                     # ceil(n / p35)
            p2 = 1 << max((q - 1).bit_length(), 0)
            best = min(best, p2 * p35)
            if p35 * p2 == n:
                return n
            p35 *= 3
        p5 *= 5
    return best


def transform_augment(x: torch.Tensor, sigma: float,
                      generator: torch.Generator) -> torch.Tensor:
    """x * (1 + sigma N) + sigma N (per channel) + sigma N (per element)."""
    dev = x.device
    n = lambda shape: torch.randn(shape, generator=generator, device=dev)
    x = x * (n(x.shape[-1:]) * sigma + 1.0)
    x = x + n(x.shape[-1:]) * sigma
    return x + n(x.shape) * sigma


def conv1d_fft(f: torch.Tensor, g: torch.Tensor, dim: int = 1
               ) -> torch.Tensor:
    n, m = f.shape[dim], g.shape[dim]
    fast = next_fast_len(n + m - 1)
    ff = torch.fft.rfft(f, fast, dim=dim)
    fg = torch.fft.rfft(g, fast, dim=dim)
    out = torch.fft.irfft(ff * torch.conj(fg), fast, dim=dim)
    out = torch.roll(out, -1, dims=dim)
    return out.narrow(dim, fast - n, n)


class ExponentialSmoothing(nn.Module):
    def __init__(self, dim: int, nhead: int, g: torch.Generator,
                 dropout: float = 0.1, prepend_v0: bool = False):
        super().__init__()
        self.dropout, self.prepend_v0 = dropout, prepend_v0
        self.smoothing_weight = normal_param((nhead, 1), 1.0, g)
        self.v0 = normal_param((1, 1, nhead, dim), 1.0, g)

    def forward(self, values, aux_values=None,
                generator: Optional[torch.Generator] = None):
        b, t, h, d = values.shape
        alpha = torch.sigmoid(self.smoothing_weight)          # (H, 1)
        powers = torch.arange(t, dtype=F32, device=values.device)
        shape = lambda w: w.T[None, :, :, None]               # (1, T, H, 1)
        weight = shape((1 - alpha) * alpha ** torch.flip(powers, (0,)))
        init_weight = shape(alpha ** (powers + 1))
        drop = lambda z: dropout(z, self.dropout, generator, self.training)
        out = conv1d_fft(drop(values), weight, dim=1)
        out = init_weight * self.v0 + out
        if aux_values is not None:
            a = alpha.T[None, :, :, None]                     # (1, 1, H, 1)
            aux_weight = weight / (1 - a) * a
            out = out + conv1d_fft(drop(aux_values), aux_weight, dim=1)
        if self.prepend_v0:
            out = torch.cat([self.v0.expand(b, 1, h, d), out], dim=1)
        return out


class GrowthLayer(nn.Module):
    """(B, T, D) -> (B, T+1, D)."""

    def __init__(self, d_model: int, nhead: int, g: torch.Generator,
                 dropout: float = 0.1):
        super().__init__()
        self.nhead = nhead
        d_head = d_model // nhead
        self.z0 = normal_param((nhead, d_head), 1.0, g)
        self.in_proj = lecun_linear(d_model, d_head * nhead, g)
        self.es = ExponentialSmoothing(d_head, nhead, g, dropout,
                                       prepend_v0=True)
        self.out_proj = lecun_linear(d_head * nhead, d_model, g)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        b, t, _ = x.shape
        h, dh = self.z0.shape
        v = dense(x, self.in_proj, F32).view(b, t, h, dh)
        v = torch.cat([self.z0.expand(b, 1, h, dh), v], dim=1)
        v = v[:, 1:] - v[:, :-1]
        out = self.es(v, generator=generator).reshape(b, t + 1, h * dh)
        return dense(out, self.out_proj, F32)


class FourierLayer(nn.Module):
    """Seasonality of (B, T, D): (B, T + pred_len, D). No parameters."""

    def __init__(self, pred_len: int, k: int, low_freq: int = 1):
        super().__init__()
        self.pred_len, self.k, self.low_freq = pred_len, k, low_freq

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        x_freq = torch.fft.rfft(x, dim=1)                     # (B, F, D)
        hi = x_freq.shape[1] - 1 if t % 2 == 0 else x_freq.shape[1]
        x_freq = x_freq[:, self.low_freq:hi]
        f_all = torch.fft.rfftfreq(t, device=x.device)[self.low_freq:hi]
        with torch.no_grad():
            idx = torch.topk(x_freq.abs().transpose(1, 2), self.k,
                             dim=-1).indices.transpose(1, 2)  # (B, k, D)
        x_top = torch.gather(x_freq, 1, idx)
        f_top = f_all[idx]
        x_cat = torch.cat([x_top, torch.conj(x_top)], dim=1)
        f_cat = torch.cat([f_top, -f_top], dim=1)             # (B, 2k, D)
        t_val = torch.arange(t + self.pred_len, dtype=F32, device=x.device)
        amp = (x_cat.abs() / t)[:, :, None, :]
        phase = torch.angle(x_cat)[:, :, None, :]
        wave = amp * torch.cos(2 * math.pi * f_cat[:, :, None, :]
                               * t_val[None, None, :, None] + phase)
        return wave.sum(dim=1)


class LevelLayer(nn.Module):
    def __init__(self, d_model: int, c_out: int, g: torch.Generator,
                 dropout: float = 0.1):
        super().__init__()
        self.c_out = c_out
        self.growth_pred = lecun_linear(d_model, c_out, g)
        self.season_pred = lecun_linear(d_model, c_out, g)
        self.es = ExponentialSmoothing(1, c_out, g, dropout)

    def forward(self, level, growth, season,
                generator: Optional[torch.Generator] = None):
        b, t, _ = level.shape
        growth = dense(growth, self.growth_pred, F32)
        season = dense(season, self.season_pred, F32)
        out = self.es((level - season).reshape(b, t, self.c_out, 1),
                      growth.reshape(b, t, self.c_out, 1), generator)
        return out.reshape(b, t, self.c_out)


class ETSEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, c_out: int,
                 pred_len: int, k: int, g: torch.Generator,
                 dim_feedforward: int = 0, dropout: float = 0.1,
                 activation: str = "sigmoid"):
        super().__init__()
        d_ff = dim_feedforward or 4 * d_model
        self.pred_len, self.dropout = pred_len, dropout
        self.act = getattr(torch, activation)
        self.seasonal = FourierLayer(pred_len, k)
        self.growth = GrowthLayer(d_model, nhead, g, dropout)
        self.norm1 = layer_norm_module(d_model)
        self.ff1 = lecun_linear(d_model, d_ff, g, bias=False)
        self.ff2 = lecun_linear(d_ff, d_model, g, bias=False)
        self.norm2 = layer_norm_module(d_model)
        self.level = LevelLayer(d_model, c_out, g, dropout)

    def forward(self, res, level, generator: Optional[torch.Generator] = None):
        drop = lambda z: dropout(z, self.dropout, generator, self.training)
        p = self.pred_len
        season = drop(self.seasonal(res))
        res = res - season[:, :-p]
        growth = drop(self.growth(res, generator))
        res = layer_norm(self.norm1, res - growth[:, 1:])
        ff = dense(drop(self.act(dense(res, self.ff1, F32))), self.ff2, F32)
        res = layer_norm(self.norm2, res + drop(ff))
        level = self.level(level, growth[:, :-1], season[:, :-p], generator)
        return res, level, growth, season


class ETSEncoder(nn.Module):
    """Stack of ETSEncoderLayers (one kwargs dict each), collecting each
    layer's growth and season."""

    def __init__(self, layers: Sequence[dict], g: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleList(ETSEncoderLayer(**kw, g=g)
                                    for kw in layers)

    def forward(self, res, level, generator: Optional[torch.Generator] = None):
        growths, seasons = [], []
        for layer in self.layers:
            res, level, growth, season = layer(res, level, generator)
            growths.append(growth)
            seasons.append(season)
        return level, growths, seasons


class DampingLayer(nn.Module):
    def __init__(self, pred_len: int, nhead: int, g: torch.Generator,
                 dropout: float = 0.1):
        super().__init__()
        self.pred_len, self.nhead, self.dropout = pred_len, nhead, dropout
        self.damping_factor = normal_param((1, nhead), 1.0, g)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        b, _, d = x.shape
        x = x.expand(b, self.pred_len, d)
        powers = torch.arange(1, self.pred_len + 1, dtype=F32,
                              device=x.device)[:, None]
        factors = torch.cumsum(torch.sigmoid(self.damping_factor) ** powers,
                               dim=0)
        x = x.reshape(b, self.pred_len, self.nhead, -1)
        x = dropout(x, self.dropout, generator, self.training)
        return (x * factors[..., None]).reshape(b, self.pred_len, d)


class ETSDecoderLayer(nn.Module):
    def __init__(self, nhead: int, pred_len: int, g: torch.Generator,
                 dropout: float = 0.1):
        super().__init__()
        self.pred_len, self.dropout = pred_len, dropout
        self.growth_damping = DampingLayer(pred_len, nhead, g, dropout)

    def forward(self, growth, season,
                generator: Optional[torch.Generator] = None):
        gh = self.growth_damping(growth[:, -1:], generator)
        gh = dropout(gh, self.dropout, generator, self.training)
        return gh, season[:, -self.pred_len:]


class ETSDecoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, c_out: int, pred_len: int,
                 g: torch.Generator, n_layers: int = 2, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            ETSDecoderLayer(nhead, pred_len, g, dropout)
            for _ in range(n_layers))
        self.pred = lecun_linear(d_model, c_out, g)

    def forward(self, growths, seasons,
                generator: Optional[torch.Generator] = None):
        gr, sr = 0.0, 0.0
        for layer, gi, si in zip(self.layers, growths, seasons):
            gh, sh = layer(gi, si, generator)
            gr = gr + gh
            sr = sr + sh
        return dense(gr, self.pred, F32), dense(sr, self.pred, F32)
