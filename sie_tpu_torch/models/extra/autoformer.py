"""Autoformer blocks: series decomposition and auto-correlation attention
(counterpart of sie_tpu/models/extra/autoformer.py).

- `moving_avg`: a box filter over time on an edge-replicated pad;
  `series_decomp` returns (x - trend, trend); `series_decomp_multi`
  averages several kernels' decompositions (FEDformer).
- `SeasonalLayerNorm`: LayerNorm (`LayerNorm_0`, flax's auto name), then
  the time mean subtracted.
- `AutoCorrelation`: corr = irfft(rfft(q) * conj(rfft(k))) in float32
  (torch.fft; cuFFT on the card), the top_k = int(factor * ln L) delays
  (in training shared by the batch from the batch-mean correlation, in
  eval per row), softmax weights, and the values rolled by each delay and
  summed. The roll is one gather along time by (t + delay) mod L: each
  (row, delay) reads a permutation of time, so its backward adds one
  value to each element and stays deterministic.
- `AutoCorrelationLayer` and `SpectralAttentionLayer` (FEDformer: Fourier
  or multiwavelet inner mechanism, `inner`) wrap a mechanism in the
  query/key/value/out projections (flax's default Dense init).
- `AutoformerEncoder` / `AutoformerDecoder`: the progressive
  decomposition stacks; the decoder sums the three trends of each layer
  and projects them with a circular k=3 conv (`projection`).

Every layer runs in float32: the JAX package builds this family without
a compute dtype, so `amp` does not reach it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sie_tpu_torch.models.layers import (dense, dropout, gelu, layer_norm,
                                         layer_norm_module, lecun_conv,
                                         lecun_linear)

F32 = torch.float32


def moving_avg(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Trend of x (B, T, C): the mean over a window of kernel_size steps,
    the series' ends repeated (kernel_size - 1) // 2 times."""
    pad = (kernel_size - 1) // 2
    xp = torch.cat([x[:, :1].expand(-1, pad, -1), x,
                    x[:, -1:].expand(-1, pad, -1)], dim=1)
    return xp.unfold(1, kernel_size, 1).sum(-1) / kernel_size


def series_decomp(x: torch.Tensor, kernel_size: int):
    trend = moving_avg(x, kernel_size)
    return x - trend, trend


def series_decomp_multi(x: torch.Tensor, kernel_sizes: Sequence[int]):
    seas, trends = zip(*(series_decomp(x, k) for k in kernel_sizes))
    n = len(kernel_sizes)
    return sum(seas) / n, sum(trends) / n


class SeasonalLayerNorm(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.LayerNorm_0 = layer_norm_module(d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xh = layer_norm(self.LayerNorm_0, x)
        return xh - xh.mean(dim=1, keepdim=True)


def auto_correlation(q, k, v, factor: int, training: bool) -> torch.Tensor:
    """The auto-correlation mechanism on (B, L, H, E) queries, keys and
    values; returns (B, L, H, E) in q's dtype."""
    b, l, h, e = q.shape
    s = v.shape[1]
    if l > s:
        zeros = v.new_zeros(b, l - s, h, e)
        v = torch.cat([v, zeros], dim=1)
        k = torch.cat([k, zeros], dim=1)
    else:
        v, k = v[:, :l], k[:, :l]
    qf = torch.fft.rfft(q.permute(0, 2, 3, 1).float())
    kf = torch.fft.rfft(k.permute(0, 2, 3, 1).float())
    corr = torch.fft.irfft(qf * torch.conj(kf), n=l)         # (B, H, E, L)
    vals = v.permute(0, 2, 3, 1).float()
    top_k = int(factor * math.log(l))
    mean_corr = corr.mean(dim=(1, 2))                         # (B, L)
    if training:
        delay = torch.topk(mean_corr.mean(0), top_k).indices  # (k,)
        weights = mean_corr[:, delay]
        delay = delay.expand(b, top_k)
    else:
        weights, delay = torch.topk(mean_corr, top_k, dim=-1)
    tmp_corr = torch.softmax(weights, dim=-1)                 # (B, k)
    idx = (torch.arange(l, device=q.device)[None, None, :]
           + delay[:, :, None]) % l                           # (B, k, L)
    patt = vals[:, None].expand(b, top_k, h, e, l).gather(
        -1, idx[:, :, None, None, :].expand(b, top_k, h, e, l))
    agg = torch.einsum("bkhel,bk->bhel", patt, tmp_corr)
    return agg.permute(0, 3, 1, 2).to(q.dtype)


class _Projected(nn.Module):
    """query/key/value/out projections (flax's default Dense, float32)."""

    def __init__(self, d_model: int, n_heads: int, g: torch.Generator):
        super().__init__()
        self.n_heads = n_heads
        dk = d_model // n_heads
        self.query = lecun_linear(d_model, dk * n_heads, g)
        self.key = lecun_linear(d_model, dk * n_heads, g)
        self.value = lecun_linear(d_model, dk * n_heads, g)
        self.out = lecun_linear(dk * n_heads, d_model, g)

    def qkv(self, q_in, k_in, v_in):
        split = lambda z, lin: dense(z, lin, F32).unflatten(
            -1, (self.n_heads, -1))                           # (B, L, H, dk)
        return (split(q_in, self.query), split(k_in, self.key),
                split(v_in, self.value))


class AutoCorrelationLayer(_Projected):
    def __init__(self, d_model: int, n_heads: int, g: torch.Generator,
                 factor: int = 1):
        super().__init__(d_model, n_heads, g)
        self.factor = factor

    def forward(self, q_in, k_in, v_in,
                generator: Optional[torch.Generator] = None):
        q, k, v = self.qkv(q_in, k_in, v_in)
        out = auto_correlation(q, k, v, self.factor, self.training)
        return dense(out.flatten(2), self.out, F32)


class SpectralAttentionLayer(_Projected):
    """`mechanism` 'fourier' (FourierBlock self / FourierCrossAttention
    cross) or 'wavelet' (MultiWaveletTransform / MultiWaveletCross), built
    for query length `lq` and key length `lk` (flax builds them at the
    first call; torch needs the shapes here)."""

    def __init__(self, d_model: int, n_heads: int, g: torch.Generator,
                 lq: int, lk: int, mechanism: str = "fourier",
                 cross: bool = False, modes: int = 16, wavelet_k: int = 4):
        super().__init__(d_model, n_heads, g)
        from sie_tpu_torch.models.extra import fourier, multiwavelet
        h = n_heads
        dk = d_model // h
        modes = min(modes, min(lq, lk) // 2)
        ch = h * dk
        if mechanism == "wavelet":
            c = max(ch // wavelet_k, 1)
            self.inner = (multiwavelet.MultiWaveletCross(
                ch, ch, modes, g, c=c, k=wavelet_k, ich=ch) if cross
                else multiwavelet.MultiWaveletTransform(
                    g, ich=ch, k=wavelet_k, alpha=16, c=c, nCZ=1))
        elif cross:
            self.inner = fourier.FourierCrossAttention(
                ch, ch, lq, lk, g, modes=modes, n_heads=h)
        else:
            self.inner = fourier.FourierBlock(ch, ch, lq, g, modes=modes,
                                              n_heads=h)

    def forward(self, q_in, k_in, v_in,
                generator: Optional[torch.Generator] = None):
        q, k, v = self.qkv(q_in, k_in, v_in)
        out = self.inner(q, k, v)
        return dense(out.reshape(q.shape[0], q.shape[1], -1), self.out, F32)


def correlation_layer(attention: str, d_model: int, n_heads: int,
                      factor: int, g: torch.Generator, lq: int, lk: int,
                      cross: bool = False) -> nn.Module:
    """'auto' (Autoformer), 'fourier' or 'wavelet' (FEDformer)."""
    if attention == "auto":
        return AutoCorrelationLayer(d_model, n_heads, g, factor)
    return SpectralAttentionLayer(d_model, n_heads, g, lq, lk,
                                  mechanism=attention, cross=cross)


class AutoformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, g: torch.Generator, seq_len: int,
                 d_ff: int = 0, n_heads: int = 8, moving_avg_kernel: int = 25,
                 dropout: float = 0.1, activation: str = "relu",
                 factor: int = 1, attention: str = "auto"):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.kernel, self.dropout, self.activation = (moving_avg_kernel,
                                                      dropout, activation)
        self.attention = correlation_layer(attention, d_model, n_heads,
                                           factor, g, seq_len, seq_len)
        self.conv1 = lecun_linear(d_model, d_ff, g, bias=False)
        self.conv2 = lecun_linear(d_ff, d_model, g, bias=False)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        drop = lambda z: dropout(z, self.dropout, generator, self.training)
        act = F.relu if self.activation == "relu" else gelu
        x, _ = series_decomp(x + drop(self.attention(x, x, x, generator)),
                             self.kernel)
        y = drop(act(dense(x, self.conv1, F32)))
        y = drop(dense(y, self.conv2, F32))
        res, _ = series_decomp(x + y, self.kernel)
        return res


class AutoformerEncoder(nn.Module):
    def __init__(self, d_model: int, g: torch.Generator, seq_len: int,
                 n_layers: int = 2, **kw):
        super().__init__()
        self.layers = nn.ModuleList(
            AutoformerEncoderLayer(d_model, g, seq_len, **kw)
            for _ in range(n_layers))
        self.norm = SeasonalLayerNorm(d_model)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for layer in self.layers:
            x = layer(x, generator)
        return self.norm(x)


class AutoformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int, c_out: int, g: torch.Generator,
                 dec_len: int, enc_len: int, d_ff: int = 0, n_heads: int = 8,
                 moving_avg_kernel: int = 25, dropout: float = 0.1,
                 activation: str = "relu", factor: int = 1,
                 attention: str = "auto"):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.kernel, self.dropout, self.activation = (moving_avg_kernel,
                                                      dropout, activation)
        self.self_attention = correlation_layer(
            attention, d_model, n_heads, factor, g, dec_len, dec_len)
        self.cross_attention = correlation_layer(
            attention, d_model, n_heads, factor, g, dec_len, enc_len,
            cross=True)
        self.conv1 = lecun_linear(d_model, d_ff, g, bias=False)
        self.conv2 = lecun_linear(d_ff, d_model, g, bias=False)
        self.projection = lecun_conv(nn.Conv1d, d_model, c_out, 3, g,
                                     bias=False)

    def forward(self, x, cross, generator: Optional[torch.Generator] = None):
        drop = lambda z: dropout(z, self.dropout, generator, self.training)
        act = F.relu if self.activation == "relu" else gelu
        x = x + drop(self.self_attention(x, x, x, generator))
        x, trend1 = series_decomp(x, self.kernel)
        x = x + drop(self.cross_attention(x, cross, cross, generator))
        x, trend2 = series_decomp(x, self.kernel)
        y = drop(act(dense(x, self.conv1, F32)))
        y = drop(dense(y, self.conv2, F32))
        x, trend3 = series_decomp(x + y, self.kernel)
        trend = trend1 + trend2 + trend3
        tp = torch.cat([trend[:, -1:], trend, trend[:, :1]], dim=1)
        trend = F.conv1d(tp.transpose(1, 2), self.projection.weight)
        return x, trend.transpose(1, 2)


class AutoformerDecoder(nn.Module):
    def __init__(self, d_model: int, c_out: int, g: torch.Generator,
                 dec_len: int, enc_len: int, n_layers: int = 1,
                 project_out: bool = True, **kw):
        super().__init__()
        self.layers = nn.ModuleList(
            AutoformerDecoderLayer(d_model, c_out, g, dec_len, enc_len, **kw)
            for _ in range(n_layers))
        self.norm = SeasonalLayerNorm(d_model)
        self.projection = lecun_linear(d_model, c_out, g) if project_out \
            else None

    def forward(self, x, cross, trend,
                generator: Optional[torch.Generator] = None):
        for layer in self.layers:
            x, residual_trend = layer(x, cross, generator)
            trend = trend + residual_trend
        x = self.norm(x)
        if self.projection is not None:
            x = dense(x, self.projection, F32)
        return x, trend
