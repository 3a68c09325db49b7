"""TimesNet classifier (counterpart of the `TimesNet` class of
sie_tpu/models/timesnet.py, reference model/TimesNet.py).

The reference folds the sequence into a (rows, period) image for each of
the top-k FFT periods and runs a 2D Inception conv on it; the fold's shape
depends on the data. The JAX package keeps every shape static by the
identity that a KxK conv on the fold is, in sequence coordinates, a sum of
shifted pointwise products:

    y[t] = sum_{dr,dc} W[dr,dc] @ x[t + dr*p + dc]

masked where the column (t mod p) + dc leaves [0, p) or the source leaves
the zero-padded canvas [0, ceil(T/p)*p), on a canvas of static length 2T.
This module computes the same arithmetic. The period `p` stays a device
tensor: the shift by dr*p is a gather whose index is built on the device,
so no value crosses to the host and the train step can be captured as a
CUDA graph. There is no Pallas kernel here in the JAX package (XLA runs the
gathers and products), and none here: the products are `torch.matmul`.

The task branches (`TimesNetForecaster`, `TimesNetImputer`,
`TimesNetAnomalyDetector`) normalise each series with statistics that
carry no gradient (`ns_norm`; `masked_ns_norm` over the observed points
of an imputation mask), run the same blocks and de-normalise a
per-step projection; the forecaster first maps the embedded sequence to
seq_len + pred_len steps (`predict_linear`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sie_tpu_torch.config import Config
from sie_tpu_torch.models.layers import (DataEmbedding, dense, dropout, gelu,
                                         layer_norm, layer_norm_module,
                                         linear, normal_)


def _inception_taps(num_kernels: int) -> np.ndarray:
    """Static (tap -> kernel_index, dr, dc) table for Inception_Block_V1
    (reference layers/Conv_Blocks.py:5-30: odd kernels 1,3,...,2K-1, padding to
    'same')."""
    rows = []
    for ki in range(num_kernels):
        j = ki  # half-width of kernel 2*ki+1
        for dr in range(-j, j + 1):
            for dc in range(-j, j + 1):
                rows.append((ki, dr, dc))
    return np.asarray(rows, dtype=np.int32)


class InceptionConvSeq(nn.Module):
    """Inception_Block_V1 on the period fold, in sequence coordinates.

    Parameters as the JAX module's: `tap_weights` (n_taps, C_in, C_out),
    one matrix per tap of `_inception_taps` (kaiming normal, fan_out, as
    the reference Conv2d), and `bias` (num_kernels, C_out), zeros.

    forward(x (B, T2, C_in), period, canvas_len) -> (B, T2, C_out) f32, the
    mean over the num_kernels branches; `period` and `canvas_len` (=
    ceil(T/p)*p) are 0-d int64 tensors on x's device. By linearity the
    branches collapse into one (2K-1)x(2K-1) table `w_eff`, summed in the
    compute dtype branch by branch (the order of `jax.ops.segment_sum`
    over the tap table); each row offset dr is one gather by dr*p and
    2K-1 static column shifts, masked, then one product with f32
    accumulation into an f32 accumulator. The row's work is recomputed in
    the backward pass (the JAX module's `jax.checkpoint`): it draws no
    random numbers, so the recompute is exact."""

    def __init__(self, c_in: int, c_out: int, num_kernels: int,
                 dtype: torch.dtype, g: torch.Generator):
        super().__init__()
        self.c_in, self.c_out = c_in, c_out
        self.num_kernels = num_kernels
        self.dtype = dtype
        n_taps = len(_inception_taps(num_kernels))
        self.tap_weights = nn.Parameter(torch.empty(n_taps, c_in, c_out))
        normal_(self.tap_weights, math.sqrt(2.0 / (c_out * n_taps)), g)
        self.bias = nn.Parameter(torch.zeros(num_kernels, c_out))

    def collapsed(self) -> torch.Tensor:
        """w_eff (2K-1, 2K-1, C_in, C_out) in the compute dtype: branch ki's
        (2ki+1)^2 taps added, in branch order, at the centre of the grid."""
        j = self.num_kernels - 1
        w = self.tap_weights.to(self.dtype)
        acc, start = None, 0
        for ki in range(self.num_kernels):
            n = 2 * ki + 1
            wk = w[start:start + n * n].reshape(n, n, self.c_in, self.c_out)
            start += n * n
            wk = F.pad(wk, (0, 0, 0, 0, j - ki, j - ki, j - ki, j - ki))
            acc = wk if acc is None else acc + wk
        return acc

    def _row(self, x: torch.Tensor, w_row: torch.Tensor, dr: int,
             period: torch.Tensor, canvas_len: torch.Tensor) -> torch.Tensor:
        """Row offset dr's contribution (B, T2, C_out) f32."""
        j = self.num_kernels - 1
        t2 = x.shape[1]
        pos = torch.arange(t2, device=x.device)
        col = torch.remainder(pos, period)
        shift = dr * period
        x_dr = x.index_select(1, torch.remainder(pos + shift, t2))
        in_canvas = pos < canvas_len
        cols = []
        for dc in range(-j, j + 1):
            shifted = torch.roll(x_dr, -dc, dims=1)
            src = pos + shift + dc
            valid = ((col + dc >= 0) & (col + dc < period) & (src >= 0)
                     & (src < canvas_len) & in_canvas)
            cols.append(shifted * valid[None, :, None].to(x.dtype))
        xg = torch.stack(cols, dim=2)                      # (B, T2, G, C_in)
        b = x.shape[0]
        # the products of compute-dtype operands, accumulated in f32
        return torch.matmul(xg.reshape(b * t2, -1).float(),
                            w_row.reshape(-1, self.c_out).float()
                            ).view(b, t2, self.c_out)

    def forward(self, x: torch.Tensor, period: torch.Tensor,
                canvas_len: torch.Tensor,
                w_eff: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`w_eff`, when given, is `collapsed()`: a block computes it once
        for its top-k slots."""
        j = self.num_kernels - 1
        w_eff = self.collapsed() if w_eff is None else w_eff
        xdt = x.to(self.dtype)
        acc = torch.zeros((x.shape[0], x.shape[1], self.c_out),
                          dtype=torch.float32, device=x.device)
        for i, dr in enumerate(range(-j, j + 1)):
            if torch.is_grad_enabled():
                contrib = checkpoint(self._row, xdt, w_eff[i], dr, period,
                                     canvas_len, use_reentrant=False,
                                     preserve_rng_state=False)
            else:
                contrib = self._row(xdt, w_eff[i], dr, period, canvas_len)
            acc = acc + contrib
        return acc / self.num_kernels + self.bias.mean(dim=0)[None, None, :]


def fft_periods(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k dominant periods from the batch-mean FFT amplitude (reference
    TimesNet.py:9-18). x (B, T, C) -> (periods (k,) int64, weight (B, k)
    f32), both on x's device. Equal amplitudes go to the lower frequency
    first, as `lax.top_k` orders them: a stable descending sort (torch.topk
    does not promise an order among equals)."""
    xf = torch.fft.rfft(x.float(), dim=1)
    amp = xf.abs()
    strength = amp.mean(dim=0).mean(dim=-1)
    strength = torch.cat([strength.new_zeros(1), strength[1:]])
    top = torch.sort(strength, descending=True, stable=True).indices[:k]
    top = torch.clamp(top, min=1)
    periods = torch.div(x.shape[1], top, rounding_mode="floor")
    weight = amp.mean(dim=-1)[:, top]
    return periods, weight


class TimesBlock(nn.Module):
    """The top-k period slots: per slot conv1, gelu, conv2 on the 2T
    canvas (parameters shared by the slots), then the slots mixed by the
    softmax of their FFT weights, plus the input."""

    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        self.top_k = cfg.top_k
        dt = cfg.compute_dtype
        self.conv1 = InceptionConvSeq(cfg.d_model, cfg.d_ff, cfg.num_kernels,
                                      dt, g)
        self.conv2 = InceptionConvSeq(cfg.d_ff, cfg.d_model, cfg.num_kernels,
                                      dt, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        periods, weight = fft_periods(x, self.top_k)
        canvas = torch.cat([x, torch.zeros_like(x)], dim=1)   # (B, 2T, C)
        w1, w2 = self.conv1.collapsed(), self.conv2.collapsed()
        outs = []
        for i in range(self.top_k):
            p = periods[i]
            canvas_len = torch.div(t + p - 1, p, rounding_mode="floor") * p
            h = gelu(self.conv1(canvas, p, canvas_len, w1))
            h = self.conv2(h, p, canvas_len, w2)
            outs.append(h[:, :t, :])
        res = torch.stack(outs, dim=0)                        # (k, B, T, C)
        w = torch.softmax(weight, dim=1)                      # (B, k)
        agg = (res * w.t()[:, :, None, None]).sum(dim=0)
        return agg + x


class _TimesBase(nn.Module):
    """The embedding `enc_embedding` and e_layers TimesBlocks (`block_<i>`)
    with ONE LayerNorm (`layer_norm`) applied after every block
    (reference model/TimesNet.py:83-88,118-122); `_blocks` builds the
    blocks and the norm in the JAX module's order of scopes."""

    def _embed(self, cfg: Config, g: torch.Generator, mark_width: int = 0):
        self.cfg = cfg
        self.enc_embedding = DataEmbedding(cfg.enc_in, cfg.d_model,
                                           cfg.compute_dtype, g,
                                           dropout=cfg.dropout,
                                           mark_width=mark_width)

    def _blocks(self, cfg: Config, g: torch.Generator):
        self.n_blocks = cfg.e_layers
        for i in range(cfg.e_layers):
            setattr(self, f"block_{i}", TimesBlock(cfg, g))
        self.layer_norm = layer_norm_module(cfg.d_model)

    def _times_blocks(self, h: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_blocks):
            h = layer_norm(self.layer_norm, getattr(self, f"block_{i}")(h))
        return h


class TimesNet(_TimesBase):
    """DataEmbedding, the blocks, tanh-gelu, dropout, the padding mask,
    flatten, `projection`."""

    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        self._embed(cfg, g)
        self._blocks(cfg, g)
        self.projection = linear(cfg.seq_len * cfg.d_model, cfg.num_class, g)

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        h = self._times_blocks(self.enc_embedding(x.to(dt), generator))
        h = dropout(gelu(h), self.cfg.dropout, generator, self.training)
        if padding_mask is not None:
            h = h * padding_mask.to(h.dtype)[..., None]
        h = h.reshape(h.shape[0], -1)
        return dense(h, self.projection, dt).float()


def ns_norm(x: torch.Tensor):
    """Non-stationary normalisation with statistics that carry no gradient
    (reference model/TimesNet.py:109-115): (normalised, mean, std), the
    statistics (B, 1, C), std from the biased variance + 1e-5."""
    mean = x.mean(dim=1, keepdim=True).detach()
    xc = x - mean
    std = torch.sqrt(xc.var(dim=1, keepdim=True, unbiased=False)
                     + 1e-5).detach()
    return xc / std, mean, std


def masked_ns_norm(x: torch.Tensor, mask: torch.Tensor):
    """The imputation branch's normalisation over the observed points only
    (reference model/TimesNet.py:137-146): masked points count in neither
    the mean's nor the variance's denominator and are zero after
    centring; statistics without gradient, as in `ns_norm`."""
    denom = (mask == 1).sum(dim=1)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    mean = (torch.where(mask == 0, zero, x).sum(dim=1) / denom
            ).detach()[:, None, :]
    xc = torch.where(mask == 0, zero, x - mean)
    std = torch.sqrt((xc * xc).sum(dim=1) / denom + 1e-5
                     ).detach()[:, None, :]
    return xc / std, mean, std


class TimesNetForecaster(_TimesBase):
    """forward(x_enc (B, seq_len, C), x_mark_enc) -> (B, pred_len, c_out)
    f32: ns_norm, embed, `predict_linear` over time to seq_len +
    pred_len, the blocks, `projection`, de-normalise, the last pred_len
    steps (reference model/TimesNet.py:107-133)."""

    def __init__(self, cfg: Config, g: torch.Generator, mark_width: int = 0):
        super().__init__()
        self._embed(cfg, g, mark_width)
        self.predict_linear = linear(cfg.seq_len, cfg.seq_len + cfg.pred_len,
                                     g)
        self._blocks(cfg, g)
        self.projection = linear(cfg.d_model, cfg.c_out, g)

    def forward(self, x_enc, x_mark_enc=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        xz, mean, std = ns_norm(x_enc)
        h = self.enc_embedding(xz.to(dt), generator, x_mark_enc)
        h = dense(h.transpose(1, 2), self.predict_linear, dt).transpose(1, 2)
        h = self._times_blocks(h)
        out = dense(h, self.projection, dt).float() * std + mean
        return out[:, -self.cfg.pred_len:, :]


class TimesNetImputer(_TimesBase):
    """forward(x_enc (B, T, C), x_mark_enc, mask (1 = observed)) -> (B, T,
    c_out) f32: masked_ns_norm, embed, the blocks, `projection`,
    de-normalise (reference model/TimesNet.py:135-160)."""

    def __init__(self, cfg: Config, g: torch.Generator, mark_width: int = 0):
        super().__init__()
        self._embed(cfg, g, mark_width)
        self._blocks(cfg, g)
        self.projection = linear(cfg.d_model, cfg.c_out, g)

    def forward(self, x_enc, x_mark_enc=None, mask=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        if mask is None:
            mask = torch.ones_like(x_enc)
        xz, mean, std = masked_ns_norm(x_enc, mask)
        h = self._times_blocks(self.enc_embedding(xz.to(dt), generator,
                                                  x_mark_enc))
        return dense(h, self.projection, dt).float() * std + mean


class TimesNetAnomalyDetector(_TimesBase):
    """forward(x_enc (B, T, C)) -> (B, T, c_out) f32: the imputer's network
    with `ns_norm` and no time marks (reference model/TimesNet.py:162-183)."""

    def __init__(self, cfg: Config, g: torch.Generator, mark_width: int = 0):
        super().__init__()
        self._embed(cfg, g)
        self._blocks(cfg, g)
        self.projection = linear(cfg.d_model, cfg.c_out, g)

    def forward(self, x_enc,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        xz, mean, std = ns_norm(x_enc)
        h = self._times_blocks(self.enc_embedding(xz.to(dt), generator))
        return dense(h, self.projection, dt).float() * std + mean
