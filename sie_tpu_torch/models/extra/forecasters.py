"""The five forecasters of the extra families (counterpart of
sie_tpu/models/extra/forecasters.py), train/tasks.py's forecast table
entries. forward(x_enc (B, seq_len, C), x_mark_enc, x_dec, x_mark_dec)
-> (B, pred_len, c_out) float32, TSlib's window protocol; `mark_width`
is the temporal embedding's width (0: no time marks).

- `AutoformerForecaster` (FEDformer with attention 'fourier'): the
  look-back decomposed; the decoder starts from the label_len seasonal
  context + zeros and the trend context + the look-back mean, and its
  progressive decomposition accumulates the trend; forecast = seasonal +
  trend over the horizon. x_dec's values are not read, its marks are.
- `ETSformerForecaster`: level + damped growth + extrapolated season.
- `PyraformerForecaster`: the pyramid's features at the last base
  position projected to the whole horizon at once.
- `CrossformerForecaster`: segment-wise embedding, the two-stage attention
  encoder, and a decoder from learned segment queries
  (`dec_pos_embedding`) summing per-layer segment predictions.

Float32 throughout, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.models.extra.autoformer import (AutoformerDecoder,
                                                   AutoformerEncoder,
                                                   series_decomp)
from sie_tpu_torch.models.extra.backbones import (CrossformerScales,
                                                  embed_scales, ets_layers,
                                                  pyramid_window)
from sie_tpu_torch.models.extra.crossformer import CrossformerDecoder
from sie_tpu_torch.models.extra.etsformer import ETSDecoder, ETSEncoder
from sie_tpu_torch.models.extra.pyraformer import (PyraformerEncoder,
                                                   pyramid_sizes)
from sie_tpu_torch.models.layers import (DataEmbedding, dense, lecun_linear,
                                         normal_param)

F32 = torch.float32


class AutoformerForecaster(nn.Module):
    """`attention` overrides the class's ('wavelet': FEDformer's
    multiwavelet blocks)."""

    attention = "auto"

    def __init__(self, cfg: Config, g: torch.Generator, mark_width: int = 0,
                 attention: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        attention = attention or self.attention
        emb = lambda c_in: DataEmbedding(c_in, cfg.d_model, F32, g,
                                         dropout=cfg.dropout,
                                         mark_width=mark_width,
                                         positional=False)
        kw = dict(d_ff=cfg.d_ff, n_heads=cfg.n_heads,
                  moving_avg_kernel=cfg.moving_avg, dropout=cfg.dropout,
                  activation=cfg.activation, factor=cfg.factor,
                  attention=attention)
        self.enc_embedding = emb(cfg.enc_in)
        self.encoder = AutoformerEncoder(cfg.d_model, g, cfg.seq_len,
                                         n_layers=cfg.e_layers, **kw)
        self.dec_embedding = emb(cfg.enc_in)
        self.decoder = AutoformerDecoder(
            cfg.d_model, cfg.c_out, g, cfg.label_len + cfg.pred_len,
            cfg.seq_len, n_layers=max(cfg.d_layers, 1), **kw)

    def forward(self, x_enc, x_mark_enc=None, x_dec=None, x_mark_dec=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        x_enc = x_enc.float()
        b, _, c = x_enc.shape
        seasonal, trend = series_decomp(x_enc, cfg.moving_avg)
        lab = cfg.label_len
        mean = x_enc.mean(dim=1, keepdim=True).expand(b, cfg.pred_len, c)
        trend_init = torch.cat([trend[:, x_enc.shape[1] - lab:], mean], 1)
        seasonal_init = torch.cat([seasonal[:, x_enc.shape[1] - lab:],
                                   x_enc.new_zeros(b, cfg.pred_len, c)], 1)
        enc = self.encoder(self.enc_embedding(x_enc, generator, x_mark_enc),
                           generator)
        dec = self.dec_embedding(seasonal_init, generator, x_mark_dec)
        seasonal_part, trend_part = self.decoder(dec, enc, trend_init,
                                                 generator)
        return (seasonal_part + trend_part)[:, -cfg.pred_len:].float()


class FEDformerForecaster(AutoformerForecaster):
    attention = "fourier"


class ETSformerForecaster(nn.Module):
    def __init__(self, cfg: Config, g: torch.Generator, mark_width: int = 0):
        super().__init__()
        self.enc_embedding = DataEmbedding(cfg.enc_in, cfg.d_model, F32, g,
                                           dropout=cfg.dropout,
                                           mark_width=mark_width)
        self.encoder = ETSEncoder(ets_layers(cfg, cfg.pred_len), g)
        self.decoder = ETSDecoder(cfg.d_model, cfg.n_heads, cfg.c_out,
                                  cfg.pred_len, g, n_layers=cfg.e_layers,
                                  dropout=cfg.dropout)

    def forward(self, x_enc, x_mark_enc=None, x_dec=None, x_mark_dec=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x_enc = x_enc.float()
        res = self.enc_embedding(x_enc, generator, x_mark_enc)
        level, growths, seasons = self.encoder(res, x_enc, generator)
        growth, season = self.decoder(growths, seasons, generator)
        return (level[:, -1:] + growth + season).float()


class PyraformerForecaster(nn.Module):
    def __init__(self, cfg: Config, g: torch.Generator, mark_width: int = 0,
                 inner_size: int = 5):
        super().__init__()
        self.cfg = cfg
        window = pyramid_window(cfg.seq_len)
        self.encoder = PyraformerEncoder(
            cfg.seq_len, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.enc_in, g,
            e_layers=cfg.e_layers, window_size=window,
            inner_size=inner_size, dropout=cfg.dropout,
            mark_width=mark_width)
        n_scales = len(pyramid_sizes(cfg.seq_len, window))
        self.projection = lecun_linear(n_scales * cfg.d_model,
                                       cfg.pred_len * cfg.c_out, g)

    def forward(self, x_enc, x_mark_enc=None, x_dec=None, x_mark_dec=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        enc = self.encoder(x_enc.float(), x_mark_enc, generator)
        out = dense(enc[:, -1], self.projection, F32)
        return out.reshape(x_enc.shape[0], self.cfg.pred_len,
                           self.cfg.c_out).float()


class CrossformerForecaster(nn.Module):
    """The JAX class's scopes sit at its top level (`value_embedding`,
    `enc_pos_embedding`, `pre_norm`, `encoder`), so this one holds
    `CrossformerScales`' modules under those names."""

    def __init__(self, cfg: Config, g: torch.Generator, mark_width: int = 0):
        super().__init__()
        self.cfg = cfg
        scales = CrossformerScales(cfg, g)
        self.seg_len, self.in_seg, self.pad = (scales.seg_len, scales.in_seg,
                                               scales.pad)
        self.value_embedding = scales.value_embedding
        self.enc_pos_embedding = scales.enc_pos_embedding
        self.pre_norm = scales.pre_norm
        self.encoder = scales.encoder
        self.dropout = cfg.dropout
        self.pred_seg = -(-cfg.pred_len // self.seg_len)
        self.dec_pos_embedding = normal_param(
            (1, cfg.enc_in, self.pred_seg, cfg.d_model), 0.02, g)
        layer = dict(seg_len=self.seg_len, d_model=cfg.d_model,
                     n_heads=cfg.n_heads, d_ff=cfg.d_ff, dropout=cfg.dropout,
                     seg_num=self.pred_seg, factor=max(cfg.factor, 1))
        self.decoder = CrossformerDecoder(
            (layer,) * (max(cfg.e_layers, 1) + 1), g)

    def forward(self, x_enc, x_mark_enc=None, x_dec=None, x_mark_dec=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        scales = embed_scales(self, x_enc.float(), generator)
        b = x_enc.shape[0]
        dec_in = self.dec_pos_embedding.expand(b, -1, -1, -1)
        out = self.decoder(dec_in, scales, generator)
        return out[:, :self.cfg.pred_len].float()
