"""Classification, imputation and anomaly backbones of the Autoformer,
FEDformer, ETSformer, Pyraformer and Crossformer families (counterpart of
sie_tpu/models/extra/backbones.py): the DNN types `--dnn_type` names,
standalone and as InterpGN's deep expert, and `make_dense_task`'s
imputation and anomaly heads.

Each family maps (B, T, enc_in) to per-step features (`rep`):
- Autoformer / FEDformer: the embedding without position table, then the
  decomposition encoder ('auto' or 'fourier' attention): (B, T, d_model);
- ETSformer: the sum over layers of the growth and season components,
  the encoder run with pred_len 1 (its level input is x, so the config's
  c_out must equal enc_in, as in the JAX package);
- Pyraformer: the pyramid encoder's gather, (B, T, 3 * d_model), windows
  (4, 4) from T = 32 up, else (2, 2);
- Crossformer (`scales`): the segment-wise embedding (segments of 12,
  front-padded with the first value; `value_embedding`,
  `enc_pos_embedding` N(0, 0.02^2), `pre_norm`) and the two-stage
  attention hierarchy, every scale (B, D, seg_i, d_model).

The classification head (`head`) is the reference's: tanh-gelu, dropout,
the padding mask on a (B, T, F) representation, flatten, `projection` to
the classes, float32. The dense heads project each step (`projection` to
c_out; Crossformer projects each finest-scale segment back to its steps
first, `seg_projection`). Every layer runs in float32, under amp too, as
in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.models.extra.autoformer import AutoformerEncoder
from sie_tpu_torch.models.extra.crossformer import CrossformerEncoder
from sie_tpu_torch.models.extra.etsformer import ETSEncoder
from sie_tpu_torch.models.extra.pyraformer import (PyraformerEncoder,
                                                   pyramid_sizes)
from sie_tpu_torch.models.layers import (DataEmbedding, dense, dropout, gelu,
                                         layer_norm, layer_norm_module,
                                         lecun_linear, normal_param)

F32 = torch.float32


def pyramid_window(t: int) -> tuple:
    """Pyraformer's coarsening per level: shallow for short look-backs so
    every scale keeps >= 2 nodes."""
    return (4, 4) if t >= 32 else (2, 2)


class ClsHead(nn.Module):
    """The JAX package's `_ClsHead` over `in_features` flattened features."""

    def __init__(self, in_features: int, num_class: int, dropout: float,
                 g: torch.Generator):
        super().__init__()
        self.dropout = dropout
        self.projection = lecun_linear(in_features, num_class, g)

    def forward(self, h, padding_mask=None,
                generator: Optional[torch.Generator] = None):
        h = dropout(gelu(h), self.dropout, generator, self.training)
        if padding_mask is not None and h.ndim == 3 \
                and padding_mask.shape[1] == h.shape[1]:
            h = h * padding_mask.to(h.dtype)[..., None]
        return dense(h.reshape(h.shape[0], -1), self.projection, F32).float()


# ---------------------------------------------------------------- reps
class AutoformerRep(nn.Module):
    def __init__(self, cfg: Config, g: torch.Generator,
                 attention: str = "auto"):
        super().__init__()
        self.enc_embedding = DataEmbedding(cfg.enc_in, cfg.d_model, F32, g,
                                           dropout=cfg.dropout,
                                           positional=False)
        self.encoder = AutoformerEncoder(
            cfg.d_model, g, cfg.seq_len, n_layers=cfg.e_layers,
            d_ff=cfg.d_ff, n_heads=cfg.n_heads,
            moving_avg_kernel=cfg.moving_avg, dropout=cfg.dropout,
            activation=cfg.activation, factor=cfg.factor,
            attention=attention)
        self.features = cfg.d_model

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.encoder(self.enc_embedding(x, generator), generator)


def ets_layers(cfg: Config, pred_len: int) -> tuple:
    """The ETSEncoderLayers' kwargs, one dict a layer."""
    kw = dict(d_model=cfg.d_model, nhead=cfg.n_heads, c_out=cfg.c_out,
              pred_len=pred_len, k=max(cfg.top_k, 1),
              dim_feedforward=cfg.d_ff, dropout=cfg.dropout)
    return (kw,) * cfg.e_layers


class ETSformerRep(nn.Module):
    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        self.enc_embedding = DataEmbedding(cfg.enc_in, cfg.d_model, F32, g,
                                           dropout=cfg.dropout)
        self.encoder = ETSEncoder(ets_layers(cfg, 1), g)
        self.features = cfg.d_model

    def forward(self, x, generator: Optional[torch.Generator] = None):
        t = x.shape[1]
        res = self.enc_embedding(x, generator)
        _, growths, seasons = self.encoder(res, x, generator)
        # growth (B, T+1, D): index 0 the initial state; season (B, T+1,
        # D): the last step the extrapolated horizon
        return sum(gr[:, 1: t + 1] for gr in growths) \
            + sum(s[:, :t] for s in seasons)


class PyraformerRep(nn.Module):
    def __init__(self, cfg: Config, g: torch.Generator, inner_size: int = 5):
        super().__init__()
        window = pyramid_window(cfg.seq_len)
        self.encoder = PyraformerEncoder(
            cfg.seq_len, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.enc_in, g,
            e_layers=cfg.e_layers, window_size=window,
            inner_size=inner_size, dropout=cfg.dropout)
        self.features = len(pyramid_sizes(cfg.seq_len, window)) * cfg.d_model

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.encoder(x, None, generator)


def crossformer_blocks(cfg: Config, in_seg: int) -> tuple:
    """The scale blocks' kwargs: the first keeps in_seg segments, each
    later one merges pairs (ceil)."""
    blocks, seg = [], in_seg
    for i in range(max(cfg.e_layers, 1)):
        if i > 0:
            seg = -(-seg // 2)
        blocks.append(dict(win_size=1 if i == 0 else 2, d_model=cfg.d_model,
                           n_heads=cfg.n_heads, d_ff=cfg.d_ff, depth=1,
                           dropout=cfg.dropout, seg_num=seg,
                           factor=max(cfg.factor, 1)))
    return tuple(blocks)


class CrossformerScales(nn.Module):
    """The DSW embedding and the hierarchical encoder; forward returns
    (scales, front pad in steps)."""

    def __init__(self, cfg: Config, g: torch.Generator, seg_len: int = 12):
        super().__init__()
        t, d = cfg.seq_len, cfg.enc_in
        self.seg_len = min(seg_len, t)
        self.in_seg = -(-t // self.seg_len)
        self.pad = self.in_seg * self.seg_len - t
        self.dropout = cfg.dropout
        self.value_embedding = lecun_linear(self.seg_len, cfg.d_model, g)
        self.enc_pos_embedding = normal_param(
            (1, d, self.in_seg, cfg.d_model), 0.02, g)
        self.pre_norm = layer_norm_module(cfg.d_model)
        self.blocks = crossformer_blocks(cfg, self.in_seg)
        self.encoder = CrossformerEncoder(self.blocks, g)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return embed_scales(self, x, generator), self.pad


def embed_scales(m: nn.Module, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> list:
    """The scales of x (B, T, D) through module m's `value_embedding`,
    `enc_pos_embedding`, `pre_norm` and `encoder` (CrossformerScales, or
    the forecaster, which holds them at its top level as the JAX one)."""
    b, t, d = x.shape
    if m.pad:
        x = torch.cat([x[:, :1].expand(b, m.pad, d), x], dim=1)
    xseg = x.transpose(1, 2).reshape(b, d, m.in_seg, m.seg_len)
    xemb = dense(xseg, m.value_embedding, F32) + m.enc_pos_embedding
    xemb = dropout(xemb, m.dropout, generator, m.training)
    return m.encoder(layer_norm(m.pre_norm, xemb), generator)


# ---------------------------------------------------------- classifiers
class _RepClassifier(nn.Module):
    def __init__(self, cfg: Config, g: torch.Generator, rep: nn.Module):
        super().__init__()
        self.rep = rep
        self.head = ClsHead(cfg.seq_len * rep.features, cfg.num_class,
                            cfg.dropout, g)

    def forward(self, x, padding_mask=None,
                generator: Optional[torch.Generator] = None):
        return self.head(self.rep(x, generator), padding_mask, generator)


class AutoformerBackbone(_RepClassifier):
    attention = "auto"

    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__(cfg, g, AutoformerRep(cfg, g, self.attention))


class FEDformerBackbone(AutoformerBackbone):
    attention = "fourier"


class ETSformerBackbone(_RepClassifier):
    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__(cfg, g, ETSformerRep(cfg, g))


class PyraformerBackbone(_RepClassifier):
    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__(cfg, g, PyraformerRep(cfg, g))


class CrossformerBackbone(nn.Module):
    """The padding mask multiplies the input (no time axis survives the
    segmentation); the head flattens the coarsest scale."""

    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        self.scales = CrossformerScales(cfg, g)
        last = self.scales.blocks[-1]["seg_num"]
        self.head = ClsHead(cfg.enc_in * last * cfg.d_model, cfg.num_class,
                            cfg.dropout, g)

    def forward(self, x, padding_mask=None,
                generator: Optional[torch.Generator] = None):
        if padding_mask is not None:
            x = x * padding_mask.to(x.dtype)[..., None]
        scales, _ = self.scales(x, generator)
        return self.head(scales[-1], None, generator)


BACKBONES = {"Autoformer": AutoformerBackbone,
             "FEDformer": FEDformerBackbone,
             "ETSformer": ETSformerBackbone,
             "Pyraformer": PyraformerBackbone,
             "Crossformer": CrossformerBackbone}


# --------------------------------------------------------- dense tasks
class DenseTaskModel(nn.Module):
    """A family's representation + a per-step `projection` to c_out.
    forward(x_enc, x_mark_enc=None, mask=None) ignores the marks and the
    mask, as the JAX package's (and the reference Transformer's
    imputation branch) do."""

    def __init__(self, cfg: Config, g: torch.Generator, rep: nn.Module):
        super().__init__()
        self.rep = rep
        self.projection = lecun_linear(rep.features, cfg.c_out, g)

    def forward(self, x_enc, x_mark_enc=None, mask=None,
                generator: Optional[torch.Generator] = None):
        h = self.rep(x_enc.float(), generator)
        return dense(h, self.projection, F32).float()


class CrossformerDenseTask(nn.Module):
    """Each finest-scale segment cell projected back to its seg_len steps
    (`seg_projection`), (B, T, D), then `projection` to c_out."""

    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        self.scales = CrossformerScales(cfg, g)
        self.seg_projection = lecun_linear(cfg.d_model, self.scales.seg_len,
                                           g)
        self.projection = lecun_linear(cfg.enc_in, cfg.c_out, g)

    def forward(self, x_enc, x_mark_enc=None, mask=None,
                generator: Optional[torch.Generator] = None):
        b, _, d = x_enc.shape
        scales, pad = self.scales(x_enc.float(), generator)
        fine = scales[1] if len(scales) > 1 else scales[0]
        vals = dense(fine, self.seg_projection, F32)
        vals = vals.reshape(b, d, -1).transpose(1, 2)[:, pad:]
        return dense(vals, self.projection, F32).float()


_REPS = {"Autoformer": lambda cfg, g: AutoformerRep(cfg, g),
         "FEDformer": lambda cfg, g: AutoformerRep(cfg, g, "fourier"),
         "ETSformer": ETSformerRep,
         "Pyraformer": PyraformerRep}


def make_dense_task(family: str):
    """A function (cfg, g, mark_width=0) -> family's imputer / anomaly
    detector (the marks are not read, so their width is ignored)."""
    if family == "Crossformer":
        return lambda cfg, g, mark_width=0: CrossformerDenseTask(cfg, g)
    rep = _REPS[family]
    return lambda cfg, g, mark_width=0: DenseTaskModel(cfg, g, rep(cfg, g))
