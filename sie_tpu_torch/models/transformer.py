"""Vanilla Transformer (counterpart of sie_tpu/models/transformer.py).

- `Transformer`, the classifier: DataEmbedding -> Encoder stack -> gelu
  -> dropout -> multiply by the padding mask -> flatten (B, T*d_model)
  -> linear head.
- `TransformerForecaster`: encoder-decoder; the decoder reads the
  label_len context plus a zero horizon (TSlib's protocol) through its
  causal self-attention and cross-attention, and the last pred_len steps
  are the forecast.
- `TransformerImputer`: encoder + per-step projection; the anomaly
  detector is the same network called without time marks.

The classifier's encoder takes the config's `attention_variant` and
`moe_*` (models/layers.py `EncoderLayer`); a MoE encoder's training
losses go to the `aux` list `forward` takes. The encoder's full attention
takes kernels K5/K6 at `seq_len` >= the config's
`fused_attention_min_len` (256), as in the JAX package; the decoder's
attentions always take the plain branch. `mark_width` is the width of
the temporal embedding (layers.mark_width; 0 = no time marks).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.models.layers import (DataEmbedding, Decoder, Encoder,
                                         dense, dropout, gelu, linear)


def _embedding(cfg: Config, c_in: int, g: torch.Generator,
               mark_width: int = 0) -> DataEmbedding:
    return DataEmbedding(c_in, cfg.d_model, cfg.compute_dtype, g,
                         dropout=cfg.dropout, mark_width=mark_width)


def _encoder(cfg: Config, g: torch.Generator, **kw) -> Encoder:
    return Encoder(
        cfg.e_layers, cfg.d_model, d_ff=cfg.d_ff, n_heads=cfg.n_heads,
        dtype=cfg.compute_dtype, g=g, activation=cfg.activation,
        use_fused=cfg.use_fused_attention,
        fused_max_len=cfg.fused_attention_max_len,
        fused_min_len=cfg.fused_attention_min_len, dropout=cfg.dropout,
        **kw)


class Transformer(nn.Module):
    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.enc_embedding = _embedding(cfg, cfg.enc_in, g)
        self.encoder = _encoder(cfg, g, use_flash=cfg.use_flash_attention,
                                variant=cfg.attention_variant,
                                moe_experts=cfg.moe_experts,
                                moe_capacity_factor=cfg.moe_capacity_factor,
                                moe_top_k=cfg.moe_top_k,
                                moe_aux_weight=cfg.moe_aux_weight)
        self.projection = linear(cfg.seq_len * cfg.d_model, cfg.num_class, g)
        self.sows_losses = cfg.moe_experts > 0

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                aux: Optional[list] = None) -> torch.Tensor:
        """`aux`, a list, collects the MoE layers' training losses."""
        dt = self.cfg.compute_dtype
        h = self.encoder(self.enc_embedding(x.to(dt), generator), generator,
                         aux)
        h = dropout(gelu(h), self.cfg.dropout, generator, self.training)
        if padding_mask is not None:
            h = h * padding_mask.to(h.dtype)[..., None]
        h = h.reshape(h.shape[0], -1)
        return dense(h, self.projection, dt).float()


class TransformerForecaster(nn.Module):
    """forward(x_enc (B, seq_len, C), x_mark_enc, x_dec (B, label_len +
    pred_len, C), x_mark_dec) -> (B, pred_len, c_out) f32."""

    def __init__(self, cfg: Config, g: torch.Generator, mark_width: int = 0):
        super().__init__()
        self.cfg = cfg
        self.enc_embedding = _embedding(cfg, cfg.enc_in, g, mark_width)
        self.encoder = _encoder(cfg, g)
        self.dec_embedding = _embedding(cfg, cfg.dec_in, g, mark_width)
        self.decoder = Decoder(cfg.d_layers, cfg.d_model, cfg.c_out,
                               cfg.compute_dtype, g, d_ff=cfg.d_ff,
                               n_heads=cfg.n_heads,
                               activation=cfg.activation,
                               dropout=cfg.dropout)

    def forward(self, x_enc, x_mark_enc=None, x_dec=None, x_mark_dec=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        enc = self.encoder(self.enc_embedding(x_enc.to(dt), generator,
                                              x_mark_enc), generator)
        dec = self.dec_embedding(x_dec.to(dt), generator, x_mark_dec)
        out = self.decoder(dec, enc, generator)
        return out[:, -self.cfg.pred_len:, :].float()


class TransformerImputer(nn.Module):
    """forward(x_enc (B, T, C), x_mark_enc=None) -> (B, T, c_out) f32."""

    def __init__(self, cfg: Config, g: torch.Generator, mark_width: int = 0):
        super().__init__()
        self.cfg = cfg
        self.enc_embedding = _embedding(cfg, cfg.enc_in, g, mark_width)
        self.encoder = _encoder(cfg, g)
        self.projection = linear(cfg.d_model, cfg.c_out, g)

    def forward(self, x_enc, x_mark_enc=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        h = self.encoder(self.enc_embedding(x_enc.to(dt), generator,
                                            x_mark_enc), generator)
        return dense(h, self.projection, dt).float()


# anomaly detection is the imputer called without time marks
TransformerAnomalyDetector = TransformerImputer
