"""Vanilla Transformer classifier (counterpart of the `Transformer` class of
sie_tpu/models/transformer.py): DataEmbedding -> Encoder stack -> gelu ->
dropout -> multiply by the padding mask -> flatten (B, T*d_model) -> linear
head.
Forecast, imputation and anomaly heads are not ported yet."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.models.layers import (DataEmbedding, Encoder, dense,
                                         dropout, gelu, linear)


class Transformer(nn.Module):
    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.enc_embedding = DataEmbedding(cfg.enc_in, cfg.d_model, dt, g,
                                           dropout=cfg.dropout)
        self.encoder = Encoder(
            cfg.e_layers, cfg.d_model, d_ff=cfg.d_ff, n_heads=cfg.n_heads,
            dtype=dt, g=g, activation=cfg.activation,
            use_fused=cfg.use_fused_attention,
            fused_max_len=cfg.fused_attention_max_len,
            fused_min_len=cfg.fused_attention_min_len,
            use_flash=cfg.use_flash_attention,
            variant=cfg.attention_variant, moe_experts=cfg.moe_experts,
            dropout=cfg.dropout)
        self.projection = linear(cfg.seq_len * cfg.d_model, cfg.num_class, g)

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        h = self.encoder(self.enc_embedding(x.to(dt), generator), generator)
        h = dropout(gelu(h), self.cfg.dropout, generator, self.training)
        if padding_mask is not None:
            h = h * padding_mask.to(h.dtype)[..., None]
        h = h.reshape(h.shape[0], -1)
        return dense(h, self.projection, dt).float()
