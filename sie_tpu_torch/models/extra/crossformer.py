"""Crossformer: segment merging and the hierarchical encoder and decoder
(counterpart of sie_tpu/models/extra/crossformer.py), on the two-stage
attention layer of attention_variants.py.

- `SegMerging` (`norm`, `linear_trans`): pads the segment axis by
  repeating its last segments to a multiple of win_size, then merges
  win_size neighbours into one (a reshape), LayerNorm, Dense.
- `ScaleBlock` (`merge_layer`, `encode_layer_<i>`), `CrossformerEncoder`
  (`block_<i>`, every scale's output), `CrossformerDecoderLayer` (TSA
  self-attention, a plain `FullAttentionLayer` cross-attention to one
  encoder scale, a GELU MLP, the per-layer segment prediction) and
  `CrossformerDecoder` (the predictions summed over layers and unfolded to
  the time axis).

Float32 throughout, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from sie_tpu_torch.models.extra.attention_variants import \
    TwoStageAttentionLayer
from sie_tpu_torch.models.layers import (FullAttentionLayer, dense, dropout,
                                         gelu, layer_norm, layer_norm_module,
                                         lecun_linear)

F32 = torch.float32


class SegMerging(nn.Module):
    def __init__(self, d_model: int, win_size: int, g: torch.Generator):
        super().__init__()
        self.win_size = win_size
        self.norm = layer_norm_module(win_size * d_model)
        self.linear_trans = lecun_linear(win_size * d_model, d_model, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:      # (B, D, S, M)
        b, d, seg, m = x.shape
        pad = (-seg) % self.win_size
        if pad:
            x = torch.cat([x, x[:, :, -pad:, :]], dim=-2)
            seg += pad
        x = x.reshape(b, d, seg // self.win_size, self.win_size * m)
        return dense(layer_norm(self.norm, x), self.linear_trans, F32)


class ScaleBlock(nn.Module):
    def __init__(self, win_size: int, d_model: int, n_heads: int, d_ff: int,
                 depth: int, dropout: float, g: torch.Generator,
                 seg_num: int = 10, factor: int = 10):
        super().__init__()
        self.depth = depth
        self.merge_layer = (SegMerging(d_model, win_size, g)
                            if win_size > 1 else None)
        for i in range(depth):
            setattr(self, f"encode_layer_{i}", TwoStageAttentionLayer(
                seg_num, factor, d_model, n_heads, g, d_ff, dropout))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.merge_layer is not None:
            x = self.merge_layer(x)
        for i in range(self.depth):
            x = getattr(self, f"encode_layer_{i}")(x, generator)
        return x


class CrossformerEncoder(nn.Module):
    """Scale blocks, one kwargs dict each; returns [input, scale 1, ...]."""

    def __init__(self, blocks: Sequence[dict], g: torch.Generator):
        super().__init__()
        self.n_blocks = len(blocks)
        for i, kw in enumerate(blocks):
            setattr(self, f"block_{i}", ScaleBlock(**kw, g=g))

    def forward(self, x, generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        encode_x = [x]
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x, generator)
            encode_x.append(x)
        return encode_x


class CrossformerDecoderLayer(nn.Module):
    def __init__(self, seg_len: int, d_model: int, n_heads: int,
                 g: torch.Generator, d_ff: int = 0, dropout: float = 0.1,
                 seg_num: int = 10, factor: int = 10):
        super().__init__()
        self.dropout = dropout
        self.self_attention = TwoStageAttentionLayer(
            seg_num, factor, d_model, n_heads, g, d_ff, dropout)
        self.cross_attention = FullAttentionLayer(
            d_model, n_heads, F32, g, attention_dropout=dropout)
        self.norm1 = layer_norm_module(d_model)
        self.mlp1_1 = lecun_linear(d_model, d_model, g)
        self.mlp1_2 = lecun_linear(d_model, d_model, g)
        self.norm2 = layer_norm_module(d_model)
        self.linear_pred = lecun_linear(d_model, seg_len, g)

    def forward(self, x, cross, generator: Optional[torch.Generator] = None):
        b, d, out_seg, m = x.shape
        x = self.self_attention(x, generator)
        xf = x.reshape(b * d, out_seg, m)
        crossf = cross.reshape(b * d, cross.shape[2], m)
        tmp = self.cross_attention(xf, crossf, crossf, generator)
        xf = layer_norm(self.norm1, xf + dropout(tmp, self.dropout,
                                                 generator, self.training))
        y = dense(gelu(dense(xf, self.mlp1_1, F32)), self.mlp1_2, F32)
        dec_output = layer_norm(self.norm2, xf + y).reshape(b, d, out_seg, m)
        layer_predict = dense(dec_output, self.linear_pred, F32)
        return dec_output, layer_predict.reshape(b, d * out_seg, -1)


class CrossformerDecoder(nn.Module):
    def __init__(self, layers: Sequence[dict], g: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleList(CrossformerDecoderLayer(**kw, g=g)
                                    for kw in layers)

    def forward(self, x, cross_scales,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        final = None
        ts_d = x.shape[1]
        for layer, cross in zip(self.layers, cross_scales):
            x, layer_predict = layer(x, cross, generator)
            final = layer_predict if final is None else final + layer_predict
        b, _, seg_len = final.shape
        seg_num = final.shape[1] // ts_d
        final = final.reshape(b, ts_d, seg_num, seg_len)
        return final.permute(0, 2, 3, 1).reshape(b, seg_num * seg_len, ts_d)
