"""Pyraformer: the pyramidal attention encoder, PAM-Naive (counterpart of
sie_tpu/models/extra/pyraformer.py).

- `pyramid_sizes`, `get_mask` (True = keep: each node sees its
  inner_size neighbours on its scale, its children and its parent) and
  `refer_points` (each base position's ancestor at every scale) are host
  numpy, copied from the JAX package; they enter the forward as constant
  index and mask tensors made once per device.
- `BottleneckConstruct` (`conv_layers`): down-projection, the coarser
  scales by stride-w convs (`conv_<i>`: `downConv`, BatchNorm `norm`,
  ELU), up-projection, all scales concatenated after the input, LayerNorm.
  The BatchNorms are flax's (`batch_stats` moved in training).
- `PyraformerEncoder`: the embedding, the bottleneck, masked softmax
  attention layers (-1e9 where the graph has no edge) with a post-norm
  GELU FFN, and each base position's features at every scale gathered
  and concatenated: (B, T, n_scales * d_model). The gather repeats
  ancestors; its backward (index_put with accumulate) sums them in sorted
  order, so captured steps stay bit-equal to eager ones.

Float32 throughout, as in the JAX package.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sie_tpu_torch.models.layers import (BatchNorm, DataEmbedding, dense,
                                         dropout, gelu, layer_norm,
                                         layer_norm_module, lecun_conv,
                                         lecun_linear)

F32 = torch.float32


@lru_cache(maxsize=None)
def pyramid_sizes(input_size: int, window_size: tuple) -> tuple:
    sizes = [input_size]
    for w in window_size:
        sizes.append(int(math.floor(sizes[-1] / w)))
    return tuple(sizes)


@lru_cache(maxsize=None)
def get_mask(input_size: int, window_size: tuple, inner_size: int):
    """(keep mask (N, N) bool, the scales' sizes), N their sum."""
    all_size = pyramid_sizes(input_size, window_size)
    seq_len = sum(all_size)
    mask = np.zeros((seq_len, seq_len), dtype=bool)
    inner = inner_size // 2
    for layer_idx, size in enumerate(all_size):
        start = sum(all_size[:layer_idx])
        for i in range(start, start + size):
            left = max(i - inner, start)
            right = min(i + inner + 1, start + size)
            mask[i, left:right] = True
    for layer_idx in range(1, len(all_size)):
        start = sum(all_size[:layer_idx])
        prev = all_size[layer_idx - 1]
        for i in range(start, start + all_size[layer_idx]):
            left = (start - prev) + (i - start) * window_size[layer_idx - 1]
            if i == start + all_size[layer_idx] - 1:
                right = start
            else:
                right = (start - prev) + (i - start + 1) \
                    * window_size[layer_idx - 1]
            mask[i, left:right] = True
            mask[left:right, i] = True
    return mask, all_size


@lru_cache(maxsize=None)
def refer_points(all_sizes: tuple, window_size: tuple) -> np.ndarray:
    """(input_size, n_scales) index of each base position's ancestor."""
    input_size = all_sizes[0]
    indexes = np.zeros((input_size, len(all_sizes)), dtype=np.int64)
    for i in range(input_size):
        indexes[i, 0] = i
        former = i
        for j in range(1, len(all_sizes)):
            start = sum(all_sizes[:j])
            inner_idx = former - (start - all_sizes[j - 1])
            former = start + min(inner_idx // window_size[j - 1],
                                 all_sizes[j] - 1)
            indexes[i, j] = former
    return indexes


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_in: int, d_hid: int, g: torch.Generator,
                 dropout: float = 0.1, normalize_before: bool = True):
        super().__init__()
        self.dropout, self.normalize_before = dropout, normalize_before
        self.layer_norm = layer_norm_module(d_in)
        self.w_1 = lecun_linear(d_in, d_hid, g)
        self.w_2 = lecun_linear(d_hid, d_in, g)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        drop = lambda z: dropout(z, self.dropout, generator, self.training)
        residual = x
        if self.normalize_before:
            x = layer_norm(self.layer_norm, x)
        x = drop(gelu(dense(x, self.w_1, F32)))
        x = drop(dense(x, self.w_2, F32)) + residual
        if not self.normalize_before:
            x = layer_norm(self.layer_norm, x)
        return x


class PyraformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_inner: int, n_heads: int,
                 g: torch.Generator, dropout: float = 0.1,
                 normalize_before: bool = False):
        super().__init__()
        self.n_heads, self.dropout = n_heads, dropout
        dk = d_model // n_heads
        self.query = lecun_linear(d_model, dk * n_heads, g)
        self.key = lecun_linear(d_model, dk * n_heads, g)
        self.value = lecun_linear(d_model, dk * n_heads, g)
        self.out = lecun_linear(dk * n_heads, d_model, g)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, g, dropout,
                                               normalize_before)

    def forward(self, x, keep_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        b, l = x.shape[:2]
        split = lambda lin: dense(x, lin, F32).unflatten(
            -1, (self.n_heads, -1)).transpose(1, 2)           # (B, H, L, dk)
        q, k, v = split(self.query), split(self.key), split(self.value)
        dk = q.shape[-1]
        scores = torch.matmul(q, k.transpose(-1, -2))
        scores = scores.masked_fill(~keep_mask, -1e9)
        a = torch.softmax(scores / math.sqrt(dk), dim=-1)
        a = dropout(a, self.dropout, generator, self.training)
        out = torch.matmul(a, v).transpose(1, 2).reshape(b, l, -1)
        return self.pos_ffn(dense(out, self.out, F32), generator)


class PyraformerConvLayer(nn.Module):
    def __init__(self, c_in: int, window_size: int, g: torch.Generator):
        super().__init__()
        self.downConv = lecun_conv(nn.Conv1d, c_in, c_in, window_size, g,
                                   stride=window_size)
        self.norm = BatchNorm(c_in, F32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:     # (B, T, C)
        h = self.downConv(x.transpose(1, 2))
        return F.elu(self.norm(h)).transpose(1, 2)


class BottleneckConstruct(nn.Module):
    def __init__(self, d_model: int, window_size: tuple, d_inner: int,
                 g: torch.Generator):
        super().__init__()
        self.n_convs = len(window_size)
        self.down = lecun_linear(d_model, d_inner, g)
        for i, w in enumerate(window_size):
            setattr(self, f"conv_{i}", PyraformerConvLayer(d_inner, w, g))
        self.up = lecun_linear(d_inner, d_model, g)
        self.norm = layer_norm_module(d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:      # (B, T, D)
        tmp = dense(x, self.down, F32)
        scales = []
        for i in range(self.n_convs):
            tmp = getattr(self, f"conv_{i}")(tmp)
            scales.append(tmp)
        up = dense(torch.cat(scales, dim=1), self.up, F32)
        return layer_norm(self.norm, torch.cat([x, up], dim=1))


class PyraformerEncoder(nn.Module):
    def __init__(self, seq_len: int, d_model: int, n_heads: int, d_ff: int,
                 c_in: int, g: torch.Generator, e_layers: int = 2,
                 window_size: tuple = (4, 4), inner_size: int = 5,
                 dropout: float = 0.1, mark_width: int = 0):
        super().__init__()
        self.seq_len, self.d_model = seq_len, d_model
        self.window_size, self.inner_size = tuple(window_size), inner_size
        self.enc_embedding = DataEmbedding(c_in, d_model, F32, g,
                                           dropout=dropout,
                                           mark_width=mark_width)
        self.conv_layers = BottleneckConstruct(d_model, self.window_size,
                                               d_model // 4, g)
        self.layers = nn.ModuleList(
            PyraformerEncoderLayer(d_model, d_ff, n_heads, g, dropout,
                                   normalize_before=False)
            for _ in range(e_layers))
        self._graph: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def graph(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(keep mask (N, N), refer points (T, n_scales)) on `device`."""
        if device not in self._graph:
            mask, sizes = get_mask(self.seq_len, self.window_size,
                                   self.inner_size)
            idx = refer_points(tuple(sizes), self.window_size)
            self._graph[device] = (torch.from_numpy(mask).to(device),
                                   torch.from_numpy(idx).to(device))
        return self._graph[device]

    def forward(self, x_enc, x_mark_enc=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        keep, idx = self.graph(x_enc.device)
        seq = self.enc_embedding(x_enc, generator, x_mark_enc)
        seq = self.conv_layers(seq)
        for layer in self.layers:
            seq = layer(seq, keep, generator)
        b = seq.shape[0]
        gathered = seq[:, idx.reshape(-1), :]
        return gathered.reshape(b, idx.shape[0], idx.shape[1] * self.d_model)
