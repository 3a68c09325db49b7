"""PatchTST classifier (counterpart of the `PatchTST` class of
sie_tpu/models/patchtst.py, reference model/PatchTST.py).

Channel-independent patching (patches of 16, stride 8, the series padded at
its end by repeating its last value 8 times), a bias-free patch embedding
plus the sinusoidal position table, and one Transformer encoder shared by
every (row, channel) series. Channel independence multiplies the batch by
C (7808 series at the EEG width), so the encoder runs over chunks of
series, as the JAX package's `nn.scan` over `_EncoderChunk` does: one pass
without recompute when B*C <= `patch_chunk_rows` (default 2048), else
ceil(rows / chunk_rows) chunks of equal size, zero-padded, each recomputed
in the backward pass under `patch_remat`. The parameters are the same
whatever the chunking (`enc_scan.encoder`).

Dropout inside a recomputed chunk goes through a `ReplayDropout`: the
forward draws the masks from the model's generator as an unrecomputed
chunk would, and the recompute replays them, eagerly and in a captured
CUDA graph alike, so the gradients are those without recompute.
Attention goes through `FullAttentionLayer` with the config's gates; at
the default `fused_attention_min_len` (256) the 105 patches of a CHISCO
series take the plain branch, as the JAX package takes XLA's.

The task branches (`PatchTSTForecaster`, `PatchTSTImputer`,
`PatchTSTAnomalyDetector`) normalise with `timesnet.ns_norm` (or
`masked_ns_norm` for imputation), run the same encoder and map each
channel's (d_model, patch_num) features to the target window through one
dense layer, `head` (reference FlattenHead, PatchTST.py:13-26, in its
(C, D, P) order), then de-normalise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sie_tpu_torch.config import Config
from sie_tpu_torch.models.layers import (Encoder, ReplayDropout, dense,
                                         dropout, linear,
                                         sinusoidal_embedding)
from sie_tpu_torch.models.timesnet import masked_ns_norm, ns_norm

PATCH_LEN, STRIDE = 16, 8
_CHUNK_ROWS = 2048   # series per encoder chunk by default


def chunking(rows: int, chunk_rows: int) -> Tuple[int, int]:
    """(chunks, series per chunk) of the encoder over `rows` series with at
    most `chunk_rows` (0: the default 2048) in a chunk."""
    n = max(1, -(-rows // (chunk_rows or _CHUNK_ROWS)))
    return n, -(-rows // n)


def patches(xz: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B*C, patch_num, 16): the end padded by the last value
    repeated STRIDE times, then windows of 16 every 8 steps."""
    b, t, c = xz.shape
    xt = xz.transpose(1, 2)                                   # (B, C, T)
    xt = torch.cat([xt, xt[:, :, -1:].expand(b, c, STRIDE)], dim=-1)
    p = xt.unfold(-1, PATCH_LEN, STRIDE)                      # (B, C, P, 16)
    return p.reshape(b * c, p.shape[2], PATCH_LEN)


class _EncoderChunk(nn.Module):
    """The scope `enc_scan` of the JAX module, holding the shared
    `encoder`."""

    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        self.encoder = Encoder(
            cfg.e_layers, cfg.d_model, d_ff=cfg.d_ff, n_heads=cfg.n_heads,
            dtype=cfg.compute_dtype, g=g, activation=cfg.activation,
            use_fused=cfg.use_fused_attention,
            fused_max_len=cfg.fused_attention_max_len,
            fused_min_len=cfg.fused_attention_min_len,
            use_flash=cfg.use_flash_attention,
            variant=cfg.attention_variant, moe_experts=cfg.moe_experts,
            dropout=cfg.dropout)

    def forward(self, h: torch.Tensor, stream) -> torch.Tensor:
        """`stream`: the model's generator, a ReplayDropout (each pass
        from its first draw) or None."""
        if isinstance(stream, ReplayDropout):
            stream.rewind()
        return self.encoder(h, stream)


def patch_num(seq_len: int) -> int:
    return (seq_len + STRIDE - PATCH_LEN) // STRIDE + 1


class _PatchBase(nn.Module):
    """The patch embedding `value_embedding` and the shared encoder
    `enc_scan`, with `_encode`."""

    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.value_embedding = linear(PATCH_LEN, cfg.d_model, g, bias=False)
        self.enc_scan = _EncoderChunk(cfg, g)
        self._pe: Dict[Tuple, torch.Tensor] = {}

    def _position(self, n: int, like: torch.Tensor) -> torch.Tensor:
        key = (n, like.device, like.dtype)
        if key not in self._pe:
            self._pe[key] = torch.from_numpy(
                sinusoidal_embedding(n, self.cfg.d_model)).to(
                    device=like.device, dtype=like.dtype)
        return self._pe[key]

    def _encode(self, xz: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """(B, T, C) normalised -> (B, C, patch_num, d_model) f32."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        b, _, c = xz.shape
        h = dense(patches(xz).to(dt), self.value_embedding, dt)
        h = dropout(h + self._position(h.shape[1], h)[None], cfg.dropout,
                    generator, self.training)
        rows, p, d = h.shape
        n, chunk = chunking(rows, cfg.patch_chunk_rows)
        if n == 1:
            # small enough for one pass: the same parameters, no recompute
            out = self.enc_scan(h, generator)
        else:
            hp = torch.cat([h, h.new_zeros(n * chunk - rows, p, d)])
            remat = cfg.patch_remat and torch.is_grad_enabled()
            outs = []
            for i in range(n):
                part = hp[i * chunk:(i + 1) * chunk]
                if remat:
                    stream = (None if generator is None
                              else ReplayDropout(generator))
                    outs.append(checkpoint(self.enc_scan, part, stream,
                                           use_reentrant=False,
                                           preserve_rng_state=False))
                else:
                    outs.append(self.enc_scan(part, generator))
            out = torch.cat(outs)[:rows]
        return out.reshape(b, c, p, d)


class PatchTST(_PatchBase):
    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__(cfg, g)
        self.projection = linear(cfg.enc_in * cfg.d_model
                                 * patch_num(cfg.seq_len), cfg.num_class, g)

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        b = x.shape[0]
        # non-stationary normalisation (reference PatchTST.py:181-187)
        xz = x - x.mean(dim=1, keepdim=True)
        xz = xz / torch.sqrt(xz.var(dim=1, keepdim=True, unbiased=False)
                             + 1e-5)
        h = self._encode(xz, generator)
        # the reference's (C, D, P) feature order (PatchTST.py:199-205), so
        # the projection's weights line up with its checkpoints
        h = h.transpose(2, 3).reshape(b, -1)
        h = dropout(h, cfg.dropout, generator, self.training)
        return dense(h, self.projection, cfg.compute_dtype).float()


class _PatchHead(_PatchBase):
    """A task branch: the encoder, then `head` (d_model * patch_num ->
    `target_window`) per channel, dropout, de-normalisation."""

    def __init__(self, cfg: Config, g: torch.Generator, target_window: int):
        super().__init__(cfg, g)
        self.head = linear(cfg.d_model * patch_num(cfg.seq_len),
                           target_window, g)

    def _flatten_head(self, h: torch.Tensor,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
        """(B, C, P, D) -> (B, target_window, C) f32, the features flattened
        in the reference's (D, P) order."""
        b, c, p, d = h.shape
        out = dense(h.transpose(2, 3).reshape(b, c, d * p), self.head,
                    self.cfg.compute_dtype)
        out = dropout(out, self.cfg.dropout, generator, self.training)
        return out.transpose(1, 2).float()


class PatchTSTForecaster(_PatchHead):
    """forward(x_enc (B, seq_len, C), x_mark_enc) -> (B, pred_len, C) f32
    (reference PatchTST.py:79-110); the marks are not read."""

    def __init__(self, cfg: Config, g: torch.Generator, mark_width: int = 0):
        super().__init__(cfg, g, cfg.pred_len)

    def forward(self, x_enc, x_mark_enc=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        xz, mean, std = ns_norm(x_enc)
        out = self._flatten_head(self._encode(xz, generator), generator)
        return out * std + mean


class PatchTSTImputer(_PatchHead):
    """forward(x_enc (B, T, C), x_mark_enc, mask (1 = observed)) -> (B, T,
    C) f32 (reference PatchTST.py:112-147); the marks are not read."""

    def __init__(self, cfg: Config, g: torch.Generator, mark_width: int = 0):
        super().__init__(cfg, g, cfg.seq_len)

    def forward(self, x_enc, x_mark_enc=None, mask=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if mask is None:
            mask = torch.ones_like(x_enc)
        xz, mean, std = masked_ns_norm(x_enc, mask)
        out = self._flatten_head(self._encode(xz, generator), generator)
        return out * std + mean


class PatchTSTAnomalyDetector(_PatchHead):
    """forward(x_enc (B, T, C)) -> (B, T, C) f32: the imputer's network
    with `ns_norm` (reference PatchTST.py:149-179)."""

    def __init__(self, cfg: Config, g: torch.Generator, mark_width: int = 0):
        super().__init__(cfg, g, cfg.seq_len)

    def forward(self, x_enc,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        xz, mean, std = ns_norm(x_enc)
        out = self._flatten_head(self._encode(xz, generator), generator)
        return out * std + mean
