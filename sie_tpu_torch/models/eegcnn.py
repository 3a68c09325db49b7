"""EEGNet-style CNN with a Transformer encoder head (counterpart of
sie_tpu/models/eegcnn.py), channels first (NCHW):

  (B, T, C) -> (B, 1, C, T) -> temporal Conv2d (1 x k1, SAME) -> BN
  -> depthwise spatial Conv2d (C x 1, groups F1, VALID) -> BN -> ELU
  -> AvgPool (1 x P1) -> dropout
  -> depthwise Conv2d (1 x k2, SAME) -> pointwise 1x1 -> BN -> ELU
  -> AvgPool (1 x P2) -> dropout -> (B, T_red, F2), F2 = F1 x D
  -> with encoder layers: `cnn_projection` to d_model when it differs
     from F2, sinusoidal positions, dropout, `encoder_<i>`
  -> pooling (none, mean, sum, top) -> `classifier`.

The (B, T) padding mask is pooled by P1 then P2 and thresholded at 0.5;
it masks the encoder's keys and weights the mean and sum poolings. SAME
splits k - 1 padding taps as flax does, (k - 1) // 2 before the input
(`layers.same_pads`), for odd and even kernels alike. Dropout
(eegcnn_dropout1 in the CNN, eegcnn_dropout2 in the head) draws from the
caller's generator. The attention is plain torch, as the JAX package
leaves it to XLA: there is no kernel on this model's path."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.models.info import ModelInfo
from sie_tpu_torch.models.layers import (BatchNorm,
                                         TorchTransformerEncoderLayer, conv,
                                         conv_forward, dense, dropout, linear,
                                         sinusoidal_embedding)


def reduced_length(cfg: Config) -> int:
    """The CNN's output length: seq_len pooled by P1, then by P2."""
    return cfg.seq_len // cfg.eegcnn_pool1 // cfg.eegcnn_pool2


class EEGcnn(nn.Module):
    """The feature extractor: (B, C, T) -> (B, T_red, F2)."""

    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.dtype = dt = cfg.compute_dtype
        f1, d = cfg.eegcnn_cnn_f1, cfg.eegcnn_cnn_f2
        self.block1_conv1 = conv(nn.Conv2d, 1, f1, (1, cfg.eegcnn_kernel1),
                                 g, bias=False)
        self.block1_bn1 = BatchNorm(f1, dt)
        self.block1_depthwise = conv(nn.Conv2d, f1, d * f1, (cfg.enc_in, 1),
                                     g, bias=False, groups=f1)
        self.block1_bn2 = BatchNorm(d * f1, dt)
        self.block2_conv1 = conv(nn.Conv2d, d * f1, d * f1,
                                 (1, cfg.eegcnn_kernel2), g, bias=False,
                                 groups=d * f1)
        self.block2_conv2 = conv(nn.Conv2d, d * f1, f1 * d, (1, 1), g,
                                 bias=False)
        self.block2_bn = BatchNorm(f1 * d, dt)

    def _spatial(self, h: torch.Tensor) -> torch.Tensor:
        """The depthwise spatial conv (C x 1 kernel, groups F1, VALID) of h
        (B, F1, C, T) -> (B, F1 * D, 1, T). Its kernel spans the whole
        height, so output channel g * D + j is a product over the C rows
        of group g: one batched product, in bf16 with f32 sums under amp as
        the convolution takes them. PyTorch's native depthwise convolution
        computes the same, but its backward took 64.5 of the 83.6 ms of a
        training step at bench.py's shape on an H100
        (scripts/port_profile_train.py --config eegcnn)."""
        f1, c = h.shape[1], h.shape[2]
        w = self.block1_depthwise.weight.to(self.dtype).view(f1, -1, c)
        out = torch.einsum("gdc,bgct->bgdt", w, h.to(self.dtype))
        return out.flatten(1, 2)[:, :, None]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        drop = lambda z: dropout(z, cfg.eegcnn_dropout1, generator,
                                 self.training)
        pool = lambda z, p: F.avg_pool2d(z, (1, p), (1, p))
        h = x[:, None]                                        # (B, 1, C, T)
        h = self.block1_bn1(conv_forward(self.block1_conv1, h, dt, same=True))
        h = F.elu(self.block1_bn2(self._spatial(h)))
        h = drop(pool(h, cfg.eegcnn_pool1))
        h = conv_forward(self.block2_conv1, h, dt, same=True)
        h = F.elu(self.block2_bn(conv_forward(self.block2_conv2, h, dt)))
        h = drop(pool(h, cfg.eegcnn_pool2))                  # (B, F2, 1, T')
        return h[:, :, 0].transpose(1, 2)


class EEGCNNTransformer(nn.Module):
    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.dtype = dt = cfg.compute_dtype
        f2 = cfg.eegcnn_cnn_f1 * cfg.eegcnn_cnn_f2
        self.eegcnn = EEGcnn(cfg, g)
        self.t_red = reduced_length(cfg)
        width = f2
        if cfg.eegcnn_layers > 0:
            width = f2 if cfg.d_model is None else cfg.d_model
            if width != f2:
                self.cnn_projection = linear(f2, width, g)
            self.register_buffer("pe", torch.from_numpy(
                sinusoidal_embedding(self.t_red, width)), persistent=False)
            for i in range(cfg.eegcnn_layers):
                setattr(self, f"encoder_{i}", TorchTransformerEncoderLayer(
                    width, cfg.eegcnn_n_heads, cfg.eegcnn_d_ff,
                    cfg.eegcnn_dropout2, dt, g))
        pool = cfg.eegcnn_pooling
        if pool not in (None, "none", "mean", "sum", "top"):
            raise ValueError(f"unsupported pooling {pool!r}")
        head_in = self.t_red * width if pool in (None, "none") else width
        self.classifier = linear(head_in, cfg.num_class, g)

    def _mask(self, padding_mask: Optional[torch.Tensor], b: int,
              device: torch.device) -> torch.Tensor:
        """(B, T_red) bool: the padding mask pooled by P1 then P2, > 0.5."""
        if padding_mask is None:
            return torch.ones((b, self.t_red), dtype=torch.bool,
                              device=device)
        m = padding_mask.float()[:, None]                    # (B, 1, T)
        m = F.avg_pool1d(m, self.cfg.eegcnn_pool1, self.cfg.eegcnn_pool1)
        m = F.avg_pool1d(m, self.cfg.eegcnn_pool2, self.cfg.eegcnn_pool2)
        return m[:, 0, :self.t_red] > 0.5

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                gating_value=None,
                generator: Optional[torch.Generator] = None):
        cfg, dt = self.cfg, self.dtype
        h = self.eegcnn(x.transpose(1, 2), generator)     # (B, T_red, F2)
        b = h.shape[0]
        mask = self._mask(padding_mask, b, h.device)
        if cfg.eegcnn_layers > 0:
            if hasattr(self, "cnn_projection"):
                h = dense(h, self.cnn_projection, dt)
            h = dropout(h + self.pe.to(h.dtype)[None], cfg.eegcnn_dropout2,
                        generator, self.training)
            for i in range(cfg.eegcnn_layers):
                h = getattr(self, f"encoder_{i}")(h, mask, generator)
        mf = mask.to(h.dtype)[..., None]                     # (B, T_red, 1)
        pool = cfg.eegcnn_pooling
        if pool in (None, "none"):
            h = h.reshape(b, -1)
        elif pool == "mean":
            h = (h * mf).sum(dim=1) / torch.clamp(mf.sum(dim=1), min=1)
        elif pool == "sum":
            h = (h * mf).sum(dim=1)
        else:
            h = h[:, 0, :]
        logits = dense(h, self.classifier, dt).float()
        return logits, ModelInfo(preds=logits,
                                 loss=torch.zeros(1, device=logits.device))
