"""Fully Convolutional Network backbone (counterpart of
sie_tpu/models/fcn.py): three VALID Conv1d + BatchNorm + ReLU blocks over
time, kernels (8, 5, 3), or (3, 3, 2) when seq_len <= 10, at widths 128,
256 and 128; the mean over time; a linear head. The padding mask is
ignored, as in the JAX package. Submodules carry the flax scope names
`conv1..3`, `bn1..3` and `fc`."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.models.layers import (BatchNorm, conv, conv_forward,
                                         dense, linear)

FEATURES = (128, 256, 128)


class FullyConvNetwork(nn.Module):
    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        self.dtype = cfg.compute_dtype
        kernels = (3, 3, 2) if cfg.seq_len <= 10 else (8, 5, 3)
        c_in = cfg.enc_in
        for i, (k, f) in enumerate(zip(kernels, FEATURES), start=1):
            setattr(self, f"conv{i}", conv(nn.Conv1d, c_in, f, k, g))
            setattr(self, f"bn{i}", BatchNorm(f, self.dtype))
            c_in = f
        self.fc = linear(c_in, cfg.num_class, g)

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x.transpose(1, 2)                       # (B, C, T): time last
        for i in range(1, len(FEATURES) + 1):
            h = conv_forward(getattr(self, f"conv{i}"), h, self.dtype)
            h = torch.relu(getattr(self, f"bn{i}")(h))
        return dense(h.mean(dim=2), self.fc, self.dtype).float()
