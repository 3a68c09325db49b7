"""1D ResNet backbone (counterpart of sie_tpu/models/resnet.py): a stem
(Conv1d k7 stride 2 with padding 3 and no bias, BatchNorm, ReLU, max-pool
3/2 with padding 1 of -inf), three BasicBlocks at widths 64, 128 and 128
(all stride 1), the mean over time and a linear head. The explicit pads
keep PyTorch's stride-2 window alignment at even lengths. The EEG channels
are the conv channels, convolved over time; the padding mask is ignored,
as in the JAX package."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.models.layers import (BatchNorm, conv, conv_forward,
                                         dense, linear)


class BasicBlock(nn.Module):
    """Two SAME k=3 convs without bias, each with a BatchNorm; a 1x1
    shortcut conv + BatchNorm (`short_conv`, `short_bn`) when the width
    changes; ReLU of the sum."""

    def __init__(self, c_in: int, features: int, dtype: torch.dtype,
                 g: torch.Generator):
        super().__init__()
        self.dtype = dtype
        if c_in != features:
            self.short_conv = conv(nn.Conv1d, c_in, features, 1, g,
                                   bias=False)
            self.short_bn = BatchNorm(features, dtype)
        self.conv1 = conv(nn.Conv1d, c_in, features, 3, g, bias=False)
        self.bn1 = BatchNorm(features, dtype)
        self.conv2 = conv(nn.Conv1d, features, features, 3, g, bias=False)
        self.bn2 = BatchNorm(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, C, T)
        dt = self.dtype
        identity = x
        if hasattr(self, "short_conv"):
            identity = self.short_bn(conv_forward(self.short_conv, x, dt))
        h = torch.relu(self.bn1(conv_forward(self.conv1, x, dt, same=True)))
        h = self.bn2(conv_forward(self.conv2, h, dt, same=True))
        return torch.relu(h + identity)


class ResNet(nn.Module):
    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        self.dtype = dt = cfg.compute_dtype
        self.conv1 = conv(nn.Conv1d, cfg.enc_in, 64, 7, g, bias=False)
        self.bn1 = BatchNorm(64, dt)
        c_in = 64
        for i, f in enumerate((64, 128, 128), start=1):
            setattr(self, f"layer{i}", BasicBlock(c_in, f, dt, g))
            c_in = f
        self.fc = linear(c_in, cfg.num_class, g)

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = conv_forward(self.conv1, x.transpose(1, 2), self.dtype, stride=2,
                         padding=3)
        h = F.max_pool1d(torch.relu(self.bn1(h)), 3, 2, padding=1)
        for i in (1, 2, 3):
            h = getattr(self, f"layer{i}")(h)
        return dense(h.mean(dim=2), self.fc, self.dtype).float()
