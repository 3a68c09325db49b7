"""Standalone 2D Inception blocks (counterpart of
sie_tpu/models/extra/conv_blocks.py). No entry point of either package
reaches them (TimesNet runs its own `InceptionConvSeq`); they are the
library surface, channel-last (B, H, W, C) as there.

- `InceptionBlockV1`: odd square kernels 1, 3, ..., 2K-1 (`kernel_<i>`),
  "SAME" padded, averaged.
- `InceptionBlockV2`: pairs of (1, 2i+3) and (2i+3, 1) kernels and a final
  1x1, averaged.

Kernels are kaiming-normal over fan_out (flax's variance_scaling(2,
fan_out, normal)), biases zero; float32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sie_tpu_torch.models.layers import conv_forward, normal_


def _conv(in_channels: int, out_channels: int, kernel, g: torch.Generator
          ) -> nn.Conv2d:
    c = nn.utils.skip_init(nn.Conv2d, in_channels, out_channels, kernel)
    fan_out = out_channels * kernel[0] * kernel[1]
    normal_(c.weight, math.sqrt(2.0 / fan_out), g)
    with torch.no_grad():
        c.bias.zero_()
    return c


class _Inception(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:     # (B, H, W, C)
        xc = x.permute(0, 3, 1, 2)
        res = [conv_forward(getattr(self, f"kernel_{i}"), xc, torch.float32,
                            same=True) for i in range(self.n)]
        return torch.stack(res, dim=-1).mean(-1).permute(0, 2, 3, 1)


class InceptionBlockV1(_Inception):
    def __init__(self, in_channels: int, out_channels: int,
                 g: torch.Generator, num_kernels: int = 6):
        super().__init__()
        self.n = num_kernels
        for i in range(num_kernels):
            setattr(self, f"kernel_{i}",
                    _conv(in_channels, out_channels, (2 * i + 1,) * 2, g))


class InceptionBlockV2(_Inception):
    def __init__(self, in_channels: int, out_channels: int,
                 g: torch.Generator, num_kernels: int = 6):
        super().__init__()
        half = num_kernels // 2
        self.n = 2 * half + 1
        for i in range(half):
            k = 2 * i + 3
            setattr(self, f"kernel_{2 * i}",
                    _conv(in_channels, out_channels, (1, k), g))
            setattr(self, f"kernel_{2 * i + 1}",
                    _conv(in_channels, out_channels, (k, 1), g))
        setattr(self, f"kernel_{2 * half}",
                _conv(in_channels, out_channels, (1, 1), g))

