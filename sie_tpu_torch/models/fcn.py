"""Fully Convolutional Network backbone (counterpart of
sie_tpu/models/fcn.py): three VALID Conv1d + BatchNorm + ReLU blocks over
time, kernels (8, 5, 3), or (3, 3, 2) when seq_len <= 10, at widths 128,
256 and 128; the mean over time; a linear head. The padding mask is
ignored, as in the JAX package. Submodules carry the flax scope names
`conv1..3`, `bn1..3` and `fc`.

On a time block (a step's 'seq' axis, parallel/comm.py) each rank keeps
its block's steps through the three convs: a VALID conv of k taps reads
the next block's first k - 1 steps (`comm.halo_seq`; zeros past the end
of time), so every rank computes the outputs at its block's global
steps, and those past the end of the VALID output (T - k + 1 steps, and
so on) are left out of BatchNorm's statistics and of the mean over time,
which sums over 'seq' (`comm.seq_sum`). A block must hold at least k - 1
steps.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.models.layers import (BatchNorm, conv, conv_forward,
                                         dense, linear)
from sie_tpu_torch.parallel import comm

FEATURES = (128, 256, 128)


class FullyConvNetwork(nn.Module):
    takes_time_blocks = True

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
        if comm.seq_size() > 1:
            return self._forward_blocks(h)
        for i in range(1, len(FEATURES) + 1):
            h = conv_forward(getattr(self, f"conv{i}"), h, self.dtype)
            h = torch.relu(getattr(self, f"bn{i}")(h))
        return dense(h.mean(dim=2), self.fc, self.dtype).float()

    def _forward_blocks(self, h: torch.Tensor) -> torch.Tensor:
        """`forward` on a time block h (B, C, n) of the 'seq' axis (module
        docstring)."""
        n, s = h.shape[2], comm.seq_size()
        steps = comm.seq_index() * n + torch.arange(n, device=h.device)
        t_out = n * s                     # the global length still valid
        for i in range(1, len(FEATURES) + 1):
            c = getattr(self, f"conv{i}")
            k = c.kernel_size[0]
            h = conv_forward(c, comm.halo_seq(h, 0, k - 1, circular=False,
                                              dim=2), self.dtype)
            t_out -= k - 1
            valid = (steps < t_out).float()
            rows = h.shape[0] * comm.data_size()
            h = torch.relu(getattr(self, f"bn{i}")(h, valid, rows * t_out))
        pooled = comm.seq_sum((h.float() * valid).sum(dim=2)) / t_out
        return dense(pooled.to(self.dtype), self.fc, self.dtype).float()
