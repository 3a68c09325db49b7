"""Attention masks (counterpart of sie_tpu/utils/masking.py): the causal
mask. ProbAttention's `prob_mask` comes with that attention variant
(ROADMAP.md)."""

from __future__ import annotations

import torch


def triangular_causal_mask(b: int, l: int, device=None) -> torch.Tensor:
    """True where attention is disallowed (the upper triangle), (B, 1, L, L)
    bool."""
    mask = torch.triu(torch.ones((l, l), dtype=torch.bool, device=device),
                      diagonal=1)
    return mask.expand(b, 1, l, l)
