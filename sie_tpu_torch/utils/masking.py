"""Attention masks (counterpart of sie_tpu/utils/masking.py): the causal
mask and ProbAttention's `prob_mask` (Informer). True = disallowed."""

from __future__ import annotations

import torch


def triangular_causal_mask(b: int, l: int, device=None) -> torch.Tensor:
    """True where attention is disallowed (the upper triangle), (B, 1, L, L)
    bool."""
    mask = torch.triu(torch.ones((l, l), dtype=torch.bool, device=device),
                      diagonal=1)
    return mask.expand(b, 1, l, l)


def prob_mask(b: int, h: int, l: int, index: torch.Tensor,
              scores: torch.Tensor) -> torch.Tensor:
    """ProbSparse attention's mask (Informer): the causal upper triangle's
    rows `index` (B, H, u), (B, H, u, S) bool, S = scores.shape[-1]."""
    s = scores.shape[-1]
    upper = torch.triu(torch.ones((l, s), dtype=torch.bool,
                                  device=scores.device), diagonal=1)
    full = upper[None, None].expand(b, h, l, s)
    bi = torch.arange(b, device=scores.device)[:, None, None]
    hi = torch.arange(h, device=scores.device)[None, :, None]
    return full[bi, hi, index, :]
