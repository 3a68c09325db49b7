"""FEDformer's frequency-domain blocks (counterpart of
sie_tpu/models/extra/fourier.py).

- `get_frequency_modes`: the rfft bins a block keeps. 'random' is
  `np.random.default_rng(seed).permutation(seq_len // 2)[:modes]`, sorted:
  the JAX package's numpy draw, repeated here as it stands.
- `FourierBlock`: rfft over time (float32) -> a per-mode complex linear
  map -> irfft; only q is used (a drop-in self-attention).
- `FourierCrossAttention`: q's and k's kept modes, the product q_ft k_ft
  (not conjugated, the reference's quirk) through tanh (real and
  imaginary parts) or a softmax of the modulus, applied to k_ft, the
  per-mode weights, irfft of the scattered modes over in*out channels.
- `FourierCrossAttentionW`: the same without weights, on the lowest modes
  (inside the multiwavelet cross block).

Each complex weight is two real float32 parameters `weights_real` and
`weights_imag`, scale * U[0, 1). Mode selection scatters into a zero
spectrum by index (distinct bins: the backward is a gather).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn


def get_frequency_modes(seq_len: int, modes: int = 64,
                        mode_select_method: str = "random",
                        seed: int = 0) -> List[int]:
    modes = min(modes, seq_len // 2)
    if mode_select_method == "random":
        index = list(np.random.default_rng(seed).permutation(seq_len // 2)
                     [:modes])
    else:
        index = list(range(modes))
    index.sort()
    return [int(i) for i in index]


def uniform_param(shape, scale: float, g: torch.Generator) -> nn.Parameter:
    """scale * U[0, 1), float32 (the JAX package's complex-weight init)."""
    p = nn.Parameter(torch.empty(shape))
    with torch.no_grad():
        p.uniform_(0.0, 1.0, generator=g).mul_(scale)
    return p


class _ComplexWeights(nn.Module):
    def _weights(self, shape, scale: float, g: torch.Generator) -> None:
        self.weights_real = uniform_param(shape, scale, g)
        self.weights_imag = uniform_param(shape, scale, g)
        self._index: Dict[Tuple, torch.Tensor] = {}

    def weight(self) -> torch.Tensor:
        return torch.complex(self.weights_real, self.weights_imag)

    def _kept(self, index: List[int], bins: int, device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the bins of `index` below `bins`, their positions in `index`)
        as index tensors on `device`, made once (before a CUDA graph
        captures the block)."""
        key = (tuple(index), bins, device)
        if key not in self._index:
            keep = [wi for wi, i in enumerate(index) if i < bins]
            self._index[key] = (
                torch.tensor([index[wi] for wi in keep], device=device),
                torch.tensor(keep, device=device))
        return self._index[key]


def _activate(xqk: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "tanh":
        return torch.complex(torch.tanh(xqk.real), torch.tanh(xqk.imag))
    if activation == "softmax":
        return torch.softmax(xqk.abs(), dim=-1).to(torch.complex64)
    raise ValueError(f"unknown activation {activation!r}")


def _scatter_modes(b, h, e, l, idx, values) -> torch.Tensor:
    """A (B, H, E, l//2 + 1) zero spectrum with `values` at bins `idx`."""
    out = values.new_zeros(b, h, e, l // 2 + 1)
    return out.index_copy(3, idx, values)


class FourierBlock(_ComplexWeights):
    def __init__(self, in_channels: int, out_channels: int, seq_len: int,
                 g: torch.Generator, modes: int = 0,
                 mode_select_method: str = "random", n_heads: int = 8,
                 seed: int = 0):
        super().__init__()
        self.index = get_frequency_modes(seq_len, modes, mode_select_method,
                                         seed)
        self._weights((n_heads, in_channels // n_heads,
                       out_channels // n_heads, len(self.index)),
                      1.0 / (in_channels * out_channels), g)

    def forward(self, q, k=None, v=None) -> torch.Tensor:
        b, l, h, e = q.shape
        x_ft = torch.fft.rfft(q.permute(0, 2, 3, 1).float())  # (B, H, E, F)
        idx, keep = self._kept(self.index, x_ft.shape[-1], q.device)
        w = self.weight()[..., keep]
        out_sel = torch.einsum("bhim,hiom->bhom", x_ft[..., idx], w)
        out = torch.fft.irfft(_scatter_modes(b, h, e, l, idx, out_sel), n=l)
        return out.permute(0, 3, 1, 2).to(q.dtype)


class FourierCrossAttention(_ComplexWeights):
    def __init__(self, in_channels: int, out_channels: int, seq_len_q: int,
                 seq_len_kv: int, g: torch.Generator, modes: int = 64,
                 mode_select_method: str = "random",
                 activation: str = "tanh", n_heads: int = 8, seed: int = 0):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.activation = activation
        self.index_q = get_frequency_modes(seq_len_q, modes,
                                           mode_select_method, seed)
        self.index_kv = get_frequency_modes(seq_len_kv, modes,
                                            mode_select_method, seed + 1)
        self._weights((n_heads, in_channels // n_heads,
                       out_channels // n_heads, len(self.index_q)),
                      1.0 / (in_channels * out_channels), g)

    def forward(self, q, k, v=None) -> torch.Tensor:
        b, l, h, e = q.shape
        xq_ft = torch.fft.rfft(q.permute(0, 2, 3, 1).float())
        xk_ft = torch.fft.rfft(k.permute(0, 2, 3, 1).float())
        iq, keep_q = self._kept(self.index_q, xq_ft.shape[-1], q.device)
        ikv, _ = self._kept(self.index_kv, xk_ft.shape[-1], q.device)
        xq_sel, xk_sel = xq_ft[..., iq], xk_ft[..., ikv]
        xqk = _activate(torch.einsum("bhex,bhey->bhxy", xq_sel, xk_sel),
                        self.activation)
        xqkv = torch.einsum("bhxy,bhey->bhex", xqk, xk_sel)
        w = self.weight()[..., keep_q]
        xqkvw = torch.einsum("bhex,heox->bhox", xqkv, w)
        out_ft = _scatter_modes(b, h, e, l, iq, xqkvw)
        out = torch.fft.irfft(out_ft / self.in_channels / self.out_channels,
                              n=l)
        return out.permute(0, 3, 1, 2).to(q.dtype)


class FourierCrossAttentionW(nn.Module):
    """(B, L, E, H) in and out; keeps the lowest min(L//2, modes) modes."""

    def __init__(self, in_channels: int, out_channels: int, modes: int = 16,
                 activation: str = "tanh"):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.modes, self.activation = modes, activation

    def forward(self, q, k, v=None) -> torch.Tensor:
        b, l, e, h = q.shape
        mq = min(l // 2, self.modes)
        mkv = min(k.shape[1] // 2, self.modes)
        xq_sel = torch.fft.rfft(q.permute(0, 3, 2, 1).float())[..., :mq]
        xk_sel = torch.fft.rfft(k.permute(0, 3, 2, 1).float())[..., :mkv]
        xqk = _activate(torch.einsum("bhex,bhey->bhxy", xq_sel, xk_sel),
                        self.activation)
        xqkv = torch.einsum("bhxy,bhey->bhex", xqk, xk_sel)
        out_ft = torch.nn.functional.pad(xqkv, (0, l // 2 + 1 - mq))
        out = torch.fft.irfft(out_ft / self.in_channels / self.out_channels,
                              n=l)
        return out.permute(0, 3, 2, 1).to(q.dtype)
