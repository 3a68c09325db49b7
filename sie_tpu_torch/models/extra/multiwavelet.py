"""FEDformer's multiwavelet attention (counterpart of
sie_tpu/models/extra/multiwavelet.py): the Legendre / Chebyshev filter
bank, `SparseKernelFT1d`, `MWT_CZ1d`, `MultiWaveletTransform` (a
self-attention drop-in) and `MultiWaveletCross` (cross attention in
wavelet space over the weightless `FourierCrossAttentionW`). Only
`attention="wavelet"` reaches it.

The filter bank is host numpy, copied from the JAX package (`get_phi_psi`,
`get_filter`, `_bank`), except that the Gauss-Legendre nodes and weights
come from `numpy.polynomial.legendre.leggauss` where the JAX package takes
`scipy.special.roots_legendre` (the same rule; the port does not import
scipy). The decompose and reconstruct ladders run floor(log2 N) levels,
each halving the length; the filters enter as float32 constants made once
per device. Float32 throughout, FFTs through torch.fft.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from sie_tpu_torch.models.extra.fourier import (FourierCrossAttentionW,
                                                uniform_param)
from sie_tpu_torch.models.layers import dense, lecun_linear

F32 = torch.float32

_Poly = np.polynomial.Polynomial


def _legendre_shift(k: int, stretch: int) -> list:
    """Polynomials P_ki(stretch*x - 1) in power basis, ki = 0..k-1."""
    out = []
    for ki in range(k):
        coefs = np.polynomial.legendre.leg2poly(
            np.eye(k + 1)[ki][: ki + 1] if ki else np.array([1.0]))
        p = _Poly(coefs)(_Poly([-1.0, float(stretch)]))
        out.append(p)
    return out


def _chebyshev_shift(k: int, stretch: int) -> list:
    out = []
    for ki in range(k):
        coefs = np.polynomial.chebyshev.cheb2poly(
            np.eye(k + 1)[ki][: ki + 1] if ki else np.array([1.0]))
        p = _Poly(coefs)(_Poly([-1.0, float(stretch)]))
        out.append(p)
    return out


def _integral_01(prod: np.ndarray, upper_half: bool) -> float:
    """Exact integral of a power-basis polynomial over [0, 1/2] (or the
    complement [1/2, 1]) — the reference's projection rule
    (MultiWaveletCorrelation.py:48-72)."""
    j = np.arange(len(prod), dtype=np.float64)
    half = np.power(0.5, j + 1) / (j + 1)
    full = 1.0 / (j + 1)
    seg = (full - half) if upper_half else half
    return float((prod * seg).sum())


@lru_cache(maxsize=None)
def get_phi_psi(k: int, base: str = "legendre"):
    """Scaling (phi) and two-half wavelet (psi1 on [0,1/2], psi2 on [1/2,1])
    polynomial coefficient rows (ascending powers), orthonormalized by
    Gram-Schmidt exactly as reference MultiWaveletCorrelation.py:31-142."""
    if base == "legendre":
        shifted = _legendre_shift(k, 2)
        shifted2x = _legendre_shift(k, 4)
        phi = np.zeros((k, k))
        phi2x = np.zeros((k, k))
        for ki in range(k):
            c = shifted[ki].coef
            phi[ki, : len(c)] = np.sqrt(2 * ki + 1) * c
            c = shifted2x[ki].coef
            phi2x[ki, : len(c)] = np.sqrt(2.0) * np.sqrt(2 * ki + 1) * c

        psi1 = np.zeros((k, k))
        psi2 = np.zeros((k, k))
        for ki in range(k):
            # candidate wavelet = sqrt2*phi_ki(2x) (supported on [0,1/2]
            # only — hence psi2 starts at zero) minus projections onto phi
            # and previous psi, subtracted on both halves
            psi1[ki] = phi2x[ki].copy()
            for i in range(k):
                prod = np.convolve(phi2x[ki], phi[i])
                prod[np.abs(prod) < 1e-8] = 0.0
                proj = _integral_01(prod, upper_half=False)
                psi1[ki] -= proj * phi[i]
                psi2[ki] -= proj * phi[i]
            for j in range(ki):
                prod = np.convolve(phi2x[ki], psi1[j])
                prod[np.abs(prod) < 1e-8] = 0.0
                proj = _integral_01(prod, upper_half=False)
                psi1[ki] -= proj * psi1[j]
                psi2[ki] -= proj * psi2[j]
            p1 = np.convolve(psi1[ki], psi1[ki])
            p1[np.abs(p1) < 1e-8] = 0.0
            p2 = np.convolve(psi2[ki], psi2[ki])
            p2[np.abs(p2) < 1e-8] = 0.0
            norm = math.sqrt(_integral_01(p1, False) + _integral_01(p2, True))
            psi1[ki] /= norm
            psi2[ki] /= norm
            psi1[ki][np.abs(psi1[ki]) < 1e-8] = 0.0
            psi2[ki][np.abs(psi2[ki]) < 1e-8] = 0.0
        return phi, psi1, psi2

    if base == "chebyshev":
        shifted = _chebyshev_shift(k, 2)
        shifted2x = _chebyshev_shift(k, 4)
        phi = np.zeros((k, k))
        phi2x = np.zeros((k, k))
        for ki in range(k):
            unit = math.sqrt(2.0 / math.pi) if ki == 0 else 2.0 / math.sqrt(
                math.pi)
            c = shifted[ki].coef
            phi[ki, : len(c)] = unit * c
            c = shifted2x[ki].coef
            phi2x[ki, : len(c)] = math.sqrt(2.0) * unit * c

        # Chebyshev-Gauss quadrature on [0,1] with 2k nodes
        kuse = 2 * k
        i = np.arange(kuse)
        x_m = (np.cos((2 * i + 1) * math.pi / (2 * kuse)) + 1.0) / 2.0
        wm = math.pi / kuse / 2.0
        ev = lambda row, x: np.polynomial.polynomial.polyval(x, row)
        supp = lambda row, x, lb, ub: ev(row, x) * (
            1.0 - (np.logical_or(x < lb, x > ub)).astype(np.float64))

        psi1 = np.zeros((k, k))
        psi2 = np.zeros((k, k))
        for ki in range(k):
            psi1[ki] = phi2x[ki].copy()   # psi2 starts at zero: phi(2x)
            # lives on [0,1/2] only, projections hit both halves
            # sqrt(2)*phi_ki(2x) with phi's [0,1] support mask, as in the
            # reference's partial(phi_, ...) evaluation
            phi_ki_2x = np.sqrt(2.0) * supp(phi[ki], 2 * x_m, 0.0, 1.0)
            for i2 in range(k):
                proj = (wm * supp(phi[i2], x_m, 0.0, 1.0) * phi_ki_2x).sum()
                psi1[ki] -= proj * phi[i2]
                psi2[ki] -= proj * phi[i2]
            for j in range(ki):
                proj = (wm * supp(psi1[j], x_m, 0.0, 0.5) * phi_ki_2x).sum()
                psi1[ki] -= proj * psi1[j]
                psi2[ki] -= proj * psi2[j]
            n1 = (wm * supp(psi1[ki], x_m, 0.0, 0.5) ** 2).sum()
            n2 = (wm * supp(psi2[ki], x_m, 0.5, 1.0) ** 2).sum()
            norm = math.sqrt(n1 + n2)
            psi1[ki] /= norm
            psi2[ki] /= norm
            psi1[ki][np.abs(psi1[ki]) < 1e-8] = 0.0
            psi2[ki][np.abs(psi2[ki]) < 1e-8] = 0.0
        return phi, psi1, psi2

    raise ValueError(f"base {base!r} not supported")


@lru_cache(maxsize=None)
def get_filter(base: str, k: int):
    """Two-scale filter matrices H0/H1/G0/G1 (+ PHI0/PHI1) of the k-term
    multiwavelet basis (reference MultiWaveletCorrelation.py:145-198)."""
    phi, psi1, psi2 = get_phi_psi(k, base)
    ev = lambda rows, x: np.polynomial.polynomial.polyval(
        x, rows.T)                                          # (k, len(x))
    H0 = np.zeros((k, k))
    H1 = np.zeros((k, k))
    G0 = np.zeros((k, k))
    G1 = np.zeros((k, k))

    def psi_eval(x):
        lower = ev(psi1, x) * (x <= 0.5)
        upper = ev(psi2, x) * (x > 0.5)
        return lower + upper

    if base == "legendre":
        y, w = np.polynomial.legendre.leggauss(k)
        x_m = (y + 1.0) / 2.0
        wm = w / 2.0
    elif base == "chebyshev":
        kuse = 2 * k
        i = np.arange(kuse)
        x_m = (np.cos((2 * i + 1) * math.pi / (2 * kuse)) + 1.0) / 2.0
        wm = np.full(kuse, math.pi / kuse / 2.0)
    else:
        raise ValueError(f"base {base!r} not supported")

    phi_at = lambda x: ev(phi, x)
    rt2 = math.sqrt(2.0)
    for ki in range(k):
        for kpi in range(k):
            H0[ki, kpi] = (wm * phi_at(x_m / 2)[ki]
                           * phi_at(x_m)[kpi]).sum() / rt2
            G0[ki, kpi] = (wm * psi_eval(x_m / 2)[ki]
                           * phi_at(x_m)[kpi]).sum() / rt2
            H1[ki, kpi] = (wm * phi_at((x_m + 1) / 2)[ki]
                           * phi_at(x_m)[kpi]).sum() / rt2
            G1[ki, kpi] = (wm * psi_eval((x_m + 1) / 2)[ki]
                           * phi_at(x_m)[kpi]).sum() / rt2
    if base == "legendre":
        PHI0 = np.eye(k)
        PHI1 = np.eye(k)
    else:
        PHI0 = np.zeros((k, k))
        PHI1 = np.zeros((k, k))
        for ki in range(k):
            for kpi in range(k):
                PHI0[ki, kpi] = 2 * (wm * phi_at(2 * x_m)[ki]
                                     * phi_at(2 * x_m)[kpi]).sum()
                PHI1[ki, kpi] = 2 * (wm * phi_at(2 * x_m - 1)[ki]
                                     * phi_at(2 * x_m - 1)[kpi]).sum()
        PHI0[np.abs(PHI0) < 1e-8] = 0.0
        PHI1[np.abs(PHI1) < 1e-8] = 0.0
    for m in (H0, H1, G0, G1):
        m[np.abs(m) < 1e-8] = 0.0
    return H0, H1, G0, G1, PHI0, PHI1


@lru_cache(maxsize=None)
def _bank(base: str, k: int):
    """(ec_s, ec_d, rc_e, rc_o) float32 arrays for the transform ladders."""
    H0, H1, G0, G1, PHI0, PHI1 = get_filter(base, k)
    ec_s = np.concatenate((H0.T, H1.T), axis=0)
    ec_d = np.concatenate((G0.T, G1.T), axis=0)
    H0r, G0r = H0 @ PHI0, G0 @ PHI0
    H1r, G1r = H1 @ PHI1, G1 @ PHI1
    for m in (H0r, G0r, H1r, G1r):
        m[np.abs(m) < 1e-8] = 0.0
    rc_e = np.concatenate((H0r, G0r), axis=0)
    rc_o = np.concatenate((H1r, G1r), axis=0)
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(ec_s), f32(ec_d), f32(rc_e), f32(rc_o)


def wavelet_transform(x: torch.Tensor, ec_s, ec_d):
    """One decomposition level: (B, N, c, k) -> detail d, smooth s at N/2."""
    xa = torch.cat([x[:, ::2], x[:, 1::2]], dim=-1)        # (B, N/2, c, 2k)
    return xa @ ec_d, xa @ ec_s


def even_odd(x: torch.Tensor, rc_e, rc_o, k: int) -> torch.Tensor:
    """One reconstruction level: (B, N, c, 2k) -> (B, 2N, c, k), the even
    and odd outputs interleaved."""
    x_e, x_o = x @ rc_e, x @ rc_o
    b, n, c, _ = x_e.shape
    return torch.stack([x_e, x_o], dim=2).reshape(b, 2 * n, c, k)


class _Bank(nn.Module):
    """The filter bank's (ec_s, ec_d, rc_e, rc_o) on a device, made once."""

    def _init_bank(self, base: str, k: int) -> None:
        self.base, self.k = base, k
        self._filters: Dict[object, Tuple[torch.Tensor, ...]] = {}

    def filters(self, device) -> Tuple[torch.Tensor, ...]:
        if device not in self._filters:
            self._filters[device] = tuple(
                torch.from_numpy(a).to(device) for a in _bank(self.base,
                                                              self.k))
        return self._filters[device]


class SparseKernelFT1d(nn.Module):
    """A frequency-domain linear map on the lowest `alpha` modes
    (`weights_real`, `weights_imag`, (c*k, c*k, alpha))."""

    def __init__(self, k: int, alpha: int, g: torch.Generator, c: int = 1):
        super().__init__()
        self.alpha = alpha
        ck = c * k
        scale = 1.0 / (ck * ck)
        self.weights_real = uniform_param((ck, ck, alpha), scale, g)
        self.weights_imag = uniform_param((ck, ck, alpha), scale, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:      # (B, N, c, k)
        b, n, c, k = x.shape
        ck = c * k
        w = torch.complex(self.weights_real, self.weights_imag)
        xf = torch.fft.rfft(x.reshape(b, n, ck).transpose(1, 2).float())
        l = min(self.alpha, n // 2 + 1)
        out = torch.einsum("bix,iox->box", xf[:, :, :l], w[:, :, :l])
        out_ft = torch.nn.functional.pad(out, (0, n // 2 + 1 - l))
        y = torch.fft.irfft(out_ft, n=n)
        return y.transpose(1, 2).reshape(b, n, c, k).to(x.dtype)


class MWT_CZ1d(_Bank):
    """Decompose ns levels, sparse kernels A, B, C per level and `T0` at
    the coarsest scale, reconstruct."""

    def __init__(self, g: torch.Generator, k: int = 3, alpha: int = 64,
                 L: int = 0, c: int = 1, base: str = "legendre"):
        super().__init__()
        self._init_bank(base, k)
        self.L = L
        self.A = SparseKernelFT1d(k, alpha, g, c)
        self.B = SparseKernelFT1d(k, alpha, g, c)
        self.C = SparseKernelFT1d(k, alpha, g, c)
        self.T0 = lecun_linear(k, k, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:      # (B, N, c, k)
        ec_s, ec_d, rc_e, rc_o = self.filters(x.device)
        n = x.shape[1]
        ns = int(math.floor(math.log2(n)))
        nl = 2 ** int(math.ceil(math.log2(n)))
        if nl > n:
            x = torch.cat([x, x[:, : nl - n]], dim=1)
        ud, us = [], []
        for _ in range(ns - self.L):
            d, x = wavelet_transform(x, ec_s, ec_d)
            ud.append(self.A(d) + self.B(x))
            us.append(self.C(d))
        x = dense(x, self.T0, F32)
        for i in range(ns - 1 - self.L, -1, -1):
            x = torch.cat([x + us[i], ud[i]], dim=-1)
            x = even_odd(x, rc_e, rc_o, self.k)
        return x[:, :n]


class MultiWaveletTransform(nn.Module):
    """(B, L, H, E) values -> `Lk0` to c*k channels -> nCZ MWT blocks
    (`MWT_CZ_<i>`, relu between) -> `Lk1` back; (B, L, H, E)."""

    def __init__(self, g: torch.Generator, ich: int = 1, k: int = 8,
                 alpha: int = 16, c: int = 128, nCZ: int = 1, L: int = 0,
                 base: str = "legendre"):
        super().__init__()
        self.c, self.k, self.nCZ = c, k, nCZ
        self.Lk0 = lecun_linear(ich, c * k, g)
        for i in range(nCZ):
            setattr(self, f"MWT_CZ_{i}", MWT_CZ1d(g, k, alpha, L, c, base))
        self.Lk1 = lecun_linear(c * k, ich, g)

    def forward(self, q, k_in, v) -> torch.Tensor:
        b, l, h, e = q.shape
        s = v.shape[1]
        if l > s:
            v = torch.cat([v, v.new_zeros(b, l - s, h, e)], dim=1)
        else:
            v = v[:, :l]
        vv = dense(v.reshape(b, l, -1), self.Lk0, F32).reshape(
            b, l, self.c, self.k)
        for i in range(self.nCZ):
            vv = getattr(self, f"MWT_CZ_{i}")(vv)
            if i < self.nCZ - 1:
                vv = torch.relu(vv)
        out = dense(vv.reshape(b, l, -1), self.Lk1, F32)
        return out.reshape(b, l, -1, e)


class MultiWaveletCross(_Bank):
    """q, k and v projected (`Lq`, `Lk`, `Lv`) to c*k channels and
    decomposed; the weightless Fourier cross attention (`attn1`..`attn4`)
    per level on the detail and smooth parts; reconstructed and projected
    (`out`). Returns (B, N, ich)."""

    def __init__(self, in_channels: int, out_channels: int, modes: int,
                 g: torch.Generator, c: int = 64, k: int = 8, ich: int = 512,
                 L: int = 0, base: str = "legendre",
                 activation: str = "tanh"):
        super().__init__()
        self._init_bank(base, k)
        self.c, self.L = c, L
        self.Lq = lecun_linear(ich, c * k, g)
        self.Lk = lecun_linear(ich, c * k, g)
        self.Lv = lecun_linear(ich, c * k, g)
        for i in (1, 2, 3, 4):
            setattr(self, f"attn{i}", FourierCrossAttentionW(
                in_channels, out_channels, modes, activation))
        self.out = lecun_linear(c * k, ich, g)

    def forward(self, q, k_in, v) -> torch.Tensor:
        ec_s, ec_d, rc_e, rc_o = self.filters(q.device)
        b, n = q.shape[:2]
        s = k_in.shape[1]
        proj = lambda lin, z: dense(z.reshape(z.shape[0], z.shape[1], -1),
                                    lin, F32).reshape(z.shape[0], z.shape[1],
                                                      self.c, self.k)
        qq, kk, vv = proj(self.Lq, q), proj(self.Lk, k_in), proj(self.Lv, v)
        if n > s:
            zeros = vv.new_zeros(b, n - s, self.c, self.k)
            vv = torch.cat([vv, zeros], dim=1)
            kk = torch.cat([kk, zeros], dim=1)
        else:
            vv, kk = vv[:, :n], kk[:, :n]
        ns = int(math.floor(math.log2(n)))
        nl = 2 ** int(math.ceil(math.log2(n)))
        if nl > n:
            ext = lambda z: torch.cat([z, z[:, : nl - n]], dim=1)
            qq, kk, vv = ext(qq), ext(kk), ext(vv)
        levels = ns - self.L
        ladder = []
        for z in (qq, kk, vv):
            parts = []
            for _ in range(levels):
                d, z = wavelet_transform(z, ec_s, ec_d)
                parts.append((d, z))
            ladder.append((parts, z))
        (pq, qq), (pk, kk), (pv, vv) = ladder
        ud, us = [], []
        for i in range(levels):
            ud.append(self.attn1(pq[i][0], pk[i][0], pv[i][0])
                      + self.attn2(pq[i][1], pk[i][1], pv[i][1]))
            us.append(self.attn3(pq[i][0], pk[i][0], pv[i][0]))
        vv = self.attn4(qq, kk, vv)
        for i in range(ns - 1 - self.L, -1, -1):
            vv = torch.cat([vv + us[i], ud[i]], dim=-1)
            vv = even_odd(vv, rc_e, rc_o, self.k)
        return dense(vv[:, :n].reshape(b, n, -1), self.out, F32)
