"""Work of the sliding L1 shapelet distance of one bank (kernels K1
forward, K2 backward; K3/K4 run the same per bank), from its shapes.

A tap, |x - s| added to a sum, is two flops on the CUDA cores (float32).
The forward reads x (B, C, T) and the bank (n, C, L) once and writes the
distances (B, n, C, W); the backward reads x, the bank and the
distances' gradient and writes the bank's gradient."""

from __future__ import annotations


def windows(t: int, length: int, stride: int) -> int:
    return (t - length) // stride + 1


def taps(b: int, c: int, t: int, n: int, length: int, stride: int) -> int:
    return b * n * c * windows(t, length, stride) * length


def forward(b, c, t, n, length, stride):
    """(flops, bytes, unit) of one bank's forward."""
    w = windows(t, length, stride)
    nbytes = 4 * (b * c * t + n * c * length + b * n * c * w)
    return 2 * taps(b, c, t, n, length, stride), nbytes, "fp32"


def backward(b, c, t, n, length, stride):
    """(flops, bytes, unit) of one bank's gradient."""
    w = windows(t, length, stride)
    nbytes = 4 * (b * c * t + 2 * n * c * length + b * n * c * w)
    return 2 * taps(b, c, t, n, length, stride), nbytes, "fp32"
