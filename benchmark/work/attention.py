"""Work of full attention over (BH, T, dk) (kernels K5/K7 forward, K6 or
K8a + K8b backward, K9/K10 under the flash flag), from its shapes.

Forward: S = Q K^T and O = P V, 4 BH T^2 dk flops. Backward: S once
more, dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q, 10 BH T^2 dk
flops, whatever a kernel recomputes beyond them. Each input read once
and each output written once, at the element size of the compute type
(the log-sum-exp beside them is not counted)."""

from __future__ import annotations

from benchmark.peaks import product_unit


def forward(bh: int, t: int, dk: int, amp: bool):
    """(flops, bytes, unit)."""
    size = 2 if amp else 4
    return 4 * bh * t * t * dk, size * 4 * bh * t * dk, product_unit(amp)


def backward(bh: int, t: int, dk: int, amp: bool):
    """(flops, bytes, unit): reads Q, K, V, O, dO; writes dQ, dK, dV."""
    size = 2 if amp else 4
    return 10 * bh * t * t * dk, size * 8 * bh * t * dk, product_unit(amp)
