"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at its
700 W power limit, and the least time of a count of work."""

from __future__ import annotations

BYTES_PER_S = 3.35e12
FLOPS = {
    "fp32": 67e12,            # CUDA cores
    "tf32": 495e12,           # tensor cores
    "bf16": 989e12,           # tensor cores
    # float32 products on the tensor cores as three TF32 products
    "f32_tc": 495e12 / 3,
}


def least_s(flops: float, nbytes: float, unit: str) -> float:
    """The larger of the operations over `unit`'s peak and the bytes over
    the memory's: the least time the card could take."""
    t_ops = flops / FLOPS[unit] if flops else 0.0
    return max(t_ops, nbytes / BYTES_PER_S)


def product_unit(amp: bool) -> str:
    """The fastest unit that computes a product at the configuration's
    precision: bf16 under amp, else float32 as three TF32 products."""
    return "bf16" if amp else "f32_tc"
