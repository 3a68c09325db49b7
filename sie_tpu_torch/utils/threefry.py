"""`jax.random.normal(jax.random.PRNGKey(seed), shape, float32)` in numpy
and torch, bit for bit up to the inverse error function.

The JAX package draws one fixed constant from a seed: the LSH attention's
random rotations (`sie_tpu/models/extra/attention_variants.py`). It is
not a parameter, so a model's weights do not carry it, and a model trained
there buckets its keys by exactly those rotations. This module repeats the
draw as JAX (0.4.x onward, `jax_threefry_partitionable` on, its default
since 0.5) makes it:

- the key of `PRNGKey(seed)` is the pair of uint32 words (seed >> 32,
  seed & 0xffffffff);
- element i of the (row-major) shape draws the Threefry-2x32 block
  (20 rounds) of the counter (i >> 32, i & 0xffffffff) under that key,
  and its 32 random bits are the two output words xor'ed;
- `uniform(lo, hi)` takes the top 23 bits as the mantissa of a float in
  [1, 2), subtracts 1, scales to [lo, hi) and clamps at lo; `normal` sets
  lo to the float32 after -1 and hi to 1, and returns sqrt(2) *
  erfinv(u), float32 throughout;
- erfinv is XLA's float32 one (Giles' single-precision polynomials in
  w = -log1p(-u^2), split at w = 5), not `torch.special.erfinv`, whose
  approximation is another: the two differ by up to 2e-5 in the tails.

The bits and the uniforms are exact; the normals agree with JAX's within
an ulp or two of float32 (the host's log1p and sqrt).
"""

from __future__ import annotations

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1), uint32
    arrays, under key (k0, k1)."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(seed: int, shape) -> np.ndarray:
    """jax.random.bits(PRNGKey(seed), shape, uint32)."""
    key = ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(seed: int, shape, lo: float = 0.0, hi: float = 1.0
            ) -> np.ndarray:
    """jax.random.uniform(PRNGKey(seed), shape, float32, lo, hi)."""
    bits = random_bits(seed, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    f = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(lo), np.float32(hi)
    return np.maximum(lo, f * (hi - lo) + lo).astype(np.float32)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv (module docstring); +-inf at +-1."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5),
                     np.sqrt(w) - np.float32(3.0)).astype(np.float32)
        p = np.where(lt, np.float32(_ERFINV_LT5[0]),
                     np.float32(_ERFINV_GE5[0]))
        for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = np.where(lt, np.float32(a), np.float32(b)) + p * w
        out = (p * x).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), out)


def normal(seed: int, shape) -> torch.Tensor:
    """jax.random.normal(PRNGKey(seed), shape, float32), a CPU tensor."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    z = np.float32(np.sqrt(2.0)) * erfinv(uniform(seed, shape, lo, 1.0))
    return torch.from_numpy(z.astype(np.float32))
