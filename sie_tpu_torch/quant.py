"""Weight-only int8 quantisation for serving bundles (counterpart of
sie_tpu/quant.py), in numpy.

- Symmetric per-channel int8: one f32 scale per slice of the LAST axis of
  the flax layout (Dense (in, out), Conv (k, in, out), a shapelet bank (n,
  C, L)); dequant = q.astype(f32) * scale.
- Size gate, not name gate: every float leaf with ndim >= 2 and >=
  `min_size` elements is quantised; `exclude` path substrings opt tensors
  out; batch_stats stay f32.
- A bundle's `weights_q.npz` has one entry per leaf, keyed by the
  '/'-joined flax path, and `<path>.q` + `<path>.scale` for a quantised
  leaf: the JAX package's keys, so either package loads the other's file.

The port's `Predictor` keeps the int8 tensors on its device and
dequantises them inside each forward (`compat/from_jax.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np


@dataclasses.dataclass
class QTensor:
    """Symmetric per-channel int8 tensor: dequant = q.astype(f32) * scale."""

    q: np.ndarray       # int8, original shape
    scale: np.ndarray   # f32, shape (1, ..., 1, C_last)

    @property
    def shape(self):
        return self.q.shape


def quantize_tensor(w) -> QTensor:
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)), keepdims=True)
    scale = (amax / 127.0 + (amax == 0.0)).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return QTensor(q=q, scale=scale)


def dequantize_tensor(t: QTensor) -> np.ndarray:
    return np.asarray(t.q).astype(np.float32) * np.asarray(t.scale)


def _is_q(x) -> bool:
    return isinstance(x, QTensor)


def _map(tree: Any, fn, path: str = "") -> Any:
    """fn(path, leaf) over the leaves of nested dicts (QTensors are
    leaves); paths are '/'-joined keys."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def quantize_params(params: Any, min_size: int = 4096,
                    exclude: Sequence[str] = ()) -> Any:
    """Replace large float leaves with QTensors (see module docstring)."""
    def rule(name: str, leaf):
        arr = np.asarray(leaf)
        if (np.issubdtype(arr.dtype, np.floating) and arr.ndim >= 2
                and arr.size >= min_size
                and not any(s in name for s in exclude)):
            return quantize_tensor(arr)
        return leaf

    return _map(params, rule)


# ---- flat .npz (de)serialisation -----------------------------------------

def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}

    def put(key, leaf):
        if _is_q(leaf):
            out[key + ".q"] = np.asarray(leaf.q)
            out[key + ".scale"] = np.asarray(leaf.scale)
        else:
            out[key] = np.asarray(leaf)

    _map(tree, put)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    qs = {k[:-2] for k in flat if k.endswith(".q")}
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        base = key[:-2] if key.endswith(".q") else (
            key[:-6] if key.endswith(".scale") else key)
        parts = base.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if base in qs:
            slot = node.setdefault(parts[-1], {})
            slot["q" if key.endswith(".q") else "scale"] = arr
        else:
            node[parts[-1]] = arr

    def rebuild(node):
        if isinstance(node, dict):
            if set(node) == {"q", "scale"} and getattr(
                    node["q"], "dtype", None) == np.int8:
                return QTensor(q=node["q"], scale=node["scale"])
            return {k: rebuild(v) for k, v in node.items()}
        return node

    return rebuild(tree)


def save_quantized(path: str, variables: Dict[str, Any],
                   min_size: int = 4096,
                   exclude: Sequence[str] = ()) -> None:
    """Write variables (params quantised, batch_stats kept f32) to .npz."""
    tree = dict(variables)
    tree["params"] = quantize_params(tree["params"], min_size, exclude)
    np.savez_compressed(path, **_flatten(tree))


def load_quantized(path: str) -> Dict[str, Any]:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)
