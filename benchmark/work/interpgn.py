"""Work of an InterpGN training step with the Transformer or the FCN
expert, from its shapes: groups of (group, flops, bytes, unit). A
group's least time is `peaks.least_s` of it; the step's is their sum.
Not counted: LayerNorm, BatchNorm, GELU, ReLU, the embedding's
positions, the softmax of the gate, casts, the loss.

- "l1": the banks' sliding distances (work/l1.py);
- "gemm": every product of the expert but the FCN's convolutions, and
  the SBM's classifier, at the configuration's precision; a backward
  product is twice its forward (input and weight gradients) except the
  Transformer's embedding's, whose input needs no gradient;
- "conv": the FCN's VALID convolutions, counted as "gemm" is (the first
  one's backward once);
- "attention": work/attention.py for each encoder layer;
- "ste": the straight-through chain over the windows, as bytes: it reads
  the distances (B, n, C, W) once and writes their gradient once;
- "optimizer": Adam, as bytes: it reads the parameter, its gradient and
  both moments, and writes the parameter and both moments (28 bytes a
  parameter).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from benchmark.peaks import product_unit
from benchmark.reference.interpgn import (FCN_WIDTHS, bank_shapes,
                                          fcn_kernels, param_spec)
from benchmark.work import attention, l1

Group = Tuple[str, float, float, str]


def _fcn_convs(cfg: Dict, rows: int) -> List[int]:
    """Forward flops of each of the FCN's convolutions."""
    t, c_in, out = cfg["seq_len"], cfg["enc_in"], []
    for width, taps in zip(FCN_WIDTHS, fcn_kernels(cfg)):
        t -= taps - 1                                   # VALID
        out.append(2 * rows * t * c_in * width * taps)
        c_in = width
    return out


def _gemm_forward(cfg: Dict, rows: int) -> Tuple[float, float]:
    """(flops of the products but the embedding's and the convolutions',
    the embedding's)."""
    t, c, k = cfg["seq_len"], cfg["enc_in"], cfg["num_class"]
    feats = cfg["num_shapelet"] * c * len(cfg["shapelet_lengths"])
    head = 2 * rows * feats * k
    if cfg["dnn_type"] == "FCN":
        return 2 * rows * FCN_WIDTHS[-1] * k + head, 0
    d, f = cfg["d_model"], cfg["d_ff"]
    per_layer = 2 * rows * t * (4 * d * d + 2 * d * f)
    rest = cfg["e_layers"] * per_layer + 2 * rows * t * d * k + head
    return rest, 2 * rows * t * 3 * c * d


def _distances(cfg: Dict, rows: int) -> int:
    """Elements of every bank's distances (B, n, C, W)."""
    t = cfg["seq_len"]
    return sum(rows * cfg["num_shapelet"] * cfg["enc_in"]
               * l1.windows(t, length, stride)
               for length, stride in bank_shapes(cfg))


def l1_groups(cfg: Dict, rows: int, backward: bool) -> List[Group]:
    out = []
    for length, stride in bank_shapes(cfg):
        shape = (rows, cfg["enc_in"], cfg["seq_len"], cfg["num_shapelet"],
                 length, stride)
        out.append(("l1",) + l1.forward(*shape)[:2] + ("fp32",))
        if backward:
            out.append(("l1",) + l1.backward(*shape)[:2] + ("fp32",))
    return out


def attention_groups(cfg: Dict, rows: int, backward: bool) -> List[Group]:
    if cfg["dnn_type"] != "Transformer":
        return []
    bh = rows * cfg["n_heads"]
    dk = cfg["d_model"] // cfg["n_heads"]
    parts = ((attention.forward, attention.backward) if backward
             else (attention.forward,))
    return [("attention",) + part(bh, cfg["seq_len"], dk, cfg["amp"])
            for _ in range(cfg["e_layers"]) for part in parts]


def conv_groups(cfg: Dict, rows: int, unit: str) -> List[Group]:
    if cfg["dnn_type"] != "FCN":
        return []
    convs = _fcn_convs(cfg, rows)
    return [("conv", 3 * sum(convs[1:]) + 2 * convs[0], 0.0, unit)]


def train_step(cfg: Dict, rows: int) -> List[Group]:
    unit = product_unit(cfg["amp"])
    rest, emb = _gemm_forward(cfg, rows)
    n_params = sum(math.prod(shape) for _, shape, _, _ in param_spec(cfg))
    return (l1_groups(cfg, rows, True)
            + [("gemm", 3 * rest + 2 * emb, 0.0, unit)]
            + conv_groups(cfg, rows, unit)
            + attention_groups(cfg, rows, True)
            + [("ste", 0.0, 8.0 * _distances(cfg, rows), "fp32"),
               ("optimizer", 0.0, 28.0 * n_params, "fp32")])

