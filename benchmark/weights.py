"""Weights and rows made from the seed on the device, in a few large
calls: one normal and one uniform draw for all parameters, sliced and
scaled per `reference.param_spec`; rows and labels in one call each."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.interpgn import param_spec


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = param_spec(cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = {kind: sum(math.prod(s) for _, s, k, _ in spec if k == kind)
             for kind in ("normal", "uniform")}
    draws = {"normal": torch.randn(sizes["normal"], generator=g,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=g,
                                   device=device).mul_(2).sub_(1)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, kind, scale in spec:
        if kind == "const":
            out[name] = torch.full(shape, scale, device=device)
            continue
        n = math.prod(shape)
        out[name] = draws[kind][at[kind]:at[kind] + n].view(shape) * scale
        at[kind] += n
    return out


def make_rows(cfg: Dict, n: int, seed: int, device):
    """(x (n, T, C) f32, labels (n,) int64) of a generator seeded apart
    from the weights'."""
    g = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    x = torch.randn((n, cfg["seq_len"], cfg["enc_in"]), generator=g,
                    device=device)
    y = torch.randint(0, cfg["num_class"], (n,), generator=g, device=device)
    return x, y


def load_into(model, weights: Dict[str, torch.Tensor]) -> None:
    """Copies the weights into the program's model, whose parameters must
    have the same names and shapes."""
    named = dict(model.named_parameters())
    if sorted(named) != sorted(weights) or any(
            tuple(named[n].shape) != tuple(w.shape)
            for n, w in weights.items()):
        raise ValueError("the benchmark's weights do not match the model's "
                         "parameters")
    with torch.no_grad():
        for n, w in weights.items():
            named[n].copy_(w)
