"""The reference's training steps: a model module's loss (`loss(params,
cfg, x, y, mask, w, beta, prec)`), its gradients by autograd, optax's
clip by global norm (where the configuration sets one) and Adam (b1 0.9,
b2 0.999, eps 1e-8 outside the root, a constant learning rate), written
out in tensor operations."""

from __future__ import annotations

from typing import Dict, List

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def steps(model, params0: Dict[str, torch.Tensor], cfg: Dict,
          batches: List, beta: float, prec: str) -> Dict:
    """Runs len(batches) steps from params0. Returns the losses, each leaf's
    gradient at the first step (on the host) and its norm, and each leaf's
    distance from params0 after the last step."""
    if cfg.get("lr_decay") or cfg.get("lr_warmup_epochs", 0):
        raise ValueError("the reference's Adam has a constant rate")
    names = list(params0)
    params = {n: params0[n].detach().clone().requires_grad_(True)
              for n in names}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    lr, clip = cfg["lr"], cfg.get("gradient_clip", 0.0)
    losses, first = [], None
    for t, (x, y, mask, w) in enumerate(batches, start=1):
        loss = model.loss(params, cfg, x, y, mask, w, beta, prec)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        losses.append(float(loss.detach()))
        if clip > 0:
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            if norm >= clip:
                grads = [g / norm * clip for g in grads]
        if first is None:
            first = {n: g.detach().cpu() for n, g in zip(names, grads)}
        with torch.no_grad():
            for n, g in zip(names, grads):
                m[n].mul_(B1).add_(g, alpha=1 - B1)
                v[n].mul_(B2).addcmul_(g, g, value=1 - B2)
                mhat = m[n] / (1 - B1 ** t)
                vhat = v[n] / (1 - B2 ** t)
                params[n] -= lr * mhat / (vhat.sqrt() + EPS)
        del grads, loss
    change = {n: float((params[n].detach() - params0[n]).norm())
              for n in names}
    return {"losses": losses, "grads": first,
            "grad_norms": {n: float(g.norm()) for n, g in first.items()},
            "change": change}
