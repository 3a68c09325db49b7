"""InterpGN — Gini-gated mixture of a Shapelet Bottleneck Model and a deep
backbone (counterpart of sie_tpu/models/interpgn.py).

Gate: per-sample Gini index of the SBM softmax, eta = (C*sum(p^2) - 1)/(C - 1);
hard gating (when `gating_value` is not None) forces eta=1 for samples above
the threshold. Output = eta * sbm_logits + (1 - eta) * deep_logits.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.models.info import ModelInfo
from sie_tpu_torch.models.sbm import ShapeBottleneckModel


class InterpGN(nn.Module):
    # under a step's 'seq' axis: the SBM gathers its input itself and
    # `call_dnn` passes the time block on to the backbone
    takes_time_blocks = True

    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        from sie_tpu_torch.models.registry import build_dnn
        self.sbm = ShapeBottleneckModel(cfg, g, variant="sbm")
        self.deep_model = build_dnn(cfg, g)

    def forward(self, x, padding_mask=None,
                gating_value: Optional[float] = None,
                generator: Optional[torch.Generator] = None):
        """`generator` draws the dropout masks in training (see
        models/layers.py); at eval nothing is drawn."""
        sbm_out, info = self.sbm(x, padding_mask, generator=generator)
        from sie_tpu_torch.models.registry import call_dnn
        deep_out, aux = call_dnn(self.deep_model, x, padding_mask, generator)
        c = sbm_out.shape[-1]
        probs = torch.softmax(sbm_out, dim=-1)
        gini = probs.square().sum(dim=-1, keepdim=True)
        eta = (c * gini - 1.0) / (c - 1.0)
        if gating_value is not None:
            hard = (eta > gating_value).to(eta.dtype)
            eta = hard + eta * (1.0 - hard)
        out = eta * sbm_out + (1.0 - eta) * deep_out
        return out, ModelInfo(d=info.d, p=info.p, eta=eta,
                              shapelet_preds=sbm_out, dnn_preds=deep_out,
                              preds=out, loss=info.loss, aux_loss=aux)
