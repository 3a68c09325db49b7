"""ModelInfo — the auxiliary-output bundle every model returns (counterpart
of sie_tpu/models/info.py). Fields default to None so DNN-style models can
return a bare-logits info."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class ModelInfo:
    d: Optional[torch.Tensor] = None              # min distances   (B, F)
    p: Optional[torch.Tensor] = None              # max RBF probs   (B, F)
    eta: Optional[torch.Tensor] = None            # gating utility  (B, 1)
    shapelet_preds: Optional[torch.Tensor] = None  # SBM logits
    dnn_preds: Optional[torch.Tensor] = None      # deep-branch logits
    preds: Optional[torch.Tensor] = None          # blended logits
    loss: Optional[torch.Tensor] = None           # model reg loss, shape (1,)
    # sum of the losses the layers add in training (the MoE load balance;
    # flax's "losses" collection), a 0-d f32 tensor; None in eval
    aux_loss: Optional[torch.Tensor] = None
