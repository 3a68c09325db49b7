"""Model registry (counterpart of sie_tpu/models/registry.py): the models
this slice ports. Other names raise NotImplementedError."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.device import DeviceLike, resolve_device
from sie_tpu_torch.models.info import ModelInfo
from sie_tpu_torch.models.layers import not_ported

MODELS = ("InterpGN", "SBM", "LTS", "DNN", "EEGCNN")
DNNS = ("Transformer", "FCN", "ResNet")


def build_dnn(cfg: Config, g: torch.Generator) -> nn.Module:
    """The backbone `cfg.dnn_type`, one of DNNS."""
    if cfg.dnn_type not in DNNS:
        raise not_ported(f"dnn_type={cfg.dnn_type!r}")
    if cfg.dnn_type == "FCN":
        from sie_tpu_torch.models.fcn import FullyConvNetwork
        return FullyConvNetwork(cfg, g)
    if cfg.dnn_type == "ResNet":
        from sie_tpu_torch.models.resnet import ResNet
        return ResNet(cfg, g)
    from sie_tpu_torch.models.transformer import Transformer
    return Transformer(cfg, g)


class DNNWrapper(nn.Module):
    """Bare backbone presented with the (logits, ModelInfo) interface."""

    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        self.backbone = build_dnn(cfg, g)

    def forward(self, x, padding_mask=None, gating_value=None,
                generator: Optional[torch.Generator] = None):
        logits = self.backbone(x, padding_mask, generator)
        return logits, ModelInfo(preds=logits,
                                 loss=torch.zeros(1, device=logits.device))


def build_model(cfg: Config, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """The model `cfg.model` in eval mode on `device` (default the card),
    its weights drawn from `generator` (default seed 0). Training calls
    `.train()` on it and passes its forward a dropout generator."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(0) if generator is None else generator
    if cfg.model == "InterpGN":
        from sie_tpu_torch.models.interpgn import InterpGN
        model = InterpGN(cfg, g)
    elif cfg.model in ("SBM", "LTS"):
        from sie_tpu_torch.models.sbm import ShapeBottleneckModel
        model = ShapeBottleneckModel(cfg, g, variant=cfg.model.lower())
    elif cfg.model == "DNN":
        model = DNNWrapper(cfg, g)
    elif cfg.model == "EEGCNN":
        from sie_tpu_torch.models.eegcnn import EEGCNNTransformer
        model = EEGCNNTransformer(cfg, g)
    else:
        raise not_ported(f"model={cfg.model!r}")
    return model.to(dev).eval()
