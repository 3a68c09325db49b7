"""Model registry (counterpart of sie_tpu/models/registry.py): the models
and the deep backbones (`DNNS`, as the JAX package's `DNN_REGISTRY`:
the stock five and the Autoformer, FEDformer, ETSformer, Pyraformer and
Crossformer classifiers of models/extra/backbones.py). Other names raise."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.device import DeviceLike, resolve_device
from sie_tpu_torch.models.info import ModelInfo
from sie_tpu_torch.parallel import comm

MODELS = ("InterpGN", "SBM", "LTS", "DNN", "EEGCNN")
EXTRA_DNNS = ("Autoformer", "FEDformer", "ETSformer", "Pyraformer",
              "Crossformer")
DNNS = ("Transformer", "FCN", "ResNet", "TimesNet", "PatchTST") + EXTRA_DNNS


def build_dnn(cfg: Config, g: torch.Generator) -> nn.Module:
    """The backbone `cfg.dnn_type`, one of DNNS."""
    if cfg.dnn_type not in DNNS:
        raise ValueError(f"dnn_type {cfg.dnn_type!r} not in {DNNS}")
    if cfg.dnn_type in EXTRA_DNNS:
        from sie_tpu_torch.models.extra.backbones import BACKBONES
        return BACKBONES[cfg.dnn_type](cfg, g)
    if cfg.dnn_type == "FCN":
        from sie_tpu_torch.models.fcn import FullyConvNetwork
        return FullyConvNetwork(cfg, g)
    if cfg.dnn_type == "ResNet":
        from sie_tpu_torch.models.resnet import ResNet
        return ResNet(cfg, g)
    if cfg.dnn_type == "TimesNet":
        from sie_tpu_torch.models.timesnet import TimesNet
        return TimesNet(cfg, g)
    if cfg.dnn_type == "PatchTST":
        from sie_tpu_torch.models.patchtst import PatchTST
        return PatchTST(cfg, g)
    from sie_tpu_torch.models.transformer import Transformer
    return Transformer(cfg, g)


def forward_model(model: nn.Module, x, padding_mask, **kw):
    """model(x, padding_mask, **kw). Under a step's 'seq' axis
    (parallel/comm.py) x and the mask are this rank's time block: a model
    with a time-sharded form (`takes_time_blocks`: the Transformer and
    FCN backbones, the SBM, and InterpGN and DNN, which pass the block
    on) takes it as it is; any other runs on the whole time axis
    (`comm.whole_time`), every 'seq' rank repeating it."""
    if getattr(model, "takes_time_blocks", False):
        return model(x, padding_mask, **kw)
    return comm.whole_time(lambda xs, ms: model(xs, ms, **kw), x,
                           padding_mask)


def call_dnn(dnn: nn.Module, x, padding_mask,
             generator: Optional[torch.Generator]
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(logits, the sum of the losses its layers add in training, or None)
    of backbone `dnn` (through `forward_model`). A backbone whose
    `sows_losses` is true (the Transformer with a MoE encoder) takes a
    list `aux` that its layers append to, as flax layers sow into
    "losses"."""
    if not (dnn.training and getattr(dnn, "sows_losses", False)):
        return forward_model(dnn, x, padding_mask,
                             generator=generator), None
    sown: list = []
    logits = forward_model(dnn, x, padding_mask, generator=generator,
                           aux=sown)
    return logits, (torch.stack(sown).sum() if sown else None)


class DNNWrapper(nn.Module):
    """Bare backbone presented with the (logits, ModelInfo) interface."""

    takes_time_blocks = True     # `call_dnn` passes the block on

    def __init__(self, cfg: Config, g: torch.Generator):
        super().__init__()
        self.backbone = build_dnn(cfg, g)

    def forward(self, x, padding_mask=None, gating_value=None,
                generator: Optional[torch.Generator] = None):
        logits, aux = call_dnn(self.backbone, x, padding_mask, generator)
        return logits, ModelInfo(preds=logits,
                                 loss=torch.zeros(1, device=logits.device),
                                 aux_loss=aux)


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
        raise ValueError(f"model {cfg.model!r} not in {MODELS}")
    return model.to(dev).eval()
