"""Batched inference (counterpart of the `Predictor` of sie_tpu/serve.py).

The request discipline is the JAX package's:
- a request is zero-padded to the next power-of-two bucket up to
  `max_batch`; padded rows carry padding mask 1, and no model here mixes
  rows at inference, so they never change real rows;
- a request larger than `max_batch` goes through in chunks of `max_batch`;
- `gating_value` defaults to the config's value (pass None to disable);
- `fields` limits which interpretability outputs are copied to the host;
- `temperature` scales `probs` only.

The forward runs under `torch.inference_mode()` on the predictor's device,
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from sie_tpu_torch.compat.from_jax import load_jax_variables
from sie_tpu_torch.config import Config, config_from_json, config_to_json
from sie_tpu_torch.device import DeviceLike, resolve_device
from sie_tpu_torch.models.registry import build_model

__all__ = ["PredictOutput", "Predictor", "config_from_json", "config_to_json"]


@dataclasses.dataclass
class PredictOutput:
    """Numpy prediction bundle; interpretability fields are None for plain
    DNN models."""

    logits: np.ndarray                      # (B, num_class) f32
    probs: np.ndarray                       # (B, num_class) softmax
    classes: np.ndarray                     # (B,) argmax
    eta: Optional[np.ndarray] = None        # (B, 1) InterpGN gate utility
    p: Optional[np.ndarray] = None          # (B, F) shapelet RBF probs
    d: Optional[np.ndarray] = None          # (B, F) min distances
    shapelet_preds: Optional[np.ndarray] = None
    dnn_preds: Optional[np.ndarray] = None


_CFG = "cfg"   # predict() sentinel: take gating_value from the config


def _softmax_probs(logits: np.ndarray, temperature: float = 1.0
                   ) -> np.ndarray:
    """Host-side softmax with temperature scaling."""
    e = np.asarray(logits, np.float64) / temperature
    e -= e.max(-1, keepdims=True)
    p = np.exp(e)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


class Predictor:
    """Flax variables (`{"params": ..., "batch_stats": ...}` as numpy;
    batch_stats may be absent for a model without BatchNorm) ->
    bucket-padded batch inference on `device` (default the card), in eval
    mode: BatchNorm normalises with the running statistics."""

    _INFO_FIELDS = ("eta", "p", "d", "shapelet_preds", "dnn_preds")

    def __init__(self, cfg: Config, variables: Dict[str, Any],
                 device: DeviceLike = None, max_batch: int = 256,
                 temperature: float = 1.0):
        dev = resolve_device(device)
        model = load_jax_variables(build_model(cfg, "cpu"), variables)
        self._init(cfg, model.to(dev), dev, max_batch, temperature)

    @classmethod
    def from_module(cls, cfg: Config, module: nn.Module,
                    device: DeviceLike = None, max_batch: int = 256,
                    temperature: float = 1.0) -> "Predictor":
        """Serve a model built by `build_model` (weights initialised or
        loaded in PyTorch), with its BatchNorm buffers as they are."""
        self = cls.__new__(cls)
        dev = resolve_device(device)
        self._init(cfg, module.to(dev).eval(), dev, max_batch, temperature)
        return self

    def _init(self, cfg, model, device, max_batch, temperature):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1; got {max_batch}")
        self.cfg = cfg
        self.model = model.eval()
        self.device = device
        self.max_batch = max_batch
        self.temperature = float(temperature)   # scales probs only

    def _bucket(self, b: int) -> int:
        n = 1
        while n < min(b, self.max_batch):
            n *= 2
        return min(n, self.max_batch)

    def predict(self, x: np.ndarray, padding_mask: Optional[np.ndarray] = None,
                gating_value=_CFG,
                fields: Optional[set] = None) -> PredictOutput:
        """x: (B, seq_len, enc_in). Returns per-sample outputs for all B rows
        whatever the bucket padding or chunking. `fields`: the
        interpretability outputs to copy to the host (None: all);
        logits/probs/classes always come back."""
        if gating_value is _CFG:
            gating_value = self.cfg.gating_value
        x = np.asarray(x, np.float32)
        want = (self.cfg.seq_len, self.cfg.enc_in)
        if x.ndim != 3 or x.shape[1:] != want:
            raise ValueError(f"x must be (B, {want[0]}, {want[1]}); got "
                             f"{tuple(x.shape)}")
        b = x.shape[0]
        if b == 0:
            z = np.zeros((0, self.cfg.num_class), np.float32)
            return PredictOutput(logits=z, probs=z,
                                 classes=np.zeros((0,), np.int64))
        if padding_mask is None:
            padding_mask = np.ones(x.shape[:2], np.float32)
        padding_mask = np.asarray(padding_mask, np.float32)
        pieces = [self._predict_chunk(x[lo: lo + self.max_batch],
                                      padding_mask[lo: lo + self.max_batch],
                                      gating_value, fields)
                  for lo in range(0, b, self.max_batch)]
        out = {k: (np.concatenate([p[k] for p in pieces])
                   if pieces[0][k] is not None else None)
               for k in pieces[0]}
        return PredictOutput(**out)

    def _predict_chunk(self, x, mask, gating_value, fields) -> Dict[str, Any]:
        b = x.shape[0]
        bucket = self._bucket(b)
        if bucket > b:
            x = np.concatenate(
                [x, np.zeros((bucket - b,) + x.shape[1:], x.dtype)])
            mask = np.concatenate(
                [mask, np.ones((bucket - b,) + mask.shape[1:], mask.dtype)])
        with torch.inference_mode():
            xd = torch.from_numpy(x).to(self.device)
            md = torch.from_numpy(mask).to(self.device)
            logits, info = self.model(xd, md, gating_value=gating_value)
            out = {"logits": logits.float()[:b].cpu().numpy()}
            for k in self._INFO_FIELDS:
                a = getattr(info, k)
                keep = a is not None and (fields is None or k in fields)
                out[k] = a.float()[:b].cpu().numpy() if keep else None
        out["probs"] = _softmax_probs(out["logits"], self.temperature)
        out["classes"] = np.argmax(out["logits"], -1)
        return out
