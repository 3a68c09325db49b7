"""Batched inference (counterpart of sie_tpu/serve.py): `Predictor`, its
bundles, calibration and warm-up, and ahead-of-time programs served by
`CompiledPredictor`.

The request discipline is the JAX package's:
- a request is zero-padded to the next power-of-two bucket up to
  `max_batch`; padded rows carry padding mask 1, and no model here mixes
  rows at inference, so they never change real rows;
- a request larger than `max_batch` goes through in chunks of `max_batch`;
- `gating_value` defaults to the config's value (pass None to disable);
- `fields` limits which interpretability outputs are copied to the host;
- `temperature` scales `probs` only (`calibrate` fits it).

Bundles are the JAX package's directories, readable by either package:
`config.json`, `bundle_meta.json`, `calibration.json` when T != 1, and the
weights as `checkpoint.msgpack` (flax msgpack) or `weights_q.npz` (int8,
`quant.py`). A quantised bundle keeps its int8 tensors on the device and
dequantises them inside each forward (`compat/from_jax.py`).

`Predictor.export_stablehlo` keeps the JAX package's name, so callers port
unchanged, but writes `torch.export` programs: one `bucket_<b>.pt2` per
bucket, the weights as the program's own state (int8 plus the dequantise
in the graph for a quantised predictor), gating baked in, and the kernels
as the registered `sie_tpu_torch::` ops. `CompiledPredictor` serves such a
directory with `sie_tpu_torch.ops` and no model code.

The forward runs under `torch.inference_mode()` on the predictor's device,
the card unless the caller asks for the CPU. This module imports no model
code at import time.

Data-parallel serving: `mesh`, a single-process mesh over this process's
devices (`parallel.mesh.make_mesh(cfg, devices=[...])`), holds a replica
of the variables on each device of its 'data' axis (one model object for
replicas on the same device; a 'model', 'seq' or 'expert' axis is served
replicated, on the first device of each 'data' row). Buckets start at
the 'data' size and double, `max_batch` is rounded to a multiple of it,
and each device runs its row block of a chunk on a stream of its own;
the outputs are gathered in row order. The logits equal the predictor's without a mesh.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

import sie_tpu_torch.ops  # noqa: F401  registers the kernels as torch ops
from sie_tpu_torch import __version__, quant
from sie_tpu_torch.config import Config, config_from_json, config_to_json
from sie_tpu_torch.device import DeviceLike, resolve_device
from sie_tpu_torch.train import checkpoint as ckpt

__all__ = ["PredictOutput", "Predictor", "CompiledPredictor",
           "config_from_json", "config_to_json"]


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
_INFO_FIELDS = ("eta", "p", "d", "shapelet_preds", "dnn_preds")


def _softmax_probs(logits: np.ndarray, temperature: float = 1.0
                   ) -> np.ndarray:
    """Host-side softmax with temperature scaling."""
    e = np.asarray(logits, np.float64) / temperature
    e -= e.max(-1, keepdims=True)
    p = np.exp(e)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _empty(num_class: int) -> PredictOutput:
    z = np.zeros((0, num_class), np.float32)
    return PredictOutput(logits=z, probs=z, classes=np.zeros((0,), np.int64))


def _first_device(mesh, device: DeviceLike) -> torch.device:
    """The predictor's device: the mesh's first, or `device`."""
    if mesh is None or mesh.devices is None:
        return resolve_device(device)
    return resolve_device(_data_devices(mesh)[0])


def _data_devices(mesh) -> list:
    """The device of each 'data' index of a single-process mesh: the first
    along every other axis."""
    axes = mesh.axis_names
    index = tuple(slice(None) if a == "data" else 0 for a in axes)
    devs = mesh.devices[index]
    return list(np.atleast_1d(devs).reshape(-1))


def _on(stream):
    return contextlib.nullcontext() if stream is None else \
        torch.cuda.stream(stream)


def _pad(x: np.ndarray, mask: np.ndarray, bucket: int):
    """x and its mask padded with rows of zeros (mask 1) to `bucket`."""
    b = x.shape[0]
    if bucket > b:
        x = np.concatenate(
            [x, np.zeros((bucket - b,) + x.shape[1:], x.dtype)])
        mask = np.concatenate(
            [mask, np.ones((bucket - b,) + mask.shape[1:], mask.dtype)])
    return x, mask


class _Served(nn.Module):
    """The eval forward as an exported program runs it: gating baked in,
    the outputs a dict of f32 tensors."""

    def __init__(self, model: nn.Module, gating_value):
        super().__init__()
        self.model = model
        self.gating_value = gating_value

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        logits, info = self.model(x, mask, gating_value=self.gating_value)
        out = {"logits": logits.float()}
        for k in _INFO_FIELDS:
            v = getattr(info, k)
            if v is not None:
                out[k] = v.float()
        return out


class CompiledPredictor:
    """Serve a `Predictor.export_stablehlo` directory: `torch.export`
    programs with the weights as their state, loaded with
    `torch.export.load`; no model code, config or weight file is read. Same
    bucket-pad and chunk discipline as `Predictor`. The programs run on
    `device` (default the card), which must be the platform they were
    exported on."""

    def __init__(self, path: str, device: DeviceLike = None):
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.device = resolve_device(device)
        if self.manifest["platform"] != self.device.type:
            raise RuntimeError(
                f"artifact exported for {self.manifest['platform']!r} but "
                f"this predictor runs on {self.device.type!r}")
        self.programs = {
            b: torch.export.load(os.path.join(path, f"bucket_{b}.pt2"))
            for b in self.manifest["buckets"]}
        self._fns = {b: ep.module() for b, ep in self.programs.items()}

    def predict(self, x: np.ndarray,
                padding_mask: Optional[np.ndarray] = None) -> PredictOutput:
        m = self.manifest
        x = np.asarray(x, np.float32)
        if x.ndim != 3 or x.shape[1:] != (m["seq_len"], m["enc_in"]):
            raise ValueError(f"x must be (B, {m['seq_len']}, {m['enc_in']});"
                             f" got {tuple(x.shape)}")
        if x.shape[0] == 0:
            return _empty(m["num_class"])
        if padding_mask is None:
            padding_mask = np.ones(x.shape[:2], np.float32)
        buckets = m["buckets"]
        top = buckets[-1]
        pieces = []
        for lo in range(0, x.shape[0], top):
            b = min(top, x.shape[0] - lo)
            bucket = next(k for k in buckets if k >= b)
            xc, mc = _pad(x[lo: lo + top],
                          np.asarray(padding_mask[lo: lo + top], np.float32),
                          bucket)
            with torch.inference_mode():
                out = self._fns[bucket](
                    torch.from_numpy(xc).to(self.device),
                    torch.from_numpy(mc).to(self.device))
                pieces.append({k: v[:b].cpu().numpy()
                               for k, v in out.items()})
        merged = {k: np.concatenate([p[k] for p in pieces])
                  for k in pieces[0]}
        logits = merged.pop("logits")
        probs = _softmax_probs(logits, m.get("temperature", 1.0))
        return PredictOutput(logits=logits, probs=probs,
                             classes=np.argmax(logits, -1), **merged)


class Predictor:
    """Flax variables (`{"params": ..., "batch_stats": ...}` as numpy;
    batch_stats may be absent for a model without BatchNorm; params leaves
    may be `quant.QTensor`s) -> bucket-padded batch inference on `device`
    (default the card), in eval mode: BatchNorm normalises with the running
    statistics."""

    def __init__(self, cfg: Config, variables: Dict[str, Any],
                 device: DeviceLike = None, max_batch: int = 256,
                 temperature: float = 1.0, mesh=None):
        from sie_tpu_torch.compat.from_jax import load_jax_variables
        from sie_tpu_torch.models.registry import build_model
        dev = _first_device(mesh, device)
        model = load_jax_variables(build_model(cfg, "cpu"), variables)
        self._init(cfg, model.to(dev), dev, max_batch, temperature, mesh)

    @classmethod
    def from_module(cls, cfg: Config, module: nn.Module,
                    device: DeviceLike = None, max_batch: int = 256,
                    temperature: float = 1.0, mesh=None) -> "Predictor":
        """Serve a model built by `build_model` (weights initialised or
        loaded in PyTorch), with its BatchNorm buffers as they are."""
        self = cls.__new__(cls)
        dev = _first_device(mesh, device)
        self._init(cfg, module.to(dev).eval(), dev, max_batch, temperature,
                   mesh)
        return self

    def _init(self, cfg, model, device, max_batch, temperature, mesh=None):
        from sie_tpu_torch.compat.from_jax import is_quantized
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1; got {max_batch}")
        if mesh is not None and mesh.devices is None:
            raise ValueError("Predictor takes a mesh over this process's "
                             "devices: make_mesh(cfg, devices=[...])")
        self.cfg = cfg
        self.model = model.eval()
        self.device = device
        self.mesh = mesh
        self._dp = 1 if mesh is None else mesh.size("data")
        self.max_batch = max(max_batch // self._dp * self._dp, self._dp)
        self.temperature = float(temperature)   # scales probs only
        self.quantized = is_quantized(model)
        # (device, model, stream) of each 'data' block of a chunk
        self._replicas = [(device, self.model, None)]
        if mesh is not None:
            first = {device: self.model}
            self._replicas = []
            for d in _data_devices(mesh):
                d = resolve_device(d)
                if d not in first:
                    first[d] = copy.deepcopy(self.model).to(d)
                self._replicas.append(
                    (d, first[d],
                     torch.cuda.Stream(d) if d.type == "cuda" else None))

    # ---- construction -----------------------------------------------------
    @classmethod
    def from_checkpoint(cls, cfg: Config, ckpt_dir: Optional[str] = None,
                        **kw) -> "Predictor":
        """Load the best-params checkpoint an experiment saved. `ckpt_dir`
        defaults to the experiment's directory,
        cfg.checkpoint_dir/cfg.checkpoint_key(); cfg must carry the
        data-derived fields (seq_len, enc_in, num_class)."""
        if ckpt_dir is None:
            ckpt_dir = os.path.join(cfg.checkpoint_dir, cfg.checkpoint_key())
        restored = ckpt.load_checkpoint(ckpt_dir)
        if restored is None:
            raise FileNotFoundError(
                f"no checkpoint at {ckpt.checkpoint_path(ckpt_dir)}")
        variables = {"params": restored["params"]}
        if restored.get("batch_stats"):
            variables["batch_stats"] = restored["batch_stats"]
        return cls(cfg, variables, **kw)

    # ---- bundle export ------------------------------------------------------
    def save_bundle(self, path: str, quantize: bool = False,
                    min_size: int = 4096, exclude=()) -> None:
        """Self-contained serving directory: config.json + weights.
        quantize=True stores large weight tensors as per-channel int8
        (`quant.py`); the loaded Predictor keeps them int8 on its device.
        Only an f32 predictor exports."""
        from sie_tpu_torch.compat.from_jax import to_jax_variables
        if self.quantized:
            raise ValueError("a quantised predictor has no f32 weights to "
                             "export; export the bundle it was loaded from")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            f.write(config_to_json(self.cfg))
        with open(os.path.join(path, "bundle_meta.json"), "w") as f:
            json.dump({"framework": "sie_tpu_torch", "version": __version__,
                       "created_unix": int(time.time()),
                       "quantized": bool(quantize),
                       "temperature": self.temperature}, f, indent=1)
        cal = os.path.join(path, "calibration.json")
        if self.temperature != 1.0:
            with open(cal, "w") as f:
                json.dump({"temperature": self.temperature}, f)
        elif os.path.exists(cal):
            os.remove(cal)   # re-export must not resurrect a stale T
        qfile = os.path.join(path, "weights_q.npz")
        ckfile = ckpt.checkpoint_path(path)
        variables = to_jax_variables(self.model)
        if quantize:
            quant.save_quantized(qfile, variables, min_size=min_size,
                                 exclude=exclude)
            if os.path.exists(ckfile):   # in-place re-export: one format only
                os.remove(ckfile)
        else:
            ckpt.save_checkpoint(path, variables["params"],
                                 variables["batch_stats"])
            if os.path.exists(qfile):
                os.remove(qfile)

    @classmethod
    def load_bundle(cls, path: str, **kw) -> "Predictor":
        with open(os.path.join(path, "config.json")) as f:
            cfg = config_from_json(f.read())
        cal = os.path.join(path, "calibration.json")
        if os.path.exists(cal) and "temperature" not in kw:
            with open(cal) as f:
                kw["temperature"] = json.load(f)["temperature"]
        qpath = os.path.join(path, "weights_q.npz")
        if os.path.exists(qpath):
            restored = quant.load_quantized(qpath)
            variables = {"params": restored["params"]}
            if restored.get("batch_stats"):
                variables["batch_stats"] = restored["batch_stats"]
            return cls(cfg, variables, **kw)
        return cls.from_checkpoint(cfg, ckpt_dir=path, **kw)

    # ---- probability calibration --------------------------------------------
    def calibrate(self, x: np.ndarray, y: np.ndarray,
                  padding_mask: Optional[np.ndarray] = None,
                  bounds=(0.05, 20.0)) -> float:
        """Temperature scaling (Guo et al. 2017): fit one scalar T
        minimising the NLL of softmax(logits / T) on held-out (x, y), store
        it on the predictor and return it. `predict().probs` then uses T;
        `classes` and `logits` are unchanged. `save_bundle` persists T
        (calibration.json); `load_bundle` restores it."""
        logits = self.predict(np.asarray(x, np.float32),
                              padding_mask).logits.astype(np.float64)
        y = np.asarray(y).astype(np.int64)

        def nll(t):
            z = logits / t
            z = z - z.max(-1, keepdims=True)
            lse = np.log(np.exp(z).sum(-1))
            return float(np.mean(lse - z[np.arange(len(y)), y]))

        # golden-section on log T (nll is smooth, quasi-convex in log T)
        lo, hi = np.log(bounds[0]), np.log(bounds[1])
        gr = (np.sqrt(5.0) - 1) / 2
        a, b = hi - gr * (hi - lo), lo + gr * (hi - lo)
        fa, fb = nll(np.exp(a)), nll(np.exp(b))
        for _ in range(60):
            if fa < fb:
                hi, b, fb = b, a, fa
                a = hi - gr * (hi - lo)
                fa = nll(np.exp(a))
            else:
                lo, a, fa = a, b, fb
                b = lo + gr * (hi - lo)
                fb = nll(np.exp(b))
        self.temperature = float(np.exp((lo + hi) / 2))
        return self.temperature

    # ---- ahead-of-time programs ---------------------------------------------
    def export_stablehlo(self, path: str, batch_sizes=(1,),
                         gating_value=_CFG) -> None:
        """Export one `torch.export` program per bucket the given sizes
        reach (`bucket_<b>.pt2`) and `manifest.json` (the JAX package's
        keys; `platform` is this predictor's device type). Each program
        holds the weights as its state and `gating_value` (default the
        config's) as a constant; the kernels appear in its graph as the
        `sie_tpu_torch::` ops. Serve with `CompiledPredictor`; export on
        the platform you serve on."""
        if gating_value is _CFG:
            gating_value = self.cfg.gating_value
        os.makedirs(path, exist_ok=True)
        buckets = sorted({self._bucket(b) for b in batch_sizes})
        served = _Served(self.model, gating_value)
        for bucket in buckets:
            x = torch.zeros((bucket, self.cfg.seq_len, self.cfg.enc_in),
                            device=self.device)
            mask = torch.ones((bucket, self.cfg.seq_len), device=self.device)
            with torch.no_grad():
                served(x, mask)   # fills the models' constant caches
                ep = torch.export.export(served, (x, mask))
            torch.export.save(ep, os.path.join(path, f"bucket_{bucket}.pt2"))
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump({"platform": self.device.type,
                       "buckets": buckets,
                       "seq_len": self.cfg.seq_len,
                       "enc_in": self.cfg.enc_in,
                       "num_class": self.cfg.num_class,
                       "gating_value": gating_value,
                       "temperature": self.temperature,
                       "model": self.cfg.model,
                       "dnn_type": self.cfg.dnn_type}, f, indent=1)

    # ---- inference ------------------------------------------------------
    def _bucket(self, b: int) -> int:
        n = self._dp
        while n < min(b, self.max_batch):
            n *= 2
        return min(n, self.max_batch)

    def warmup(self, batch_sizes=(1,)) -> None:
        """Run every bucket the given request sizes reach (plus the
        max_batch chunk when a size exceeds it): on the card that builds
        the kernels and initialises cuBLAS and cuDNN before traffic."""
        buckets = {self._bucket(b) for b in batch_sizes}
        buckets |= {self.max_batch} if any(
            b > self.max_batch for b in batch_sizes) else set()
        for bucket in sorted(buckets):
            self.predict(np.zeros((bucket, self.cfg.seq_len,
                                   self.cfg.enc_in), np.float32))

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
            return _empty(self.cfg.num_class)
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
        x, mask = _pad(x, mask, self._bucket(b))
        rows = x.shape[0] // len(self._replicas)
        # an int8 weight is dequantised once a forward, where it is read
        # first, and its f32 copy freed with the forward's outputs
        with torch.inference_mode(), parametrize.cached():
            launched = []
            for i, (dev, model, stream) in enumerate(self._replicas):
                lo = i * rows
                with _on(stream):
                    xd = torch.from_numpy(x[lo:lo + rows]).to(dev)
                    md = torch.from_numpy(mask[lo:lo + rows]).to(dev)
                    launched.append(model(xd, md, gating_value=gating_value))
            parts = []
            for (_dev, _model, stream), (logits, info) in zip(self._replicas,
                                                              launched):
                with _on(stream):
                    part = {"logits": logits.float().cpu().numpy()}
                    for k in _INFO_FIELDS:
                        a = getattr(info, k)
                        keep = a is not None and (fields is None or k in fields)
                        part[k] = a.float().cpu().numpy() if keep else None
                parts.append(part)
        out = {k: (None if parts[0][k] is None else
                   np.concatenate([p[k] for p in parts])[:b])
               for k in parts[0]}
        out["probs"] = _softmax_probs(out["logits"], self.temperature)
        out["classes"] = np.argmax(out["logits"], -1)
        return out
