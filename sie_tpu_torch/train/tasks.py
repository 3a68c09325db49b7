"""Forecast, imputation and anomaly-detection experiments (counterpart of
sie_tpu/train/tasks.py).

The loop is the JAX package's: each split is held on the device once and
a batch is gathered there by index; an epoch's order is
`np.random.default_rng(seed).permutation(n)`, drawn epoch after epoch
from one generator as there, so both packages feed the same rows in the
same order; a step is loss, backward and the port's `make_optimizer`
(optax's clip, Adam and schedule); early stopping watches the validation
loss and `train()` returns the best weights (a state dict, also loaded
into the model). Steps are eager: each JAX step is one jitted program,
and capturing these as CUDA graphs is left to a later change.

- `ForecastExperiment`: MSE on the horizon (features 'MS': the target
  column only); the Transformer's decoder reads the label_len context
  plus a zero horizon; `test` reports MSE, MAE, RMSE, MAPE and MSPE,
  in the data's units under `inverse`.
- `ShortTermForecastExperiment` (M4): the sMAPE objective, sMAPE in
  `test`, and `write_forecast_csv` for `utils.m4_summary.M4Summary`.
- `ImputationExperiment`: a Bernoulli(mask_rate) mask hides points and
  the objective is the MSE over the hidden ones. The masks come from
  torch generators seeded from the seed (training), 0 (each validation
  batch) and the test seed; the JAX package draws them with jax.random,
  which torch cannot reproduce, so `_loss` and `test` also take the keep
  masks as arguments. The Transformer branch ignores the mask, as the
  reference's does.
- `AnomalyExperiment`: reconstruction MSE, validated on train (the
  segment loaders have no val split); `test` thresholds the pooled
  train + test per-step energies at the (100 - anomaly_ratio)
  percentile and reports precision, recall and F1 after the segment
  adjustment (`adjust_predictions`).

The model's weights come from a torch.Generator seeded from the config's
seed when the experiment is built; `train()` starts from them, so a
caller can load other initial weights first (`load_jax_params`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sie_tpu_torch.config import Config
from sie_tpu_torch.data.provider import data_provider
from sie_tpu_torch.device import DeviceLike, resolve_device
from sie_tpu_torch.models.layers import mark_width
from sie_tpu_torch.train.trainer import make_optimizer
from sie_tpu_torch.utils.metrics import MAE, MAPE, MSE, MSPE, RMSE
from sie_tpu_torch.utils.tools import EarlyStopping

def build_task_model(cfg: Config, task: str,
                     g: Optional[torch.Generator] = None,
                     marks: int = 0) -> nn.Module:
    """The `task` ('forecast', 'imputation' or 'anomaly') branch of backbone
    `cfg.dnn_type`, its weights from `g` (default seed 0) and its temporal
    embedding reading `marks` columns of time marks (0: none; the anomaly
    heads read none). The extra families (Autoformer, FEDformer,
    ETSformer, Pyraformer, Crossformer) forecast with models/extra/
    forecasters.py and impute and detect anomalies with
    `make_dense_task`, as in the JAX package."""
    from sie_tpu_torch.models.extra import forecasters as fc
    from sie_tpu_torch.models.extra.backbones import make_dense_task
    from sie_tpu_torch.models.patchtst import (PatchTSTAnomalyDetector,
                                               PatchTSTForecaster,
                                               PatchTSTImputer)
    from sie_tpu_torch.models.registry import EXTRA_DNNS
    from sie_tpu_torch.models.timesnet import (TimesNetAnomalyDetector,
                                               TimesNetForecaster,
                                               TimesNetImputer)
    from sie_tpu_torch.models.transformer import (TransformerAnomalyDetector,
                                                  TransformerForecaster,
                                                  TransformerImputer)
    table = {
        "forecast": {"Transformer": TransformerForecaster,
                     "TimesNet": TimesNetForecaster,
                     "PatchTST": PatchTSTForecaster,
                     "Autoformer": fc.AutoformerForecaster,
                     "FEDformer": fc.FEDformerForecaster,
                     "ETSformer": fc.ETSformerForecaster,
                     "Pyraformer": fc.PyraformerForecaster,
                     "Crossformer": fc.CrossformerForecaster},
        "imputation": {"Transformer": TransformerImputer,
                       "TimesNet": TimesNetImputer,
                       "PatchTST": PatchTSTImputer},
        "anomaly": {"Transformer": TransformerAnomalyDetector,
                    "TimesNet": TimesNetAnomalyDetector,
                    "PatchTST": PatchTSTAnomalyDetector},
    }
    for fam in EXTRA_DNNS:
        table["imputation"][fam] = table["anomaly"][fam] = \
            make_dense_task(fam)
    if cfg.dnn_type not in table[task]:
        raise ValueError(
            f"dnn_type {cfg.dnn_type!r} has no {task} branch "
            f"(available: {sorted(table[task])})")
    g = torch.Generator().manual_seed(0) if g is None else g
    # the anomaly heads are called without marks, so flax builds no
    # temporal embedding there
    width = mark_width(cfg.freq, marks) if marks and task != "anomaly" else 0
    return table[task][cfg.dnn_type](cfg, g, width)


def stack_windows(ds) -> Tuple[np.ndarray, ...]:
    """A window dataset as dense float32 arrays, one per field; 1-D fields
    (M4 series) gain a trailing channel axis, so each is (N, T, C)."""
    items = [ds[i] for i in range(len(ds))]
    cols = tuple(np.stack(p).astype(np.float32) for p in zip(*items))
    return tuple(c[..., None] if c.ndim == 2 else c for c in cols)


def adjust_predictions(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """The standard segment adjustment: a true anomaly segment with any
    point detected counts as detected whole."""
    gt = np.asarray(gt).astype(bool)
    pred = np.asarray(pred).astype(bool).copy()
    n = len(gt)
    i = 0
    while i < n:
        if gt[i]:
            j = i
            while j < n and gt[j]:
                j += 1
            if pred[i:j].any():
                pred[i:j] = True
            i = j
        else:
            i += 1
    return pred.astype(np.int32)


def _forecast_metrics(pred: np.ndarray, true: np.ndarray) -> Dict[str, float]:
    return {"mse": float(MSE(pred, true)), "mae": float(MAE(pred, true)),
            "rmse": float(RMSE(pred, true)), "mape": float(MAPE(pred, true)),
            "mspe": float(MSPE(pred, true))}


class _TaskExperiment:
    """The loop the task experiments share (module docstring)."""

    task: str = ""

    def __init__(self, cfg: Config, device: DeviceLike = None):
        self.device = resolve_device(device)   # without a card, before data
        self._datasets: Dict[str, object] = {}
        self.cfg = self._derive_cfg(cfg)
        self.train_data = self._stage("train")
        self.val_data = self._validation_data()
        seed = max(self.cfg.seed, 0)
        self.model = build_task_model(
            self.cfg, self.task, torch.Generator().manual_seed(seed),
            self._marks()).to(self.device)
        n = len(self.train_data[0])
        self.steps_per_epoch = max(n // self.cfg.batch_size, 1)
        self.optimizer = make_optimizer(self.cfg, self.steps_per_epoch,
                                        self.model.parameters())
        # dropout's stream (the JAX loop keys its step rng on seed + 23)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 23)
        self.history = []   # {epoch, train_loss, val_loss} per epoch

    # -- subclass hooks ----------------------------------------------------
    def _derive_cfg(self, cfg: Config) -> Config:
        return cfg

    def _arrays(self, flag: str) -> Tuple[np.ndarray, ...]:
        raise NotImplementedError

    def _validation_data(self):
        return self._stage("val")

    def _marks(self) -> int:
        """Columns of time marks the model reads (0: none)."""
        return 0

    def _loss(self, batch, train: bool) -> torch.Tensor:
        raise NotImplementedError

    # -- engine ------------------------------------------------------------
    def _dataset(self, flag: str):
        if flag not in self._datasets:
            self._datasets[flag] = data_provider(self.cfg, flag)[0]
        return self._datasets[flag]

    def _stage(self, flag: str) -> Tuple[torch.Tensor, ...]:
        """Split `flag`'s arrays on the device (staged once)."""
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in self._arrays(flag))

    def _batches(self, data):
        """The split's batches in order, the last one partial."""
        b = self.cfg.batch_size
        for k in range(-(-len(data[0]) // b)):
            yield tuple(a[k * b:(k + 1) * b] for a in data)

    def _weights(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    def _step(self, batch) -> torch.Tensor:
        self.model.train()
        for p in self.model.parameters():
            p.grad = None
        loss = self._loss(batch, True)
        loss.backward()
        self.optimizer.device_step(self.optimizer.mini_step)
        self.optimizer.advance()
        return loss.detach()

    def train(self, seed: Optional[int] = None, verbose: bool = False):
        """Trains from the model's current weights; `seed` (default the
        config's) seeds the epochs' order. -> the best weights, which the
        model then holds."""
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        stopper = EarlyStopping(patience=cfg.patience)
        best = self._weights()
        n = len(self.train_data[0])
        rng = np.random.default_rng(max(seed, 0))
        for epoch in range(cfg.train_epochs):
            order = torch.from_numpy(rng.permutation(n)).to(self.device)
            losses = []
            for k in range(self.steps_per_epoch):
                idx = order[k * cfg.batch_size:(k + 1) * cfg.batch_size]
                losses.append(self._step(tuple(a[idx]
                                               for a in self.train_data)))
            val = self.evaluate(self.val_data)
            train_loss = float(np.mean(torch.stack(losses).tolist()))
            self.history.append({"epoch": epoch, "train_loss": train_loss,
                                 "val_loss": val})
            if verbose:
                print(f"[{self.task}] epoch {epoch}: train "
                      f"{train_loss:.5f} val {val:.5f}", flush=True)
            if stopper(val):
                best = self._weights()
            if stopper.early_stop and epoch + 1 >= cfg.min_epochs:
                break
        self.model.load_state_dict(best)
        return best

    def _use(self, params) -> None:
        if params is not None:
            self.model.load_state_dict(params)
        self.model.eval()

    def evaluate(self, data, params=None) -> float:
        """The loss over `data` (eval mode), weighted by batch size."""
        self._use(params)
        tot, cnt = 0.0, 0
        with torch.no_grad():
            for batch in self._batches(data):
                b = len(batch[0])
                tot += float(self._loss(batch, False)) * b
                cnt += b
        return tot / max(cnt, 1)


class ForecastExperiment(_TaskExperiment):
    """Long-term (ETT, custom) and short-term (M4) forecasting."""

    task = "forecast"
    test_data = None   # staged at the first test
    # backbones that take TSlib's encoder-decoder protocol (the extra
    # families read the decoder's marks; the Autoformer family builds its
    # own decoder input from the look-back)
    _ENC_DEC = frozenset({"Transformer", "Autoformer", "FEDformer",
                          "ETSformer", "Pyraformer", "Crossformer"})

    def _derive_cfg(self, cfg: Config) -> Config:
        ds = data_provider(cfg, "train")[0]
        x = ds[0][0]
        c = 1 if x.ndim == 1 else x.shape[-1]
        kw = dict(enc_in=c, dec_in=c, c_out=c)
        if cfg.data == "m4":
            from sie_tpu_torch.data.m4 import M4Meta
            kw.update(pred_len=M4Meta.horizons_map.get(
                cfg.seasonal_patterns, cfg.pred_len), label_len=0)
        self._datasets["train"] = ds
        return cfg.replace(**kw)

    def _arrays(self, flag: str):
        cols = stack_windows(self._dataset(flag))
        if self.cfg.data == "m4":            # (ins, outs) -> x, y, zero marks
            x, y = cols
            zm = np.zeros((len(x), x.shape[1], 1), np.float32)
            zym = np.zeros((len(y), y.shape[1], 1), np.float32)
            return x, y, zm, zym
        return cols

    def _marks(self) -> int:
        return self.train_data[2].shape[-1]

    def _apply(self, batch, train: bool) -> torch.Tensor:
        cfg = self.cfg
        x, y, xm, ym = batch
        g = self.generator if train else None
        if cfg.dnn_type in self._ENC_DEC:
            # TSlib's decoder input: label_len context + a zero horizon
            dec = torch.cat([y[:, : cfg.label_len, :],
                             y.new_zeros(y.shape[0], cfg.pred_len,
                                         y.shape[2])], dim=1)
            return self.model(x, xm, dec, ym, generator=g)
        return self.model(x, xm, generator=g)

    def _target(self, y):
        # features 'MS': the target (last) column only
        f_dim = -1 if self.cfg.features == "MS" else 0
        return y[:, -self.cfg.pred_len:, f_dim:], f_dim

    def _loss(self, batch, train: bool) -> torch.Tensor:
        out = self._apply(batch, train)
        tgt, f_dim = self._target(batch[1])
        return torch.mean((out[:, :, f_dim:] - tgt) ** 2)

    def _collect(self, params=None) -> Tuple[np.ndarray, np.ndarray]:
        """Horizon predictions and targets over the test split, in dataset
        order, de-standardised under --inverse."""
        self._use(params)
        cfg = self.cfg
        if self.test_data is None:
            self.test_data = self._stage("test")
        preds, trues = [], []
        with torch.no_grad():
            for batch in self._batches(self.test_data):
                out = self._apply(batch, False)
                tgt, f_dim = self._target(batch[1])
                preds.append(out[:, :, f_dim:].cpu().numpy())
                trues.append(tgt.cpu().numpy())
        pred = np.concatenate(preds)
        true = np.concatenate(trues)
        ds = self._dataset("test")
        if cfg.inverse and getattr(ds, "mean", None) is not None:
            f_dim = -1 if cfg.features == "MS" else 0
            mean, std = ds.mean[f_dim:], ds.std[f_dim:]
            pred = pred * std + mean
            true = true * std + mean
        return pred, true

    def test(self, params=None) -> Dict[str, float]:
        return _forecast_metrics(*self._collect(params))


class ShortTermForecastExperiment(ForecastExperiment):
    """The M4 protocol: sMAPE objective (utils/losses.smape_loss), sMAPE
    beside the MSE family in `test`, and the `{group}_forecast.csv` that
    `utils.m4_summary.M4Summary` scores against Naive2."""

    def _loss(self, batch, train: bool) -> torch.Tensor:
        from sie_tpu_torch.utils.losses import smape_loss
        out = self._apply(batch, train)
        tgt, f_dim = self._target(batch[1])
        return smape_loss(out[:, :, f_dim:], tgt)

    def test(self, params=None) -> Dict[str, float]:
        from sie_tpu_torch.utils.m4_summary import smape_2
        pred, true = self._collect(params)
        return {"smape": float(np.mean(smape_2(pred, true))),
                **_forecast_metrics(pred, true)}

    def write_forecast_csv(self, params, out_dir: str) -> str:
        """One row per test series (in the M4 cache's order), columns
        V1..V{pred_len}."""
        from sie_tpu_torch.data.table import write_table
        pred, _ = self._collect(params)
        flat = pred.reshape(len(pred), -1)   # M4 series have one channel
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            f"{self.cfg.seasonal_patterns}_forecast.csv")
        write_table(path, [f"V{j + 1}" for j in range(flat.shape[1])],
                    flat.tolist())
        return path


class ImputationExperiment(_TaskExperiment):
    """Random-mask imputation on the forecast windows (module docstring)."""

    task = "imputation"

    def __init__(self, cfg: Config, device: DeviceLike = None):
        super().__init__(cfg, device)
        self.mask_generator = torch.Generator(
            device=self.device).manual_seed(max(self.cfg.seed, 0))

    def _derive_cfg(self, cfg: Config) -> Config:
        # pred_len 0 before loading: every split windows the input alone
        cfg = cfg.replace(pred_len=0, label_len=0)
        ds = data_provider(cfg, "train")[0]
        c = ds[0][0].shape[-1]
        self._datasets["train"] = ds
        return cfg.replace(enc_in=c, dec_in=c, c_out=c)

    def _arrays(self, flag: str):
        x, _y, xm, _ym = stack_windows(self._dataset(flag))
        return x, xm

    def _marks(self) -> int:
        return self.train_data[1].shape[-1]

    def draw_keep(self, shape, generator: torch.Generator) -> torch.Tensor:
        """1 where a point is observed, with probability 1 - mask_rate."""
        u = torch.rand(shape, generator=generator, device=self.device)
        return (u >= self.cfg.mask_rate).float()

    def _reconstruct(self, x_in, xm, keep, train: bool) -> torch.Tensor:
        g = self.generator if train else None
        if self.cfg.dnn_type == "Transformer":
            # the reference's Transformer branch ignores the mask
            return self.model(x_in, xm, generator=g)
        return self.model(x_in, xm, keep, generator=g)

    def _loss(self, batch, train: bool, keep=None) -> torch.Tensor:
        """MSE over the hidden points; `keep` (1 = observed) defaults to a
        draw from the mask generator (training) or from a generator
        seeded 0 (each evaluation batch, as the JAX package keys every
        one on key 0)."""
        x, xm = batch
        if keep is None:
            keep = self.draw_keep(x.shape, self.mask_generator if train else
                                  torch.Generator(device=self.device
                                                  ).manual_seed(0))
        out = self._reconstruct(x * keep, xm, keep, train)
        hidden = 1.0 - keep
        return (torch.sum(((out - x) * hidden) ** 2)
                / torch.clamp(torch.sum(hidden), min=1.0))

    def test(self, params=None, seed: int = 0,
             keeps=None) -> Dict[str, float]:
        """MSE and MAE over the hidden points of the test split; `keeps`,
        one keep mask a batch, defaults to draws from a generator seeded
        `seed`."""
        self._use(params)
        data = self._stage("test")
        g = torch.Generator(device=self.device).manual_seed(seed)
        preds, trues, masks = [], [], []
        with torch.no_grad():
            for k, (x, xm) in enumerate(self._batches(data)):
                keep = (self.draw_keep(x.shape, g) if keeps is None
                        else torch.as_tensor(keeps[k], device=self.device))
                out = self._reconstruct(x * keep, xm, keep, False)
                preds.append(out.cpu().numpy())
                trues.append(x.cpu().numpy())
                masks.append(keep.cpu().numpy())
        pred = np.concatenate(preds)
        true = np.concatenate(trues)
        hidden = 1.0 - np.concatenate(masks)
        err = (pred - true) * hidden
        denom = max(hidden.sum(), 1.0)
        return {"mse": float((err ** 2).sum() / denom),
                "mae": float(np.abs(err).sum() / denom)}


class AnomalyExperiment(_TaskExperiment):
    """Reconstruction-based anomaly detection on the segment loaders
    (PSM, MSL, SMAP, SMD, SWaT)."""

    task = "anomaly"

    def _derive_cfg(self, cfg: Config) -> Config:
        ds = data_provider(cfg, "train")[0]
        c = ds[0][0].shape[-1]
        self._datasets["train"] = ds
        return cfg.replace(enc_in=c, dec_in=c, c_out=c, pred_len=0)

    def _arrays(self, flag: str):
        return stack_windows(self._dataset(flag))     # windows, labels

    def _validation_data(self):
        return self.train_data

    def _recon(self, x, train: bool) -> torch.Tensor:
        return self.model(x, generator=self.generator if train else None)

    def _loss(self, batch, train: bool) -> torch.Tensor:
        x = batch[0]
        return torch.mean((self._recon(x, train) - x) ** 2)

    def _energies(self, data) -> np.ndarray:
        """Per-step reconstruction energy, flattened over windows."""
        out = []
        with torch.no_grad():
            for x, _lab in self._batches(data):
                rec = self._recon(x, False)
                out.append(torch.mean((rec - x) ** 2, dim=-1).cpu().numpy())
        return np.concatenate(out).reshape(-1)

    def test(self, params=None) -> Dict[str, float]:
        self._use(params)
        test_data = self._stage("test")
        train_energy = self._energies(self.train_data)
        test_energy = self._energies(test_data)
        combined = np.concatenate([train_energy, test_energy])
        thresh = np.percentile(combined, 100.0 - self.cfg.anomaly_ratio)
        pred = (test_energy > thresh).astype(np.int32)
        gt = test_data[1].cpu().numpy().reshape(-1).astype(np.int32)
        pred = adjust_predictions(gt, pred)
        tp = int(((pred == 1) & (gt == 1)).sum())
        fp = int(((pred == 1) & (gt == 0)).sum())
        fn = int(((pred == 0) & (gt == 1)).sum())
        precision = tp / max(tp + fp, 1)
        recall = tp / max(tp + fn, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-12)
        return {"threshold": float(thresh),
                "accuracy": float((pred == gt).mean()),
                "precision": float(precision), "recall": float(recall),
                "f1": float(f1)}


TASK_EXPERIMENTS = {
    "long_term_forecast": ForecastExperiment,
    "short_term_forecast": ShortTermForecastExperiment,
    "imputation": ImputationExperiment,
    "anomaly_detection": AnomalyExperiment,
}
