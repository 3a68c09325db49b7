"""Regression experiment with a binned CRPS loss (counterpart of
sie_tpu/train/regression.py; reference exp/experiment_regression.py:59-353).

- data flags TRAIN/TEST with val == test (exp:86-88);
- bin_edges computed on TRAIN and shared (Monashloader);
- sequences longer than 1000 steps are stride-subsampled (exp:32-37), the
  padding mask with the same stride;
- CRPS: softmax -> CDF against the empirical step CDF at the bin edges,
  summed squared difference, weighted batch mean (exp:59-75);
- early stopping on the validation loss, the best (params, batch_stats)
  checkpointed in the background as `checkpoint.msgpack`; `test()` returns
  the interpretability dict and writes the one-row CSV.

It trains through `Trainer.train_step` batch by batch, as the JAX
experiment does, on the card unless the caller asks for the CPU.

Float targets are kept, as in the JAX package: the reference casts them
with `label.long()` (exp:157), truncating them before the CRPS;
`truncate_targets=True` does the same for parity with the reference.
"""

from __future__ import annotations

import csv
import math
import os
import time
from datetime import datetime
from typing import Dict, Optional

import numpy as np
import torch

from sie_tpu_torch.compat.from_jax import (load_jax_variables, to_jax_params,
                                           to_jax_variables)
from sie_tpu_torch.config import Config
from sie_tpu_torch.data.provider import data_provider
from sie_tpu_torch.device import DeviceLike, resolve_device
from sie_tpu_torch.train import checkpoint as ckpt
from sie_tpu_torch.train.trainer import Trainer, compute_beta
from sie_tpu_torch.utils.shapelet_util import extract_shapelets
from sie_tpu_torch.utils.tools import EarlyStopping, gini_coefficient


def subsample_factor(seq_len: int, max_length: int = 1000) -> int:
    return math.ceil(seq_len / max_length) if seq_len >= max_length else 1


def subsample_batch(x: np.ndarray, max_length: int = 1000) -> np.ndarray:
    """(reference exp/experiment_regression.py:32-37)"""
    factor = subsample_factor(x.shape[1], max_length)
    return x[:, ::factor, :] if factor > 1 else x


def make_crps_head(bin_edges: np.ndarray, truncate_targets: bool = False):
    """crps(logits (B, nbins), targets (B,), weights (B,)) -> the weighted
    mean over the batch of sum_k (CDF_pred(k) - [edge_k >= target])^2, in
    f32; the edges go to each device once."""
    edges = torch.as_tensor(np.asarray(bin_edges, np.float32))
    on: Dict[torch.device, torch.Tensor] = {}

    def crps(logits, targets, weights):
        if logits.device not in on:
            on[logits.device] = edges.to(logits.device)
        e = on[logits.device]
        cdf_pred = torch.cumsum(torch.softmax(logits.float(), dim=1), dim=1)
        t = targets.float()
        if truncate_targets:
            t = torch.trunc(t)
        cdf_true = (e[None, :] >= t[:, None]).float()
        per_sample = (cdf_pred - cdf_true).square().sum(dim=1)
        return (per_sample * weights).sum() / torch.clamp(weights.sum(),
                                                          min=1.0)

    return crps


class RegressionExperiment:
    def __init__(self, cfg: Config, verbose: bool = True,
                 truncate_targets: bool = False, metrics_hook=None,
                 device: DeviceLike = None):
        device = resolve_device(device)   # without a card, before any data
        self.verbose = verbose
        # metrics_hook(dict) fires once per epoch with {epoch, train_loss,
        # val_loss, beta, seconds}
        self.metrics_hook = metrics_hook
        self.train_data, self.train_loader = data_provider(cfg, "TRAIN")
        self.test_data, self.test_loader = data_provider(
            cfg, "TEST", bin_edges=self.train_data.bin_edges)
        self.val_data, self.val_loader = self.test_data, self.test_loader

        seq_len = subsample_batch(self.train_data.x[:1]).shape[1]
        cfg = cfg.replace(seq_len=seq_len, enc_in=self.train_data.enc_in,
                          num_class=self.train_data.num_class,
                          pred_len=0, label_len=0)
        self.cfg = cfg
        self.loss_head = make_crps_head(self.train_data.bin_edges,
                                        truncate_targets)
        self.trainer = Trainer(
            cfg, steps_per_epoch=max(len(self.train_loader), 1),
            device=device, loss_head=self.loss_head,
            generator=torch.Generator().manual_seed(max(cfg.seed, 0)))
        self.checkpoint_dir = os.path.join(cfg.checkpoint_dir,
                                           cfg.checkpoint_key())
        self.epoch_stop = 0

    def _log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)

    def _batch(self, batch):
        x, y, mask, w = batch
        factor = subsample_factor(x.shape[1])
        if factor > 1:
            # stride the mask with the same factor: truncating it would mark
            # tail padding of shorter-than-max samples as real steps
            x, mask = x[:, ::factor, :], mask[:, ::factor]
        return x, y, mask, w

    def train(self):
        """The epoch loop; returns the model, holding the best parameters
        and BatchNorm statistics."""
        cfg, tr = self.cfg, self.trainer
        early = EarlyStopping(patience=cfg.patience)
        best = to_jax_variables(tr.model)
        t0 = time.time()
        for epoch in range(cfg.train_epochs):
            beta = compute_beta(epoch, cfg.train_epochs, cfg.beta_schedule)
            losses = []
            for batch in self.train_loader.epoch(epoch):
                loss, _logits = tr.train_step(self._batch(batch), beta)
                losses.append(loss)
            train_loss = float(torch.stack(losses).float().mean().cpu())
            val_loss = self.validation()
            if self.metrics_hook is not None:
                self.metrics_hook({"epoch": epoch, "train_loss": train_loss,
                                   "val_loss": float(val_loss),
                                   "beta": float(beta),
                                   "seconds": time.time() - t0})
            if (epoch + 1) % cfg.log_interval == 0:
                self._log(f"Epoch {epoch}/{cfg.train_epochs} | "
                          f"Train {train_loss:.4f} | Val {val_loss:.4f}")
            if epoch >= cfg.min_epochs:
                if early(val_loss):
                    best = to_jax_variables(tr.model)
                    ckpt.save_checkpoint(self.checkpoint_dir, best["params"],
                                         best["batch_stats"],
                                         meta={"epoch_stop": epoch,
                                               "val_loss": float(val_loss)},
                                         background=True)
            if early.early_stop:
                self._log("Early stopping")
                self.epoch_stop = epoch
                break
            self.epoch_stop = epoch
        ckpt.wait_pending(self.checkpoint_dir)
        load_jax_variables(tr.model, best)
        return tr.model

    def load_checkpoint(self) -> bool:
        restored = ckpt.load_checkpoint(self.checkpoint_dir)
        if restored is None:
            return False
        load_jax_variables(self.trainer.model, restored)
        # restored runs report the true stop epoch in the CSV
        self.epoch_stop = ckpt.load_meta(self.checkpoint_dir).get(
            "epoch_stop", self.epoch_stop)
        return True

    def has_checkpoint(self) -> bool:
        return ckpt.has_checkpoint(self.checkpoint_dir)

    def load_torch_checkpoint(self, path: str):
        """Loads a reference-trained regression `checkpoint.pth` (the same
        SBM layout with num_class = nbins, reference
        exp_regression.py:95-102) -> the source keys without a
        counterpart."""
        from sie_tpu_torch.compat.torch_import import load_into_model
        return load_into_model(self.trainer.model, self.cfg, path)

    def _loader_loss(self, loader, gating_value=None, collect=False):
        tr = self.trainer
        losses, buf = [], {"x": [], "pred": [], "target": [], "p": [],
                           "d": [], "eta": [], "sp": []}
        for batch in loader.epoch(0):
            b = self._batch(batch)
            x, y, _mask, w = b
            logits, info = tr.eval_step(b, gating_value=gating_value)
            loss = float(self.loss_head(
                logits, torch.as_tensor(y, device=logits.device),
                torch.as_tensor(w, device=logits.device)))
            if info.loss is not None:
                loss += float(info.loss.float().mean())
            losses.append(loss)
            if collect:
                keep = w > 0
                host = lambda t: t.float().cpu().numpy()[keep]
                buf["x"].append(x[keep])
                buf["pred"].append(host(logits))
                buf["target"].append(y[keep])
                if info.p is not None:
                    buf["p"].append(host(info.p))
                    buf["d"].append(host(info.d))
                    buf["sp"].append(host(info.shapelet_preds))
                if info.eta is not None:
                    buf["eta"].append(host(info.eta))
        return (float(np.mean(losses)) if losses else float("inf")), buf

    def validation(self) -> float:
        loss, _ = self._loader_loss(self.val_loader)
        return loss

    def test(self, save_csv: bool = True, result_dir: Optional[str] = None):
        """-> (test loss, None, the interpretability dict)."""
        cfg = self.cfg
        total_loss, buf = self._loader_loss(
            self.test_loader, gating_value=cfg.gating_value, collect=True)

        cat = lambda k: np.concatenate(buf[k]) if buf[k] else None
        df = {"x": cat("x"), "pred": cat("pred"), "target": cat("target")}
        if cfg.model != "DNN":
            params = to_jax_params(self.trainer.model)
            sbm_params = params.get("sbm", params)
            w = np.asarray(sbm_params["output_layer"]["kernel"]).T
            df.update(predicate=cat("p"), w=w,
                      shapelets=extract_shapelets(params),
                      eta=cat("eta"), sbm_pred=cat("sp"))
        self._log(f"Test loss {total_loss:.6f}")
        if save_csv:
            row = {k: getattr(cfg, k) for k in (
                "model", "dataset", "dnn_type", "train_epochs", "num_shapelet",
                "lambda_reg", "lambda_div", "epsilon", "lr", "seed",
                "pos_weight", "beta_schedule", "gating_value", "distance_func",
                "sbm_cls")}
            row.update(test_loss=total_loss, epoch_stop=self.epoch_stop)
            if cfg.model != "DNN":
                eta = df.get("eta")
                if eta is not None:
                    row["eta_mean"] = float(eta.mean())
                    row["eta_std"] = float(eta.std())
                aw = np.abs(df["w"])
                for thr, tag in ((1.0, "10"), (0.5, "5"), (0.1, "1")):
                    row[f"w_sum_{tag}"] = float((aw > thr).sum())
                    row[f"w_mean_{tag}"] = float((aw > thr).mean())
                row["w_max"] = float(aw.max())
                row["w_gini_clip"] = gini_coefficient(np.clip(df["w"], 0, None))
                row["w_gini_abs"] = gini_coefficient(aw)
            out_dir = result_dir or os.path.join(cfg.result_dir, cfg.model)
            os.makedirs(out_dir, exist_ok=True)
            ts = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
            path = os.path.join(
                out_dir, f"{cfg.dataset}-{cfg.seed}-{cfg.model}-"
                         f"{cfg.num_shapelet}-{cfg.lambda_div}-{cfg.lambda_reg}-{ts}.csv")
            with open(path, "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(list(row))
                writer.writerow(["" if v is None else v for v in row.values()])
            self._log(f"Test summary saved at: {path}")
        return total_loss, None, df
