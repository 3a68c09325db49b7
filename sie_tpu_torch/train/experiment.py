"""Classification experiment (counterpart of sie_tpu/train/experiment.py).

Lifecycle: load the splits -> derive the model's shape from the data ->
build the trainer on the device (the card unless the caller asks for the
CPU) -> epoch loop with validation and early stopping on the validation
accuracy, the best variables (parameters and BatchNorm statistics)
checkpointed in the JAX package's format -> reload the best, in place -> test with hard gating, the interpretability outputs and
a one-row CSV summary.

While the three splits together stay below 4 GiB they are held on the
device once, and an epoch goes through `Trainer.stage_steps` and the
staged steps (`train_step_staged`, or `train_epoch_staged` under
`scan_epoch`), each a replayed CUDA graph on the card; validation runs as
one `eval_epoch_staged_scan` pass under `scan_eval`, the test pass under
`scan_epoch`, else batch by batch through `eval_step_staged`. Larger data,
and every split under `stream_from_disk` (memmaps, data/stream.py), is
fed from the host a batch a step: training through `prefetch_to_device`,
which gathers the next batch and copies it to the card (pinned memory, a
side stream) while the current step runs; the eval passes batch by
batch through `eval_step`.

The CSV holds the reference's full spec (test accuracy, epoch_stop, eta
mean/std, shapelet score, |w| sparsity at 1/0.5/0.1, w_max, w Gini),
written with the `csv` module.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from sie_tpu_torch.compat.from_jax import (load_jax_variables, to_jax_params,
                                           to_jax_variables)
from sie_tpu_torch.config import Config
from sie_tpu_torch.data.provider import data_provider
from sie_tpu_torch.data.stream import prefetch_to_device
from sie_tpu_torch.device import DeviceLike, resolve_device
from sie_tpu_torch.models.info import ModelInfo
from sie_tpu_torch.train import checkpoint as ckpt
from sie_tpu_torch.train.trainer import Trainer, compute_beta, per_sample_ce
from sie_tpu_torch.utils.metrics import accuracy, class_distribution
from sie_tpu_torch.utils.shapelet_util import (ClassificationResult,
                                               compute_shapelet_score,
                                               extract_shapelets)
from sie_tpu_torch.utils.tools import (EarlyStopping, convert_to_hms,
                                       gini_coefficient)

_HOST_LIMIT = 4 * 1024 ** 3   # splits held on the device below this size


def _map_info(info: Optional[ModelInfo], fn) -> Optional[ModelInfo]:
    """fn applied to every field of a ModelInfo that is not None."""
    if info is None:
        return None
    return ModelInfo(**{f.name: (None if getattr(info, f.name) is None else
                                 fn(getattr(info, f.name)))
                        for f in dataclasses.fields(ModelInfo)})


class Experiment:
    def __init__(self, cfg: Config, verbose: bool = True, metrics_hook=None,
                 device: DeviceLike = None,
                 loso_test_subject: Optional[int] = None):
        device = resolve_device(device)   # without a card, before any data
        self.verbose = verbose
        # metrics_hook(dict) fires once per epoch with {epoch, train_loss,
        # val_loss, val_accuracy, beta, seconds}
        self.metrics_hook = metrics_hook
        # loso_test_subject: that EEG subject is the test split
        split = lambda flag: data_provider(
            cfg, flag, loso_test_subject=loso_test_subject)
        self.train_data, self.train_loader = split("train")
        self.val_data, self.val_loader = split("val")
        self.test_data, self.test_loader = split("test")

        # the model's shape comes from the data
        cfg = cfg.replace(
            seq_len=self.train_data.seq_len,
            enc_in=self.train_data.enc_in,
            num_class=self.train_data.num_class,
            pred_len=0, label_len=0,
            original_fs=self.train_data.original_fs,
            target_fs=self.train_data.target_fs,
        )
        self.cfg = cfg
        self.trainer = Trainer(
            cfg, steps_per_epoch=max(len(self.train_loader), 1),
            device=device,
            generator=torch.Generator().manual_seed(max(cfg.seed, 0)))
        self.checkpoint_dir = os.path.join(cfg.checkpoint_dir,
                                           cfg.checkpoint_key())
        self.epoch_stop = 0
        total_bytes = sum(d.x.nbytes for d in
                          (self.train_data, self.val_data, self.test_data))
        # stream_from_disk keeps the splits on disk (data/stream.py
        # memmaps): copying them whole to the device would defeat it
        self.device_resident = (not cfg.stream_from_disk
                                and total_bytes < _HOST_LIMIT)
        # MoE capacity counts every step of a row, real or padded
        # (models/moe.py): warn once on ragged batches, as the JAX package
        if cfg.moe_experts > 0:
            pm = getattr(self.train_data, "padding_mask", None)
            if pm is not None and float(np.min(pm)) == 0.0:
                frac = 1.0 - float(np.mean(pm))
                self._log(
                    f"WARNING: --moe_experts with ragged batches — "
                    f"{100 * frac:.1f}% of timesteps are padding and are "
                    f"routed like real tokens, consuming expert capacity "
                    f"(models/moe.py). Real tokens may be dropped at the "
                    f"capacity margin; raise --moe_capacity_factor (e.g. by "
                    f"1/(1-{frac:.2f}) = {1.0 / max(1e-6, 1 - frac):.2f}x) "
                    f"to absorb the padded load.")

    def _log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)

    # ------------------------------------------------------------------
    def train(self, resume: bool = False, snapshot_every: int = 0):
        """resume=True continues an interrupted run from the full-state
        snapshot (optimizer, generator and loop position); snapshot_every=k
        writes that snapshot every k epochs (0 = off). Returns the model,
        holding the best parameters and BatchNorm statistics."""
        cfg, tr = self.cfg, self.trainer
        early = EarlyStopping(patience=cfg.patience)
        start_epoch = 0
        best = None
        if resume:
            restored = ckpt.load_train_state(self.checkpoint_dir, tr)
            if restored is not None:
                start_epoch, early_state = restored
                early.load_state_dict(early_state)
                self._log(f"resumed at epoch {start_epoch}")
                best = ckpt.load_checkpoint(self.checkpoint_dir)
        if best is None:
            best = to_jax_variables(tr.model)
        t0 = time.time()

        dev_train = (tr.device_data("train", self.train_data)
                     if self.device_resident else None)
        for epoch in range(start_epoch, cfg.train_epochs):
            beta = compute_beta(epoch, cfg.train_epochs, cfg.beta_schedule)
            losses = []
            if dev_train is not None:
                steps = list(self.train_loader.epoch_indices(epoch))
                staged = tr.stage_steps(steps, beta)
                if cfg.scan_epoch and staged is not None:
                    losses = [tr.train_epoch_staged(dev_train, staged)]
                else:
                    for k in range(len(steps)):
                        loss, _logits = tr.train_step_staged(dev_train,
                                                             staged, k)
                        losses.append(loss)
            else:
                # a background thread gathers batch k+1 (rows off disk
                # when streaming) and starts its copy to the device while
                # the device runs batch k
                put = None if tr.device.type == "cuda" else (lambda b: b)
                for batch in prefetch_to_device(
                        self.train_loader.epoch(epoch), device_put=put,
                        device=tr.device):
                    loss, _logits = tr.train_step(batch, beta)
                    losses.append(loss)
            if not losses:
                continue
            train_loss = float(np.mean(torch.cat(
                [l.reshape(-1) for l in losses]).cpu().numpy()))
            val_loss, val_acc = self.validation()
            if (epoch + 1) % cfg.log_interval == 0:
                remain = (time.time() - t0) * (cfg.train_epochs - epoch) / (epoch + 1)
                self._log(f"Epoch {epoch + 1}/{cfg.train_epochs} | "
                          f"Train Loss {train_loss:.4f} | Val Loss {val_loss:.4f} | "
                          f"Val Acc {val_acc:.4f} | Time Rem {convert_to_hms(remain)}")
            if self.metrics_hook is not None:
                self.metrics_hook({"epoch": epoch, "train_loss": train_loss,
                                   "val_loss": val_loss,
                                   "val_accuracy": val_acc,
                                   "beta": float(beta),
                                   "seconds": time.time() - t0})
            if epoch >= cfg.min_epochs:
                if early(-val_acc):
                    best = to_jax_variables(tr.model)
                    # the write overlaps the next epoch; loads wait for it
                    ckpt.save_checkpoint(self.checkpoint_dir, best["params"],
                                         best["batch_stats"],
                                         meta={"epoch_stop": epoch,
                                               "val_accuracy": float(val_acc)},
                                         background=True)
            if snapshot_every and (epoch + 1) % snapshot_every == 0:
                ckpt.save_train_state(self.checkpoint_dir, tr, epoch + 1,
                                      early.state_dict())
            if early.early_stop:
                self._log("Early stopping")
                self.epoch_stop = epoch
                break
            self.epoch_stop = epoch

        ckpt.wait_pending(self.checkpoint_dir)
        if tr.captures:
            self._log(f"CUDA graphs captured: {len(tr.captures)}")
        load_jax_variables(tr.model, best)   # in place: graphs stay valid
        return tr.model

    def load_checkpoint(self) -> bool:
        restored = ckpt.load_checkpoint(self.checkpoint_dir)
        if restored is None:
            return False
        load_jax_variables(self.trainer.model, restored)
        self.epoch_stop = ckpt.load_meta(self.checkpoint_dir).get(
            "epoch_stop", self.epoch_stop)
        return True

    def has_checkpoint(self) -> bool:
        return ckpt.has_checkpoint(self.checkpoint_dir)

    def load_torch_checkpoint(self, path: str):
        """Loads a reference-trained `checkpoint.pth` into the model ->
        the source keys without a counterpart."""
        from sie_tpu_torch.compat.torch_import import load_into_model
        return load_into_model(self.trainer.model, self.cfg, path)

    # ------------------------------------------------------------------
    def _eval_loader(self, loader, gating_value=None, collect=False):
        tr = self.trainer
        losses, preds, trues = [], [], []
        buf = {"p": [], "d": [], "eta": [], "sp": [], "dp": [], "x": []}
        num_class = self.cfg.num_class
        dev = None
        if self.device_resident:
            # an unknown loader is fed from the host rather than aliasing
            # another split's device copy
            tags = {id(self.train_loader): "train", id(self.val_loader): "val",
                    id(self.test_loader): "test"}
            tag = tags.get(id(loader))
            if tag is not None:
                dev = tr.device_data(tag, loader.ds)
        steps = list(loader.epoch_indices(0))
        staged = tr.stage_steps(steps) if dev is not None else None
        scanned = None
        # the whole pass in one graph replay and one fetch; validation
        # (collect=False) under scan_eval, the test pass, which stacks the
        # full ModelInfo on the device, under scan_epoch only
        if staged is not None and (self.cfg.scan_epoch if collect
                                   else self.cfg.scan_eval):
            logits_a, ce_a, ml_a, info_a = tr.eval_epoch_staged_scan(
                dev, staged, gating_value=gating_value, collect=collect)
            scanned = (logits_a.float().cpu().numpy(), ce_a.cpu().numpy(),
                       ml_a.cpu().numpy(),
                       _map_info(info_a, lambda t: t.float().cpu().numpy()))
        for bi, (idx, w) in enumerate(steps):
            x = loader.ds.x[idx] if (collect or dev is None) else None
            y = loader.ds.y[idx]
            if scanned is not None:
                logits, ce = scanned[0][bi], scanned[1][bi]
                model_loss = float(scanned[2][bi])
                info = _map_info(scanned[3], lambda a: a[bi])
            else:
                if dev is not None:
                    logits_t, info_t = tr.eval_step_staged(
                        dev, staged, bi, gating_value=gating_value)
                else:
                    batch = (x, y, loader.ds.padding_mask[idx], w)
                    logits_t, info_t = tr.eval_step(batch,
                                                    gating_value=gating_value)
                ce = per_sample_ce(logits_t, torch.as_tensor(
                    y, device=logits_t.device)).cpu().numpy()
                logits = logits_t.float().cpu().numpy()
                model_loss = (float(info_t.loss.float().mean())
                              if info_t.loss is not None else 0.0)
                info = (_map_info(info_t, lambda t: t.float().cpu().numpy())
                        if collect else None)
            # defensive label filtering (reference exp:906-929)
            keep = (w > 0) & (y >= 0) & (y < num_class)
            losses.append(ce[keep] + model_loss)
            preds.append(logits[keep])
            trues.append(y[keep])
            if collect:
                buf["x"].append(x[keep])
                if info.p is not None:
                    buf["p"].append(info.p[keep])
                    buf["d"].append(info.d[keep])
                    buf["sp"].append(info.shapelet_preds[keep])
                if info.eta is not None:
                    buf["eta"].append(info.eta[keep])
                    buf["dp"].append(info.dnn_preds[keep])
        if not losses:
            return float("inf"), np.zeros((0, 1)), np.zeros((0,)), buf
        return (float(np.concatenate(losses).mean()),
                np.concatenate(preds), np.concatenate(trues), buf)

    def validation(self):
        """(reference exp:380-421)"""
        loss, preds, trues, _ = self._eval_loader(self.val_loader)
        if len(trues) == 0:
            return float("inf"), 0.0
        return loss, accuracy(np.argmax(preds, -1), trues)

    # ------------------------------------------------------------------
    def test(self, save_csv: bool = True, result_dir: Optional[str] = None):
        """(reference exp:828-1138 and the CSV spec of exp:500-532) ->
        (loss, metrics, ClassificationResult)."""
        cfg = self.cfg
        loss, preds, trues, buf = self._eval_loader(
            self.test_loader, gating_value=cfg.gating_value, collect=True)
        y_pred = np.argmax(preds, -1) if len(preds) else np.zeros((0,), int)
        acc = accuracy(y_pred, trues)

        cat = lambda k: np.concatenate(buf[k]) if buf[k] else None
        result = ClassificationResult(
            accuracy=acc, loss=loss, num_samples=len(trues), x=cat("x"),
            trues=trues, preds=preds, p=cat("p"), d=cat("d"), eta=cat("eta"),
            shapelet_preds=cat("sp"), dnn_preds=cat("dp"))

        if cfg.model in ("SBM", "LTS", "InterpGN"):
            params = to_jax_params(self.trainer.model)
            sbm_params = params.get("sbm", params)
            kernel = np.asarray(sbm_params["output_layer"]["kernel"])
            result.w = kernel.T                    # (num_class, F)
            result.shapelets = extract_shapelets(params)

        metrics = {
            "accuracy": acc * 100.0,
            "loss": loss,
            "num_samples": len(trues),
            "class_distribution": class_distribution(trues, cfg.num_class)
            if len(trues) else {},
            "random_baseline": 100.0 / cfg.num_class,
        }
        self._log(f"Test accuracy {metrics['accuracy']:.2f}% "
                  f"(random baseline {metrics['random_baseline']:.2f}%)")

        if save_csv:
            result.summary = self._summary_row(result)
            out_dir = result_dir or os.path.join(cfg.result_dir, cfg.model)
            os.makedirs(out_dir, exist_ok=True)
            ts = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
            path = os.path.join(
                out_dir, f"{cfg.dataset}-{cfg.seed}-{cfg.model}-"
                         f"{cfg.num_shapelet}-{cfg.lambda_div}-{cfg.lambda_reg}-{ts}.csv")
            with open(path, "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(list(result.summary))
                writer.writerow(["" if v is None else v
                                 for v in result.summary.values()])
            self._log(f"Test summary saved at: {path}")
        return loss, metrics, result

    def _summary_row(self, result: ClassificationResult) -> dict:
        cfg = self.cfg
        row = {k: getattr(cfg, k) for k in (
            "model", "dataset", "dnn_type", "train_epochs", "num_shapelet",
            "lambda_reg", "lambda_div", "epsilon", "lr", "seed", "pos_weight",
            "beta_schedule", "gating_value", "distance_func", "sbm_cls")}
        row["test_accuracy"] = result.accuracy
        row["test_loss"] = result.loss
        row["epoch_stop"] = self.epoch_stop
        if result.eta is not None:
            row["eta_mean"] = float(result.eta.mean())
            row["eta_std"] = float(result.eta.std())
        if result.w is not None:
            w = result.w
            if result.d is not None and len(result.trues):
                row["shapelet_score"] = compute_shapelet_score(
                    result.d, w, np.argmax(result.preds, -1), result.trues)
            aw = np.abs(w)
            for thr, tag in ((1.0, "10"), (0.5, "5"), (0.1, "1")):
                row[f"w_sum_{tag}"] = float((aw > thr).sum())
                row[f"w_mean_{tag}"] = float((aw > thr).mean())
            row["w_max"] = float(aw.max())
            row["w_gini_clip"] = gini_coefficient(np.clip(w, 0, None))
            row["w_gini_abs"] = gini_coefficient(aw)
        return row
