"""Metrics: a copy of sie_tpu/utils/metrics.py (numpy): classification
accuracy and class counts, and the reference's forecast metric set
(RSE, CORR, MAE, MSE, RMSE, MAPE, MSPE)."""

from __future__ import annotations

import numpy as np


def accuracy(preds: np.ndarray, trues: np.ndarray) -> float:
    return float((preds == trues).mean()) if len(trues) else 0.0


def class_distribution(labels: np.ndarray, num_class: int):
    counts = np.bincount(labels.astype(int), minlength=num_class)
    total = max(len(labels), 1)
    return {int(i): {"count": int(c), "percentage": 100.0 * c / total}
            for i, c in enumerate(counts)}


def RSE(pred, true):
    return (np.sqrt(np.sum((true - pred) ** 2))
            / np.sqrt(np.sum((true - true.mean()) ** 2)))


def CORR(pred, true):
    # TSlib's formula, kept for comparability with its published numbers:
    # the denominator is sqrt(sum(t_c^2 * p_c^2)), not the product of the
    # norms, so this is not Pearson's correlation and can exceed 1
    u = ((true - true.mean(0)) * (pred - pred.mean(0))).sum(0)
    d = np.sqrt(((true - true.mean(0)) ** 2 * (pred - pred.mean(0)) ** 2).sum(0))
    return (u / d).mean(-1)


def MAE(pred, true):
    return np.mean(np.abs(pred - true))


def MSE(pred, true):
    return np.mean((pred - true) ** 2)


def RMSE(pred, true):
    return np.sqrt(MSE(pred, true))


def MAPE(pred, true):
    return np.mean(np.abs((pred - true) / true))


def MSPE(pred, true):
    return np.mean(np.square((pred - true) / true))
