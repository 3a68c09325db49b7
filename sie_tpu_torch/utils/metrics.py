"""Classification metrics: a copy of the classification part of
sie_tpu/utils/metrics.py (the forecast metrics come with the forecast
tasks, ROADMAP.md)."""

from __future__ import annotations

import numpy as np


def accuracy(preds: np.ndarray, trues: np.ndarray) -> float:
    return float((preds == trues).mean()) if len(trues) else 0.0


def class_distribution(labels: np.ndarray, num_class: int):
    counts = np.bincount(labels.astype(int), minlength=num_class)
    total = max(len(labels), 1)
    return {int(i): {"count": int(c), "percentage": 100.0 * c / total}
            for i, c in enumerate(counts)}
