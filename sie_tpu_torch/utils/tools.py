"""Training utilities: a copy of sie_tpu/utils/tools.py (early stopping
with a state dict for resuming, time formatting, the Gini coefficient of
the SBM classifier's weights)."""

from __future__ import annotations

import numpy as np


class EarlyStopping:
    """Patience counter on a minimized metric. Pass -val_accuracy for the
    classification experiments (reference exp:361) or val_loss for regression.
    `improved` is True on the calls where a new best was recorded — the caller
    snapshots the model then (reference saves checkpoint.pth there)."""

    def __init__(self, patience: int = 7, delta: float = 0.0):
        self.patience = patience
        self.delta = delta
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.improved = False

    def __call__(self, metric: float) -> bool:
        score = -metric
        # reference: score < best + delta -> one more strike; ties reset.
        if self.best_score is None or score >= self.best_score + self.delta:
            self.best_score = score
            self.counter = 0
            self.improved = True
        else:
            self.counter += 1
            self.improved = False
            if self.counter >= self.patience:
                self.early_stop = True
        return self.improved

    def state_dict(self) -> dict:
        return {"best_score": float(self.best_score or 0.0),
                "counter": int(self.counter),
                "has_best": self.best_score is not None}

    def load_state_dict(self, state: dict):
        self.best_score = state["best_score"] if state.get("has_best") else None
        self.counter = int(state["counter"])
        self.early_stop = self.counter >= self.patience


def convert_to_hms(seconds: float) -> str:
    total = int(seconds)
    return f"{total // 3600:02d}:{(total % 3600) // 60:02d}:{total % 60:02d}"


def gini_coefficient(w: np.ndarray) -> float:
    """Per-class Gini of weight rows, averaged (reference utils/tools.py:54-77)."""
    w = np.asarray(w)
    if w.ndim != 2 or w.shape[1] == 0:
        return 0.0
    ginis = []
    for c in range(w.shape[0]):
        x = np.sort(np.asarray(w[c], dtype=np.float64))
        n = len(x)
        total = x.sum()
        index = np.arange(1, n + 1)
        ginis.append((2 * np.sum(index * x)) / (n * total) - (n + 1) / n)
    return float(np.mean(ginis))
