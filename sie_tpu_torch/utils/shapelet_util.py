"""Result bundle and interpretability scores: a copy of the numpy part of
sie_tpu/utils/shapelet_util.py (`ClassificationResult`,
`compute_shapelet_score`, `extract_shapelets` over the flax-layout
parameter tree that `compat.from_jax.to_jax_params` gives). The plotting
helpers are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class ClassificationResult:
    """Everything test() exports (reference utils/shapelet_util.py:31-41)."""

    accuracy: float = 0.0
    loss: float = 0.0
    num_samples: int = 0
    x: Optional[np.ndarray] = None
    trues: Optional[np.ndarray] = None
    preds: Optional[np.ndarray] = None
    shapelet_preds: Optional[np.ndarray] = None
    dnn_preds: Optional[np.ndarray] = None
    p: Optional[np.ndarray] = None
    d: Optional[np.ndarray] = None
    eta: Optional[np.ndarray] = None
    w: Optional[np.ndarray] = None            # (num_class, F) classifier weights
    shapelets: Optional[List[Tuple[np.ndarray, int]]] = None
    summary: Optional[dict] = None            # the CSV row (save_csv)


def compute_shapelet_score(shapelet_distances: np.ndarray, cls_weights: np.ndarray,
                           y_pred: np.ndarray, y_true: np.ndarray) -> float:
    """Mean distance-weighted class score over correctly-predicted samples
    (reference exp/experiment_classification.py:29-34)."""
    score = shapelet_distances @ np.maximum(cls_weights.T, 0) / shapelet_distances.shape[-1]
    correct = y_pred == y_true
    if not correct.any():
        return float("nan")
    score_correct = score[correct]
    class_correct = y_true[correct]
    return float(score_correct[np.arange(len(class_correct)), class_correct].mean())


def extract_shapelets(params: dict) -> List[Tuple[np.ndarray, int]]:
    """Flatten the shapelet banks to (waveform, channel) pairs
    (reference model/Shapelet.py:232-238 ordering: bank, shapelet, channel)."""
    out: List[Tuple[np.ndarray, int]] = []
    sbm = params.get("sbm", params)
    i = 0
    while f"shapelets_{i}" in sbm:
        bank = np.asarray(sbm[f"shapelets_{i}"])
        for k in range(bank.shape[0]):
            for c in range(bank.shape[1]):
                out.append((bank[k, c, :], c))
        i += 1
    return out

