"""Result bundle, interpretability scores and plots: a copy of
sie_tpu/utils/shapelet_util.py (`ClassificationResult`,
`compute_shapelet_score`, `extract_shapelets` over the flax-layout
parameter tree that `compat.from_jax.to_jax_params` gives, `smooth_array`,
`visualize_shapelets`, `plot_tsne`). The two plots import matplotlib, and
`plot_tsne` sklearn, inside the function, as the JAX package's do: the
package itself needs neither.
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


def smooth_array(arr: np.ndarray, window: int = 5) -> np.ndarray:
    if window <= 1:
        return arr
    kernel = np.ones(window) / window
    return np.convolve(arr, kernel, mode="same")


def visualize_shapelets(result: ClassificationResult, sample_idx: int = 0,
                        top_k: int = 5, save_path: Optional[str] = None):
    """Global/local explanation overlays (reference utils/shapelet_util.py:44-195):
    plots the top-weighted shapelets and their best-matching window (sliding MSE)
    on a test sample. Requires matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = result.x[sample_idx]                       # (T, C)
    w = result.w
    pred = int(np.argmax(result.preds[sample_idx]))
    order = np.argsort(-w[pred])[:top_k]
    fig, axes = plt.subplots(top_k, 1, figsize=(10, 2.2 * top_k), squeeze=False)
    for row, fi in enumerate(order):
        wave, ch = result.shapelets[fi]
        sig = x[:, ch]
        L = len(wave)
        if L <= len(sig):
            errs = np.array([((sig[i:i + L] - wave) ** 2).mean()
                             for i in range(len(sig) - L + 1)])
            best = int(np.argmin(errs))
        else:
            best = 0
        ax = axes[row][0]
        ax.plot(sig, lw=0.8, label=f"channel {ch}")
        ax.plot(np.arange(best, best + min(L, len(sig) - best)),
                wave[: len(sig) - best], lw=1.6,
                label=f"shapelet {fi} (w={w[pred, fi]:.3f})")
        ax.legend(loc="upper right", fontsize=7)
    fig.suptitle(f"sample {sample_idx}: predicted class {pred}")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def plot_tsne(features: np.ndarray, labels: np.ndarray,
              save_path: Optional[str] = None):
    """t-SNE of predicate vectors colored by class (reference shapelet_util.py)."""
    from sklearn.manifold import TSNE
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    emb = TSNE(n_components=2, init="pca",
               perplexity=min(30, max(2, len(features) // 4))).fit_transform(features)
    fig, ax = plt.subplots(figsize=(6, 5))
    sc = ax.scatter(emb[:, 0], emb[:, 1], c=labels, s=8, cmap="tab10")
    fig.colorbar(sc, ax=ax)
    if save_path:
        fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path
