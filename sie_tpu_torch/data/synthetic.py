"""Synthetic data generators: a copy of sie_tpu/data/synthetic.py
(CHISCO-shaped EEG trials and UEA-format archives), used by the tests and
by the flagship run when no real data is mounted. Signals are
class-conditioned mixtures of band-limited oscillations and pink-ish noise,
so models can learn them."""

from __future__ import annotations

import os
import numpy as np


def synthetic_eeg_trials(n_trials: int = 120, n_channels: int = 122,
                         n_times: int = 1651, n_classes: int = 39,
                         n_subjects: int = 3, fs: float = 500.0,
                         seed: int = 0, imbalanced: bool = False):
    """Returns (raw (N, C, T) float64 volts, text_labels list, subject_idx (N,)).

    Trial amplitude ~ tens of microvolts (so the reference's x1e6 scaling lands
    in a realistic range); class identity is encoded in the phase/frequency mix
    of a few 'source' oscillators projected through a random mixing matrix.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(n_times) / fs
    mix = rng.normal(0, 1, (n_classes, 4, n_channels))
    freqs = rng.uniform(2.0, 40.0, (n_classes, 4))
    raw = np.zeros((n_trials, n_channels, n_times))
    labels = []
    subjects = rng.integers(0, n_subjects, n_trials)
    if imbalanced:
        # Zipf-ish class mix like real word-frequency data (the CHISCO
        # 39-class regime is imbalanced; reference prints the class
        # distribution at test, exp:1080-1092)
        p = 1.0 / np.arange(1, n_classes + 1)
        classes = rng.choice(n_classes, size=n_trials, p=p / p.sum())
    else:
        classes = rng.integers(0, n_classes, n_trials)
    for i in range(n_trials):
        k = classes[i]
        phase = rng.uniform(0, 2 * np.pi, 4)
        src = np.sin(2 * np.pi * freqs[k][:, None] * t[None] + phase[:, None])
        sig = mix[k].T @ src                                  # (C, T)
        noise = rng.normal(0, 1.0, (n_channels, n_times))
        noise = np.cumsum(noise, axis=1) / np.sqrt(np.arange(1, n_times + 1))
        raw[i] = (sig * 3.0 + noise) * 1e-5                   # ~30 uV signals
        labels.append(f"word_{k:02d}")
    return raw, labels, subjects


def synthetic_textmaps(n_classes: int = 39) -> dict:
    return {f"word_{k:02d}": k for k in range(n_classes)}


def write_synthetic_uea(root: str, dataset: str = "SynthMotions",
                        n_train: int = 40, n_test: int = 40, n_dims: int = 6,
                        length: int = 100, n_classes: int = 4, seed: int = 0):
    """Writes a tiny class-separable UEA-format archive to {root}/{dataset}/."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, dataset), exist_ok=True)
    freqs = rng.uniform(0.02, 0.2, (n_classes, n_dims))
    t = np.arange(length)

    def gen(n, fname):
        lines = [f"@problemName {dataset}", "@timeStamps false",
                 "@missing false", f"@univariate {'true' if n_dims == 1 else 'false'}",
                 f"@dimensions {n_dims}", "@equalLength true",
                 f"@seriesLength {length}",
                 "@classLabel true " + " ".join(f"c{k}" for k in range(n_classes)),
                 "@data"]
        for _ in range(n):
            k = rng.integers(0, n_classes)
            dims = []
            for d in range(n_dims):
                sig = np.sin(2 * np.pi * freqs[k, d] * t + rng.uniform(0, 6.28))
                sig = sig + rng.normal(0, 0.3, length)
                dims.append(",".join(f"{v:.6f}" for v in sig))
            lines.append(":".join(dims) + f":c{k}")
        with open(os.path.join(root, dataset, fname), "w") as f:
            f.write("\n".join(lines) + "\n")

    gen(n_train, f"{dataset}_TRAIN.ts")
    gen(n_test, f"{dataset}_TEST.ts")
    return os.path.join(root, dataset)
