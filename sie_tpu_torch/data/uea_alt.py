"""Alternative UEA loader: a copy of sie_tpu/data/uea_alt.py (parity:
reference utils/uea_loader.py:14-97), numpy only.

The reference keeps a second, aeon-based UEA ingestion path —
``Normalizer`` + ``UEADataset`` (load ``.ts`` via ``aeon.load_from_tsfile``,
linearly interpolate every series to the archive's max length with
``TSInterpolator``, normalize, ``sklearn.LabelEncoder`` the labels). It is
unused by the live pipeline (SURVEY §2.5) but part of the public surface,
so it is provided here with zero external dependencies: our own ``.ts``
parser replaces aeon, and a minimal label encoder replaces sklearn's.

Reference quirks preserved (uea_loader.py:40-51):
- despite the docstring ("across ALL contained rows"), stats are computed
  with ``axis=-1, keepdims=True`` on the (N, C, T) block — i.e. per sample,
  per channel, across time only;
- stats are computed lazily on the FIRST normalize() call and reused on
  later calls (train-fit/test-apply only works while shapes broadcast);
- ``std + eps`` / ``(max - min) + eps`` with ``np.finfo(float).eps``;
- unknown norm_type raises ``NameError``.

The ~170 lines of commented-out UCR/MIMIC loaders in the reference file are
dead code and intentionally not reproduced.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sie_tpu_torch.data.ts_parser import interpolate_missing, parse_ts_file


class Normalizer:
    """Per-sample, per-channel normalization over time (uea_loader.py:14-53)."""

    def __init__(self, norm_type: str = "standard", mean=None, std=None,
                 min_val=None, max_val=None):
        self.norm_type = norm_type
        self.mean = mean
        self.std = std
        self.min_val = min_val
        self.max_val = max_val

    def normalize(self, x: np.ndarray) -> np.ndarray:
        eps = np.finfo(float).eps
        if self.norm_type == "standard":
            if self.mean is None:
                self.mean = np.mean(x, axis=-1, keepdims=True)
                self.std = np.std(x, axis=-1, keepdims=True)
            return (x - self.mean) / (self.std + eps)
        if self.norm_type == "minmax":
            if self.max_val is None:
                self.max_val = np.max(x, axis=-1, keepdims=True)
                self.min_val = np.min(x, axis=-1, keepdims=True)
            return (x - self.min_val) / (self.max_val - self.min_val + eps)
        raise NameError(f'Normalize method "{self.norm_type}" not implemented')


class LabelEncoderLite:
    """sklearn.LabelEncoder semantics: classes_ = sorted unique labels."""

    def __init__(self):
        self.classes_: Optional[np.ndarray] = None

    def fit_transform(self, y: Sequence[str]) -> np.ndarray:
        self.classes_, out = np.unique(np.asarray(y), return_inverse=True)
        return out.astype(np.int64)

    def transform(self, y: Sequence[str]) -> np.ndarray:
        if self.classes_ is None:
            raise ValueError("LabelEncoderLite used before fit")
        y = np.asarray(y)
        idx = np.searchsorted(self.classes_, y)
        bad = (idx >= len(self.classes_)) | (self.classes_[
            np.clip(idx, 0, len(self.classes_) - 1)] != y)
        if bad.any():
            raise ValueError(f"unseen labels: {sorted(set(y[bad].tolist()))}")
        return idx.astype(np.int64)


def _interp_to_length(series: np.ndarray, length: int) -> np.ndarray:
    """aeon TSInterpolator cell rule: np.interp over normalized positions."""
    n = len(series)
    if n == length:
        return np.asarray(series, np.float32)
    if n == 1:
        return np.full((length,), series[0], np.float32)
    return np.interp(np.linspace(0.0, 1.0, length),
                     np.linspace(0.0, 1.0, n),
                     series).astype(np.float32)


class UEADataset:
    """Load one UEA split the alt-loader way (uea_loader.py:57-97).

    x is (N, C, max_len) float32 — the aeon channel-first layout, unlike the
    live pipeline's (N, T, C) — y is (N,) int64. Indexing returns
    ``(x[i], y[i:i+1])`` mirroring the reference __getitem__'s
    ``y[[index]]`` shape quirk.
    """

    def __init__(self, dataset: str, root_dir: str = "./data/UEA_multivariate",
                 flag: str = "TRAIN", normalizer: Optional[Normalizer] = None,
                 label_encoder: Optional[LabelEncoderLite] = None):
        self.file_path = os.path.join(root_dir, dataset, f"{dataset}_{flag}.ts")
        self.flag = flag
        self.normalizer = Normalizer() if normalizer is None else normalizer
        self.label_encoder = (LabelEncoderLite() if label_encoder is None
                              else label_encoder)
        self.fit = label_encoder is None
        self.x, self.y = self.load()
        self.num_class = int(np.unique(self.y).shape[0])

    def load(self) -> Tuple[np.ndarray, np.ndarray]:
        ts = parse_ts_file(self.file_path)
        max_len = max((max((len(d) for d in s), default=0)
                       for s in ts.series), default=0)
        rows: List[np.ndarray] = []
        for s in ts.series:
            chans = [_interp_to_length(interpolate_missing(np.asarray(d)),
                                       max_len) for d in s]
            rows.append(np.stack(chans, 0))
        x = np.stack(rows, 0) if rows else np.zeros((0, ts.n_dims, 0), np.float32)
        x = self.normalizer.normalize(x)
        if self.fit:
            y = self.label_encoder.fit_transform(ts.labels)
        else:
            y = self.label_encoder.transform(ts.labels)
        return np.asarray(x, np.float32), y

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.x[index], self.y[[index]]

    def __len__(self) -> int:
        return int(self.x.shape[0])
