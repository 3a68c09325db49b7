"""Anomaly-detection segments (counterpart of sie_tpu/data/anomaly.py,
the reference's PSM/MSL/SMAP/SMD/SWaT SegLoaders): train and test value
arrays (and test labels), per-feature standardisation fitted on train,
windows of `win_size` every `step` (100) rows on train and every
`win_size` rows on test. Files are `.npy`, or `.csv` (PSM), read with the
`csv` module: the columns whose every cell is a number, missing cells
then 0 (pandas' `select_dtypes(include=[np.number])` and `nan_to_num`)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from sie_tpu_torch.data.table import column_matrix, numeric_columns, read_table


@dataclass
class SegDataset:
    values: np.ndarray              # (T, C) scaled
    labels: Optional[np.ndarray]    # (T,) 0/1 anomaly labels or None
    win_size: int
    step: int

    def __len__(self) -> int:
        return max((len(self.values) - self.win_size) // self.step + 1, 0)

    def __getitem__(self, i: int):
        lo = i * self.step
        window = self.values[lo: lo + self.win_size]
        lab = (self.labels[lo: lo + self.win_size]
               if self.labels is not None else np.zeros((self.win_size,), np.float32))
        return window, lab


def _standardize(train: np.ndarray, x: np.ndarray) -> np.ndarray:
    mean = train.mean(axis=0)
    std = train.std(axis=0) + 1e-8
    return ((x - mean) / std).astype(np.float32)


def _read_csv(path: str) -> np.ndarray:
    header, rows = read_table(path)
    return np.nan_to_num(column_matrix(rows, numeric_columns(header, rows)))


def load_segments(root_path: str, dataset: str, flag: str,
                  win_size: int = 100, step: int = 100) -> SegDataset:
    """dataset in {'PSM','MSL','SMAP','SMD','SWAT'}; reads
    {dataset}_train / {dataset}_test / {dataset}_test_label, or train /
    test / test_label (PSM), each .npy or .csv."""
    def _load(name):
        npy = os.path.join(root_path, f"{name}.npy")
        csv = os.path.join(root_path, f"{name}.csv")
        if os.path.exists(npy):
            return np.load(npy)
        if os.path.exists(csv):
            return _read_csv(csv)
        raise FileNotFoundError(f"{npy} / {csv}")

    prefix = "" if os.path.exists(os.path.join(root_path, "train.npy")) \
        or os.path.exists(os.path.join(root_path, "train.csv")) \
        else f"{dataset}_"
    train = _load(f"{prefix}train")
    if flag.lower() == "train":
        return SegDataset(_standardize(train, train), None, win_size, step)
    test = _load(f"{prefix}test")
    labels = None
    for lname in (f"{prefix}test_label", "test_label"):
        try:
            labels = _load(lname).reshape(-1).astype(np.float32)
            break
        except FileNotFoundError:
            continue
    return SegDataset(_standardize(train, test), labels, win_size, win_size)
