"""Forecasting window datasets (counterpart of sie_tpu/data/forecast.py,
TSlib's Dataset_ETT_hour, Dataset_ETT_minute, Dataset_Custom and
Dataset_M4), read with the `csv` module instead of pandas.

Split boundaries:
- ETT hour:   train 12 months, val 4, test 4 (30*24-hour months)
- ETT minute: the same months at 15-minute resolution (4x)
- custom CSV: 70% / 10% / 20%
Windows: x = [t, t+seq_len), y = [t+seq_len-label_len, t+seq_len+pred_len).
Per-feature standardisation fitted on the train split, and calendar time
features (utils/timefeatures.py) of the first column's dates, which are
`YYYY-MM-DD HH:MM:SS` or `YYYY-MM-DD` (what pandas parses in the ETT and
custom files); another format raises ValueError naming the column.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from sie_tpu_torch.data.table import column_matrix, read_table
from sie_tpu_torch.utils.timefeatures import time_features

_DATE = re.compile(r"\d{4}-\d{2}-\d{2}( \d{2}:\d{2}:\d{2})?")


@dataclass
class ForecastDataset:
    data: np.ndarray            # (T, C) scaled values
    stamp: np.ndarray           # (T, F) time features
    seq_len: int
    label_len: int
    pred_len: int
    mean: Optional[np.ndarray] = None
    std: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.data) - self.seq_len - self.pred_len + 1

    def __getitem__(self, i: int):
        s_end = i + self.seq_len
        r_begin = s_end - self.label_len
        r_end = s_end + self.pred_len
        return (self.data[i:s_end], self.data[r_begin:r_end],
                self.stamp[i:s_end], self.stamp[r_begin:r_end])

    def inverse_transform(self, x):
        if self.mean is None:
            return x
        return x * self.std + self.mean


def parse_dates(cells, column: str) -> np.ndarray:
    """datetime64[s] of `YYYY-MM-DD HH:MM:SS` or `YYYY-MM-DD` strings."""
    for c in cells:
        if not _DATE.fullmatch(c.strip()):
            raise ValueError(f"date column {column!r}: {c!r} is neither "
                             f"YYYY-MM-DD HH:MM:SS nor YYYY-MM-DD")
    return np.array([c.strip().replace(" ", "T") for c in cells],
                    dtype="datetime64[s]")


def _window_split(n: int, flag: str, borders) -> Tuple[int, int]:
    (b1s, b1e), (b2s, b2e), (b3s, b3e) = borders
    return {"train": (b1s, b1e), "val": (b2s, b2e), "test": (b3s, b3e)}[flag]


def load_forecast_csv(path: str, flag: str = "train", size=(96, 48, 96),
                      features: str = "M", target: str = "OT",
                      scale: bool = True, freq: str = "h",
                      dataset_kind: str = "custom") -> ForecastDataset:
    """dataset_kind: 'ETTh' | 'ETTm' | 'custom'."""
    seq_len, label_len, pred_len = size
    header, rows = read_table(path)
    date_col = header[0]
    dates = parse_dates([r[0] for r in rows], date_col)
    names = header[1:]
    if features == "S":
        names = [target]
    elif target in names:
        # target column last, so the 'MS' consumers can slice [..., -1:]
        names = [c for c in names if c != target] + [target]
    cols = [header.index(c) for c in names]
    # column-major, as pandas' to_numpy returns a frame's block: the
    # float32 means below then sum in the same order, bit for bit
    data = np.asfortranarray(column_matrix(rows, cols, np.float32))
    n = len(data)

    if dataset_kind == "ETTh":
        month = 30 * 24
        borders = ((0, 12 * month), (12 * month - seq_len, 16 * month),
                   (16 * month - seq_len, 20 * month))
    elif dataset_kind == "ETTm":
        month = 30 * 24 * 4
        borders = ((0, 12 * month), (12 * month - seq_len, 16 * month),
                   (16 * month - seq_len, 20 * month))
    else:
        n_train = int(n * 0.7)
        n_test = int(n * 0.2)
        n_val = n - n_train - n_test
        borders = ((0, n_train), (n_train - seq_len, n_train + n_val),
                   (n - n_test - seq_len, n))
    borders = tuple((max(0, a), min(n, b)) for a, b in borders)

    mean = std = None
    if scale:
        tr0, tr1 = borders[0]
        mean = data[tr0:tr1].mean(axis=0)
        std = data[tr0:tr1].std(axis=0) + 1e-8
        data = (data - mean) / std

    stamp = time_features(dates, freq).T.astype(np.float32)
    lo, hi = _window_split(n, flag.lower(), borders)
    return ForecastDataset(data[lo:hi], stamp[lo:hi], seq_len, label_len,
                           pred_len, mean, std)


@dataclass
class M4Dataset:
    """Per-series M4 windows: each item is (history padded or cropped to
    seq_len at its end, the horizon padded to pred_len)."""

    insample: list                  # per-series history (1-D arrays)
    outsample: list                 # per-series target horizon
    seq_len: int
    pred_len: int

    def __len__(self):
        return len(self.insample)

    def __getitem__(self, i: int):
        src = self.insample[i]
        insample = np.zeros((self.seq_len,), np.float32)
        take = min(len(src), self.seq_len)
        insample[-take:] = src[-take:]
        outsample = np.zeros((self.pred_len,), np.float32)
        tail = self.outsample[i][: self.pred_len]
        outsample[: len(tail)] = tail
        return insample, outsample


def read_m4_rows(path: str, dtype=np.float32) -> list:
    """M4-format CSV rows (first column the id, the rest the ragged values)
    as (id, values) pairs, missing cells dropped, empty rows skipped."""
    _header, rows = read_table(path)
    out = []
    for row in rows:
        vals = column_matrix([row], range(1, len(row)))[0]
        vals = vals[~np.isnan(vals)].astype(dtype)
        if len(vals):
            out.append((row[0], vals))
    return out


def _holdout_split(series: list, seq_len: int, pred_len: int) -> M4Dataset:
    """Train/val pairs entirely within the training series: the final
    horizon of each series is the target, everything before it the
    history."""
    ins = [s[: max(len(s) - pred_len, 1)] for s in series]
    outs = [s[max(len(s) - pred_len, 1):] for s in series]
    return M4Dataset(ins, outs, seq_len, pred_len)


def load_m4_csv(path: str, seq_len: int, pred_len: int) -> M4Dataset:
    """Single-CSV loader: holdout-split training pairs."""
    series = [v for _id, v in read_m4_rows(path)]
    return _holdout_split(series, seq_len, pred_len)


def load_m4(root: str, name: str, seq_len: int, pred_len: int,
            flag: str) -> M4Dataset:
    """The M4 subset `name` for split `flag`, from the first source found:

    1. the npz cache (`M4-info.csv` + training.npz/test.npz, written by
       data.m4.build_m4_cache) filtered to the seasonal pattern;
    2. `{name}-train.csv` / `{name}-test.csv` pairs (the public layout);
    3. a single `{name}.csv`, train/val only (holdout split): the test
       split refuses it rather than score training targets.

    Test pairs: history = the full training series, target = the held-out
    test horizon."""
    from sie_tpu_torch.data.m4 import M4Dataset as M4Cache

    want_test = flag == "test"
    if (os.path.exists(os.path.join(root, "M4-info.csv"))
            and os.path.exists(os.path.join(root, "training.npz"))):
        tr = M4Cache.load(training=True, dataset_file=root)
        keep = np.asarray(tr.groups) == name
        train_series = [np.asarray(v, np.float32) for v in tr.values[keep]]
        if want_test:
            te = M4Cache.load(training=False, dataset_file=root)
            test_series = [np.asarray(v, np.float32) for v in te.values[keep]]
            return M4Dataset(train_series, test_series, seq_len, pred_len)
        return _holdout_split(train_series, seq_len, pred_len)

    pair = os.path.join(root, f"{name}-train.csv")
    if os.path.exists(pair):
        train_series = [v for _id, v in read_m4_rows(pair)]
        if want_test:
            tpath = os.path.join(root, f"{name}-test.csv")
            if not os.path.exists(tpath):
                raise FileNotFoundError(
                    f"{tpath} not found — the M4 test split needs the "
                    "held-out horizons (or the npz cache)")
            test_series = [v for _id, v in read_m4_rows(tpath)]
            return M4Dataset(train_series, test_series, seq_len, pred_len)
        return _holdout_split(train_series, seq_len, pred_len)

    single = os.path.join(root, f"{name}.csv")
    if want_test:
        raise FileNotFoundError(
            f"no M4 test source under {root!r} (need {name}-test.csv or the "
            "npz cache); refusing to evaluate on training targets")
    return load_m4_csv(single, seq_len, pred_len)
