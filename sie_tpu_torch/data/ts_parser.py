"""Parser for the `.ts` time-series archive format (UEA and Monash): a copy
of sie_tpu/data/ts_parser.py. `parse_ts_file` takes the native C++ scanner
(data/native.py, built with g++ at first use) when it is available, and
this Python parser otherwise, or when SIE_TPU_NO_NATIVE is set.

  # comment lines
  @problemName <name>
  @timeStamps <bool>
  @missing <bool>
  @univariate <bool> / @dimensions <int>
  @equalLength <bool> / @seriesLength <int>
  @classLabel <bool> [label1 label2 ...]     (classification)
  @targetlabel <bool>                        (regression)
  @data
  dim1_v1,dim1_v2,...:dim2_v1,...:<label-or-target>

Missing values are '?' -> NaN.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class TsFile:
    """Parsed .ts archive: ragged per-sample, per-dimension series."""

    series: List[List[np.ndarray]]           # [sample][dim] -> (len,) f32
    labels: List[str]                        # raw label strings / target strings
    class_labels: Optional[List[str]] = None  # declared classes (classification)
    is_regression: bool = False
    problem_name: str = ""
    equal_length: bool = True
    n_dims: int = 1

    @property
    def n_samples(self) -> int:
        return len(self.series)


def parse_ts_file(path: str, use_native: bool = True) -> TsFile:
    """Parse a .ts archive: through the native scanner
    (sie_tpu_torch/native/ts_scan.cpp) when it is available, else with the
    Python parser below, the reference it is held to. Set
    SIE_TPU_NO_NATIVE=1 to force the Python path."""
    if use_native and not os.environ.get("SIE_TPU_NO_NATIVE"):
        from sie_tpu_torch.data.native import parse_ts_file_fast
        parsed = parse_ts_file_fast(path)
        if parsed is not None:
            return parsed
    return _parse_ts_file_py(path)


def _parse_ts_file_py(path: str) -> TsFile:
    series: List[List[np.ndarray]] = []
    labels: List[str] = []
    class_labels: Optional[List[str]] = None
    is_regression = False
    problem_name = os.path.basename(path)
    equal_length = True
    has_class_label = False
    in_data = False

    with open(path, "r", encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if not in_data and line.lower().startswith("@"):
                tokens = line.split()
                tag = tokens[0].lower()
                if tag == "@problemname" and len(tokens) > 1:
                    problem_name = tokens[1]
                elif tag == "@equallength" and len(tokens) > 1:
                    equal_length = tokens[1].lower() == "true"
                elif tag == "@classlabel":
                    has_class_label = len(tokens) > 1 and tokens[1].lower() == "true"
                    if has_class_label:
                        class_labels = tokens[2:]
                elif tag == "@targetlabel":
                    is_regression = len(tokens) > 1 and tokens[1].lower() == "true"
                elif tag == "@data":
                    in_data = True
                continue
            if not in_data:
                continue
            # data line
            fields = line.split(":")
            if has_class_label or is_regression:
                label = fields[-1].strip()
                dims = fields[:-1]
            else:
                label = ""
                dims = fields
            sample = []
            for dim in dims:
                dim = dim.strip()
                if not dim:
                    sample.append(np.zeros((0,), np.float32))
                    continue
                vals = np.array(dim.replace("?", "nan").split(","),
                                dtype=np.float64)
                sample.append(vals.astype(np.float32))
            series.append(sample)
            labels.append(label)

    n_dims = max((len(s) for s in series), default=1)
    return TsFile(series=series, labels=labels, class_labels=class_labels,
                  is_regression=is_regression, problem_name=problem_name,
                  equal_length=equal_length, n_dims=n_dims)


def interpolate_missing(y: np.ndarray) -> np.ndarray:
    """Linear interpolation of NaNs, both directions (reference uea.py:110-116)."""
    if not np.isnan(y).any():
        return y
    n = len(y)
    idx = np.arange(n)
    good = ~np.isnan(y)
    if not good.any():
        return np.zeros_like(y)
    return np.interp(idx, idx[good], y[good]).astype(y.dtype)


def subsample(y: np.ndarray, limit: int = 256, factor: int = 2) -> np.ndarray:
    """Stride-subsample overlong series (reference uea.py:119-125)."""
    if len(y) > limit:
        return y[::factor]
    return y


def to_dense(ts: TsFile, apply_subsample_on_ragged_dims: bool = True):
    """Ragged series -> dense arrays.

    Mirrors the reference UEAloader post-processing (data_loader.py:676-702):
    - if any sample has dimension-length mismatch, subsample every cell;
    - NaNs linearly interpolated per series;
    - pad with zeros up to the max length; boolean length mask returned.

    Returns (x (N, T, C) f32, lengths (N,) i32, max_seq_len).
    """
    series = ts.series
    lengths = np.array([[len(d) for d in s] for s in series], dtype=np.int64)
    if lengths.size and apply_subsample_on_ragged_dims:
        horiz = np.abs(lengths - lengths[:, :1])
        if horiz.sum() > 0:
            series = [[subsample(d) for d in s] for s in series]
            lengths = np.array([[len(d) for d in s] for s in series], dtype=np.int64)

    n = len(series)
    c = ts.n_dims
    # size the buffer and per-sample lengths over ALL dims — a sample whose
    # later dim is longer than dim 0 must not overflow (or be mismasked)
    max_len = int(lengths.max()) if n and lengths.size else 0
    x = np.zeros((n, max_len, c), np.float32)
    sample_len = np.zeros((n,), np.int32)
    for i, s in enumerate(series):
        sample_len[i] = max((len(d) for d in s), default=0)
        for d, vals in enumerate(s):
            vals = interpolate_missing(vals)
            x[i, : len(vals), d] = vals
    return x, sample_len, max_len
