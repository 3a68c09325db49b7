"""Monash extrinsic-regression archive loader: a copy of
sie_tpu/data/monash.py (numpy) on the port's parser and loader.

Float targets; nbins = 10 linear bin edges computed on TRAIN (first edge
-inf, last +inf, edges[1:] kept) and shared with the test split, as the
reference's Monashloader does (data_loader.py:798-810).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sie_tpu_torch.data.loader import ArrayDataset, lengths_to_mask, standardize
from sie_tpu_torch.data.ts_parser import parse_ts_file, to_dense
from sie_tpu_torch.data.uea import _find_ts


def make_bin_edges(targets: np.ndarray, nbins: int = 10) -> np.ndarray:
    edges = np.linspace(targets.min(), targets.max(), nbins + 1)
    edges[0] = -np.inf
    edges[-1] = np.inf
    return edges[1:]


def load_monash_dataset(root_path: str, dataset: str, flag: str,
                        bin_edges: Optional[np.ndarray] = None,
                        nbins: int = 10) -> ArrayDataset:
    split = "TRAIN" if flag.lower() == "train" else "TEST"
    ts = parse_ts_file(_find_ts(root_path, dataset, split))
    x, lengths, max_len = to_dense(ts)
    y = np.array([float(l) for l in ts.labels], np.float32)
    if bin_edges is None:
        bin_edges = make_bin_edges(y, nbins)
    x, _, _ = standardize(x, lengths)
    return ArrayDataset(
        x=x, y=y, padding_mask=lengths_to_mask(lengths, x.shape[1]),
        max_seq_len=max_len, enc_in=x.shape[2], num_class=len(bin_edges),
        class_names=tuple(str(e) for e in bin_edges), bin_edges=bin_edges)
