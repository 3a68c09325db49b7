"""Dense-array dataset and fixed-shape batcher: a copy of
sie_tpu/data/loader.py (numpy only).

All samples live in dense numpy arrays (x, padding_mask, y), and the
batcher yields fixed-shape batches, so every epoch of a split has the same
(steps, batch) schedule and a training step captured once replays for all
of them. The final partial batch is padded with repeats of row 0 and masked
out with zero weights instead of changing shape. The batch order of an
epoch is `np.random.default_rng((seed, epoch)).permutation(n)`, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ArrayDataset:
    """x: (N, T, C) f32; y: (N,) int32 (classification) or f32 (regression);
    padding_mask: (N, T) f32 with 1 = real timestep."""

    x: np.ndarray
    y: np.ndarray
    padding_mask: np.ndarray
    # metadata consumed by the experiment (_get_params_from_data parity)
    max_seq_len: int = 0
    enc_in: int = 0
    num_class: int = 0
    class_names: Tuple[str, ...] = ()
    subject_ids: Optional[np.ndarray] = None  # per-sample subject index (EEG)
    bin_edges: Optional[np.ndarray] = None    # regression bins (Monash)
    original_fs: int = 500
    target_fs: int = 256

    def __post_init__(self):
        if self.max_seq_len == 0 and self.x.size:
            self.max_seq_len = self.x.shape[1]
        if self.enc_in == 0 and self.x.size:
            self.enc_in = self.x.shape[2]

    def __len__(self) -> int:
        return len(self.x)

    @property
    def seq_len(self) -> int:
        return self.x.shape[1]


class Batcher:
    """Fixed-shape batch iterator.

    yields (x (B,T,C), y (B,), mask (B,T), weight (B,)) where weight is 0 for
    pad samples in the final partial batch.
    """

    def __init__(self, ds: ArrayDataset, batch_size: int, shuffle: bool,
                 seed: int = 0, drop_last: bool = False):
        self.ds = ds
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch: Optional[int] = None) -> Iterator[Tuple[np.ndarray, ...]]:
        n = len(self.ds)
        b = self.batch_size
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        nb = len(self)
        for i in range(nb):
            idx = order[i * b:(i + 1) * b]
            w = np.ones((len(idx),), np.float32)
            if len(idx) < b:  # pad the final batch to fixed shape
                pad = np.zeros((b - len(idx),), order.dtype)
                idx = np.concatenate([idx, pad])
                w = np.concatenate([w, np.zeros((b - len(w),), np.float32)])
            yield (self.ds.x[idx], self.ds.y[idx],
                   self.ds.padding_mask[idx], w)

    def epoch_indices(self, epoch: Optional[int] = None):
        """Index/weight pairs for the device-resident data path: the data stays
        in HBM; only (B,) int32 indices cross the host boundary per step."""
        n = len(self.ds)
        b = self.batch_size
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            order = rng.permutation(n).astype(np.int32)
        else:
            order = np.arange(n, dtype=np.int32)
        for i in range(len(self)):
            idx = order[i * b:(i + 1) * b]
            w = np.ones((len(idx),), np.float32)
            if len(idx) < b:
                idx = np.concatenate([idx, np.zeros((b - len(idx),), np.int32)])
                w = np.concatenate([w, np.zeros((b - len(w),), np.float32)])
            yield idx, w

    def __iter__(self):
        return self.epoch()


def standardize(x: np.ndarray, lengths: Optional[np.ndarray] = None,
                mean: Optional[np.ndarray] = None,
                std: Optional[np.ndarray] = None):
    """Whole-dataset per-dimension standardization over all real timesteps
    (reference uea.py Normalizer 'standardization': pandas mean/std with ddof=1
    over the long-format frame, +float64 eps)."""
    n, t, c = x.shape
    if lengths is None:
        lengths = np.full((n,), t, np.int32)
    mask = (np.arange(t)[None, :] < lengths[:, None])
    flat = x.reshape(-1, c)[mask.reshape(-1)]
    if mean is None:
        mean = flat.mean(axis=0, dtype=np.float64)
        std = flat.std(axis=0, ddof=1, dtype=np.float64)
    eps = np.finfo(float).eps
    out = (x - mean.astype(np.float32)) / (std + eps).astype(np.float32)
    out = out * mask[..., None]  # keep padding at exactly 0
    return out.astype(np.float32), mean, std


def normalize_array(x: np.ndarray, lengths: Optional[np.ndarray] = None,
                    norm_type: str = "standardization") -> np.ndarray:
    """All four reference Normalizer modes (data_factory/uea.py:85-109) on
    dense (N, T, C) arrays. 'standardization'/'minmax' pool stats over every
    real timestep of the whole set; 'per_sample_*' normalize each sample over
    its own timesteps (pandas groupby-transform semantics: ddof-1 std with NO
    eps for per_sample_std, +float64 eps for the minmax modes)."""
    n, t, c = x.shape
    if lengths is None:
        lengths = np.full((n,), t, np.int32)
    mask = (np.arange(t)[None, :] < lengths[:, None])
    eps = np.finfo(float).eps
    if norm_type == "standardization":
        out, _, _ = standardize(x, lengths)
        return out
    if norm_type == "minmax":
        flat = x.reshape(-1, c)[mask.reshape(-1)]
        mn, mx = flat.min(axis=0), flat.max(axis=0)
        out = (x - mn) / (mx - mn + eps)
    elif norm_type == "per_sample_std":
        big = np.where(mask[..., None], x.astype(np.float64), np.nan)
        mean = np.nanmean(big, axis=1, keepdims=True)
        std = np.nanstd(big, axis=1, keepdims=True, ddof=1)
        out = (x - mean) / std  # reference adds no eps here (uea.py:99)
    elif norm_type == "per_sample_minmax":
        big = np.where(mask[..., None], x.astype(np.float64), np.nan)
        mn = np.nanmin(big, axis=1, keepdims=True)
        mx = np.nanmax(big, axis=1, keepdims=True)
        out = (x - mn) / (mx - mn + eps)
    else:
        raise NameError(f'Normalize method "{norm_type}" not implemented')
    return (out * mask[..., None]).astype(np.float32)


def lengths_to_mask(lengths: np.ndarray, t: int) -> np.ndarray:
    return (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
