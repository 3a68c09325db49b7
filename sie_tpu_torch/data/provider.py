"""Dataset provider: the registry and factory of sie_tpu/data/provider.py.

The registry carries the JAX package's fifteen entries: classification
(EEG, EEG3, UEA), regression (Monash), forecasting (ETTh1, ETTh2, ETTm1,
ETTm2, custom, m4) and anomaly segments (PSM, MSL, SMAP, SMD, SWAT).
Classification and regression datasets map to a fixed-shape `Batcher`
(shuffled for 'train' only; the final partial batch padded and weighted
out); a regression test split takes the train split's `bin_edges`, an
EEG split takes `loso_test_subject` (that subject is the test set). The
forecast and anomaly datasets map to an `IndexedBatcher` over their
windows.

Under `stream_from_disk` an ArrayDataset split lives in a memmap cache
(data/stream.py) under `cache_dir`, named by `_stream_path` as the JAX
package names it, so either package opens the other's cache. A warm cache
is opened without running the registry loader; a cold one is loaded,
written and opened. The forecast and anomaly families keep their own
loaders: the flag changes nothing for them.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np

from sie_tpu_torch.config import Config
from sie_tpu_torch.data.loader import ArrayDataset, Batcher, IndexedBatcher


def _eeg(three_class: bool):
    def load(cfg: Config, flag: str, *, loso_test_subject=None, **_):
        from sie_tpu_torch.data.eeg import load_eeg_dataset
        return load_eeg_dataset(cfg, flag, three_class=three_class,
                                loso_test_subject=loso_test_subject)
    return load


def _uea(cfg: Config, flag: str, **_):
    from sie_tpu_torch.data.uea import load_uea_dataset
    return load_uea_dataset(cfg.data_root, cfg.dataset, flag,
                            norm_type=cfg.normalizer)


def _monash(cfg: Config, flag: str, *, bin_edges=None, **_):
    from sie_tpu_torch.data.monash import load_monash_dataset
    return load_monash_dataset(cfg.data_root, cfg.dataset, flag,
                               bin_edges=bin_edges)


def _forecast(kind: str):
    def load(cfg: Config, flag: str, **_):
        from sie_tpu_torch.data.forecast import load_forecast_csv
        path = os.path.join(cfg.data_root, f"{cfg.dataset}.csv")
        return load_forecast_csv(
            path, flag, size=(cfg.seq_len, cfg.label_len, cfg.pred_len),
            features=cfg.features, target=cfg.target,
            freq=cfg.freq, dataset_kind=kind)
    return load


def _m4(cfg: Config, flag: str, **_):
    from sie_tpu_torch.data.forecast import load_m4
    from sie_tpu_torch.data.m4 import M4Meta
    # --seasonal_patterns picks the subset; its horizon overrides pred_len
    name = cfg.seasonal_patterns
    pred = M4Meta.horizons_map.get(name, cfg.pred_len)
    return load_m4(cfg.data_root, name, cfg.seq_len, pred, flag)


def _anomaly(name: str):
    def load(cfg: Config, flag: str, **_):
        from sie_tpu_torch.data.anomaly import load_segments
        return load_segments(cfg.data_root, name, flag, win_size=cfg.seq_len)
    return load


DATA_REGISTRY: Dict[str, Callable] = {
    "ETTh1": _forecast("ETTh"),
    "ETTh2": _forecast("ETTh"),
    "ETTm1": _forecast("ETTm"),
    "ETTm2": _forecast("ETTm"),
    "custom": _forecast("custom"),
    "m4": _m4,
    "PSM": _anomaly("PSM"),
    "MSL": _anomaly("MSL"),
    "SMAP": _anomaly("SMAP"),
    "SMD": _anomaly("SMD"),
    "SWAT": _anomaly("SWAT"),
    "UEA": _uea,
    "Monash": _monash,
    "EEG": _eeg(three_class=False),
    "EEG3": _eeg(three_class=True),
}


def _stream_path(cfg: Config, flag: str, loso_test_subject) -> str:
    """The memmap cache directory of a split: an md5 over the config fields
    that shape the split's content, the JAX package's key, field for field
    (a changed source tree under an unchanged config must clear
    cache_dir). Regression bin_edges need no key: the train split fits
    them, itself a function of these fields."""
    import hashlib

    tag = hashlib.md5(repr(
        (cfg.data, cfg.dataset, cfg.data_root, cfg.json_path, flag,
         loso_test_subject, cfg.test_size, cfg.val_size, cfg.seed,
         cfg.max_files, tuple(cfg.subject_ids), cfg.subject_id,
         cfg.max_subjects, cfg.target_channels, cfg.target_timepoints,
         cfg.original_fs, cfg.target_fs, cfg.task_type,
         cfg.normalizer)).encode()).hexdigest()[:12]
    return os.path.join(cfg.cache_dir, f"stream_{cfg.data}_{flag}_{tag}")


def data_provider(cfg: Config, flag: str,
                  bin_edges: Optional[np.ndarray] = None,
                  loso_test_subject: Optional[int] = None):
    """(dataset, batcher) of split `flag` ('train', 'val' or 'test'; any
    case): (ArrayDataset, Batcher) for classification and regression,
    (window dataset, IndexedBatcher) for the forecast and anomaly
    families."""
    flag = flag.lower()
    if cfg.data not in DATA_REGISTRY:
        raise ValueError(f"unknown data {cfg.data!r} "
                         f"(known: {sorted(DATA_REGISTRY)})")
    load = lambda: DATA_REGISTRY[cfg.data](
        cfg, flag, bin_edges=bin_edges, loso_test_subject=loso_test_subject)
    if cfg.stream_from_disk:
        from sie_tpu_torch.data import stream
        path = _stream_path(cfg, flag, loso_test_subject)
        if os.path.exists(os.path.join(path, stream.META_NAME)):
            ds = stream.open_memmap_dataset(path)
        else:
            ds = load()
            if isinstance(ds, ArrayDataset):
                stream.save_memmap_dataset(path, ds)
                ds = stream.open_memmap_dataset(path)
    else:
        ds = load()

    shuffle = flag == "train"
    if isinstance(ds, ArrayDataset):
        batcher = Batcher(ds, cfg.batch_size, shuffle=shuffle,
                          seed=max(cfg.seed, 0), drop_last=False)
    else:
        batcher = IndexedBatcher(ds, cfg.batch_size, shuffle=shuffle,
                                 seed=max(cfg.seed, 0))
    return ds, batcher
