"""Dataset provider: the registry and factory of sie_tpu/data/provider.py
for the families the port has.

Classification datasets (EEG, EEG3, UEA) and the Monash regression archive
map to a fixed-shape `Batcher` (shuffled for 'train' only; the final partial
batch padded and weighted out). A regression test split takes the train
split's `bin_edges`; an EEG split takes `loso_test_subject` (that subject
is the test set). The registry keeps the JAX package's other names, whose
loaders are not ported yet: the forecast sets (ETT*, custom, m4) and the
anomaly segments (PSM, MSL, SMAP, SMD, SWAT) raise NotImplementedError
naming ROADMAP.md, as does `stream_from_disk`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from sie_tpu_torch.config import Config
from sie_tpu_torch.data.loader import Batcher
from sie_tpu_torch.models.layers import not_ported


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


def _unported(name: str):
    def load(cfg: Config, flag: str, **_):
        raise not_ported(f"the {name!r} data loader")
    return load


DATA_REGISTRY: Dict[str, Callable] = {
    **{name: _unported(name) for name in (
        "ETTh1", "ETTh2", "ETTm1", "ETTm2", "custom", "m4", "PSM", "MSL",
        "SMAP", "SMD", "SWAT")},
    "UEA": _uea,
    "Monash": _monash,
    "EEG": _eeg(three_class=False),
    "EEG3": _eeg(three_class=True),
}


def data_provider(cfg: Config, flag: str,
                  bin_edges: Optional[np.ndarray] = None,
                  loso_test_subject: Optional[int] = None):
    """(ArrayDataset, Batcher) of split `flag` ('train', 'val' or 'test';
    any case)."""
    flag = flag.lower()
    if cfg.data not in DATA_REGISTRY:
        raise ValueError(f"unknown data {cfg.data!r} "
                         f"(known: {sorted(DATA_REGISTRY)})")
    if cfg.stream_from_disk:
        raise not_ported("streaming splits from disk (stream_from_disk)")
    ds = DATA_REGISTRY[cfg.data](cfg, flag, bin_edges=bin_edges,
                                 loso_test_subject=loso_test_subject)
    batcher = Batcher(ds, cfg.batch_size, shuffle=flag == "train",
                      seed=max(cfg.seed, 0), drop_last=False)
    return ds, batcher
