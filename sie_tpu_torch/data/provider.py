"""Dataset provider: the registry and factory of sie_tpu/data/provider.py
for the families the port has.

Classification datasets (EEG, EEG3, UEA) map to a fixed-shape `Batcher`
(shuffled for 'train' only; the final partial batch padded and weighted
out). The registry keeps the JAX package's other names, whose loaders are
not ported yet: Monash (regression), the forecast sets (ETT*, custom, m4)
and the anomaly segments (PSM, MSL, SMAP, SMD, SWAT) raise
NotImplementedError naming ROADMAP.md, as does `stream_from_disk`.
"""

from __future__ import annotations

from typing import Callable, Dict

from sie_tpu_torch.config import Config
from sie_tpu_torch.data.loader import Batcher
from sie_tpu_torch.models.layers import not_ported


def _eeg(three_class: bool):
    def load(cfg: Config, flag: str):
        from sie_tpu_torch.data.eeg import load_eeg_dataset
        return load_eeg_dataset(cfg, flag, three_class=three_class)
    return load


def _uea(cfg: Config, flag: str):
    from sie_tpu_torch.data.uea import load_uea_dataset
    return load_uea_dataset(cfg.data_root, cfg.dataset, flag,
                            norm_type=cfg.normalizer)


def _unported(name: str):
    def load(cfg: Config, flag: str):
        raise not_ported(f"the {name!r} data loader")
    return load


DATA_REGISTRY: Dict[str, Callable] = {
    **{name: _unported(name) for name in (
        "ETTh1", "ETTh2", "ETTm1", "ETTm2", "custom", "m4", "PSM", "MSL",
        "SMAP", "SMD", "SWAT", "Monash")},
    "UEA": _uea,
    "EEG": _eeg(three_class=False),
    "EEG3": _eeg(three_class=True),
}


def data_provider(cfg: Config, flag: str):
    """(ArrayDataset, Batcher) of split `flag` ('train', 'val' or
    'test')."""
    flag = flag.lower()
    if cfg.data not in DATA_REGISTRY:
        raise ValueError(f"unknown data {cfg.data!r} "
                         f"(known: {sorted(DATA_REGISTRY)})")
    if cfg.stream_from_disk:
        raise not_ported("streaming splits from disk (stream_from_disk)")
    ds = DATA_REGISTRY[cfg.data](cfg, flag)
    batcher = Batcher(ds, cfg.batch_size, shuffle=flag == "train",
                      seed=max(cfg.seed, 0), drop_last=False)
    return ds, batcher
