"""M4 competition data (counterpart of sie_tpu/data/m4.py): the
competition constants (`M4Meta`), the npz cache reader
(`M4Dataset.load`: M4-info.csv + training.npz / test.npz, the layout the
reference caches after its download) and `build_m4_cache`, which writes
that layout from the public per-group CSVs (no download), M4-info.csv
with the `csv` module."""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from sie_tpu_torch.data.table import read_table, write_table


@dataclass
class M4Meta:
    seasonal_patterns = ("Yearly", "Quarterly", "Monthly", "Weekly",
                         "Daily", "Hourly")
    horizons = (6, 8, 18, 13, 14, 48)
    frequencies = (1, 4, 12, 1, 1, 24)
    horizons_map = {"Yearly": 6, "Quarterly": 8, "Monthly": 18,
                    "Weekly": 13, "Daily": 14, "Hourly": 48}
    frequency_map = {"Yearly": 1, "Quarterly": 4, "Monthly": 12,
                     "Weekly": 1, "Daily": 1, "Hourly": 24}
    # input-window multiplier per group (N-BEATS interpretable config)
    history_size = {"Yearly": 1.5, "Quarterly": 1.5, "Monthly": 1.5,
                    "Weekly": 10, "Daily": 10, "Hourly": 10}


@dataclass
class M4Dataset:
    ids: np.ndarray          # series ids, e.g. 'Y1'
    groups: np.ndarray       # seasonal pattern per series
    frequencies: np.ndarray  # seasonal frequency per series
    horizons: np.ndarray     # forecast horizon per series
    values: np.ndarray       # object array of 1-D float arrays

    @staticmethod
    def load(training: bool = True, dataset_file: str = "./dataset/m4"
             ) -> "M4Dataset":
        """The cached dataset (M4-info.csv + training.npz or test.npz)."""
        header, rows = read_table(os.path.join(dataset_file, "M4-info.csv"))
        col = lambda name: [r[header.index(name)] for r in rows]
        cache = os.path.join(dataset_file,
                             "training.npz" if training else "test.npz")
        values = np.load(cache, allow_pickle=True)
        if hasattr(values, "files"):  # npz archive vs bare object array
            values = values[values.files[0]]
        return M4Dataset(ids=np.array(col("M4id"), dtype=object),
                         groups=np.array(col("SP"), dtype=object),
                         frequencies=np.array(col("Frequency"), np.int64),
                         horizons=np.array(col("Horizon"), np.int64),
                         values=values)


def build_m4_cache(csv_by_group: dict, out_dir: str) -> None:
    """Converts M4-format CSVs into the layout `M4Dataset.load` reads.

    csv_by_group: {'Yearly': (train_csv_path, test_csv_path), ...}, each
    CSV with the series id in its first column and the ragged values in
    the others. Train and test rows are paired by id."""
    from sie_tpu_torch.data.forecast import read_m4_rows
    info, train_vals, test_vals = [], [], []
    meta = M4Meta()
    for group, (train_csv, test_csv) in csv_by_group.items():
        te_by_id = dict(read_m4_rows(test_csv, np.float64))
        for tid, tr_vals in read_m4_rows(train_csv, np.float64):
            te_vals = te_by_id.get(tid)
            if te_vals is None:
                raise ValueError(f"series {tid!r} present in {train_csv} "
                                 f"but missing/empty in {test_csv}")
            info.append((tid, group, meta.frequency_map[group],
                         meta.horizons_map[group]))
            train_vals.append(tr_vals)
            test_vals.append(te_vals)
    os.makedirs(out_dir, exist_ok=True)
    write_table(os.path.join(out_dir, "M4-info.csv"),
                ("M4id", "SP", "Frequency", "Horizon"), info)

    def ragged(vals):
        arr = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            arr[i] = v
        return arr

    np.savez_compressed(os.path.join(out_dir, "training.npz"),
                        values=ragged(train_vals))
    np.savez_compressed(os.path.join(out_dir, "test.npz"),
                        values=ragged(test_vals))
