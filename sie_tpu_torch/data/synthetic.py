"""Synthetic data generators: a copy of sie_tpu/data/synthetic.py
(CHISCO-shaped EEG trials, UEA-format archives and Monash-format
extrinsic-regression archives), used by the tests and
by the flagship run when no real data is mounted. Signals are
class-conditioned mixtures of band-limited oscillations and pink-ish noise,
so models can learn them.

The task files are written with the `csv` module and numpy, in the
public layouts the loaders read: an ETT-shaped forecasting CSV
(`write_synthetic_ett`), SMD-shaped anomaly arrays with labelled spike
segments (`write_synthetic_smd`) and an M4 group with its npz cache and a
Naive2 submission (`write_synthetic_m4`)."""

from __future__ import annotations

import os
import numpy as np


def synthetic_eeg_trials(n_trials: int = 120, n_channels: int = 122,
                         n_times: int = 1651, n_classes: int = 39,
                         n_subjects: int = 3, fs: float = 500.0,
                         seed: int = 0, imbalanced: bool = False):
    """Returns (raw (N, C, T) float64 volts, text_labels list, subject_idx (N,)).

    Trial amplitude ~ tens of microvolts (so the reference's x1e6 scaling lands
    in a realistic range); class identity is encoded in the phase/frequency mix
    of a few 'source' oscillators projected through a random mixing matrix.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(n_times) / fs
    mix = rng.normal(0, 1, (n_classes, 4, n_channels))
    freqs = rng.uniform(2.0, 40.0, (n_classes, 4))
    raw = np.zeros((n_trials, n_channels, n_times))
    labels = []
    subjects = rng.integers(0, n_subjects, n_trials)
    if imbalanced:
        # Zipf-ish class mix like real word-frequency data (the CHISCO
        # 39-class regime is imbalanced; reference prints the class
        # distribution at test, exp:1080-1092)
        p = 1.0 / np.arange(1, n_classes + 1)
        classes = rng.choice(n_classes, size=n_trials, p=p / p.sum())
    else:
        classes = rng.integers(0, n_classes, n_trials)
    for i in range(n_trials):
        k = classes[i]
        phase = rng.uniform(0, 2 * np.pi, 4)
        src = np.sin(2 * np.pi * freqs[k][:, None] * t[None] + phase[:, None])
        sig = mix[k].T @ src                                  # (C, T)
        noise = rng.normal(0, 1.0, (n_channels, n_times))
        noise = np.cumsum(noise, axis=1) / np.sqrt(np.arange(1, n_times + 1))
        raw[i] = (sig * 3.0 + noise) * 1e-5                   # ~30 uV signals
        labels.append(f"word_{k:02d}")
    return raw, labels, subjects


def synthetic_textmaps(n_classes: int = 39) -> dict:
    return {f"word_{k:02d}": k for k in range(n_classes)}


def write_synthetic_uea(root: str, dataset: str = "SynthMotions",
                        n_train: int = 40, n_test: int = 40, n_dims: int = 6,
                        length: int = 100, n_classes: int = 4, seed: int = 0):
    """Writes a tiny class-separable UEA-format archive to {root}/{dataset}/."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, dataset), exist_ok=True)
    freqs = rng.uniform(0.02, 0.2, (n_classes, n_dims))
    t = np.arange(length)

    def gen(n, fname):
        lines = [f"@problemName {dataset}", "@timeStamps false",
                 "@missing false", f"@univariate {'true' if n_dims == 1 else 'false'}",
                 f"@dimensions {n_dims}", "@equalLength true",
                 f"@seriesLength {length}",
                 "@classLabel true " + " ".join(f"c{k}" for k in range(n_classes)),
                 "@data"]
        for _ in range(n):
            k = rng.integers(0, n_classes)
            dims = []
            for d in range(n_dims):
                sig = np.sin(2 * np.pi * freqs[k, d] * t + rng.uniform(0, 6.28))
                sig = sig + rng.normal(0, 0.3, length)
                dims.append(",".join(f"{v:.6f}" for v in sig))
            lines.append(":".join(dims) + f":c{k}")
        with open(os.path.join(root, dataset, fname), "w") as f:
            f.write("\n".join(lines) + "\n")

    gen(n_train, f"{dataset}_TRAIN.ts")
    gen(n_test, f"{dataset}_TEST.ts")
    return os.path.join(root, dataset)


def write_synthetic_monash(root: str, dataset: str = "SynthRegression",
                           n_train: int = 40, n_test: int = 40, n_dims: int = 3,
                           length: int = 80, seed: int = 0):
    """Tiny Monash-format extrinsic-regression archive: target = mean amplitude."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, dataset), exist_ok=True)
    t = np.arange(length)

    def gen(n, fname):
        lines = [f"@problemName {dataset}", "@timeStamps false",
                 "@missing false", f"@dimensions {n_dims}",
                 "@equalLength true", f"@seriesLength {length}",
                 "@targetlabel true", "@data"]
        for _ in range(n):
            amp = rng.uniform(0.5, 5.0)
            dims = []
            for d in range(n_dims):
                sig = amp * np.sin(2 * np.pi * 0.05 * t + d) + rng.normal(0, 0.2, length)
                dims.append(",".join(f"{v:.6f}" for v in sig))
            lines.append(":".join(dims) + f":{amp:.4f}")
        with open(os.path.join(root, dataset, fname), "w") as f:
            f.write("\n".join(lines) + "\n")

    gen(n_train, f"{dataset}_TRAIN.ts")
    gen(n_test, f"{dataset}_TEST.ts")
    return os.path.join(root, dataset)


ETT_COLUMNS = ("HUFL", "HULL", "MUFL", "MULL", "LUFL", "LULL", "OT")


def write_synthetic_ett(path: str, n_rows: int = 17420,
                        start: str = "2016-07-01T00:00:00",
                        step_minutes: int = 60, seed: int = 0) -> str:
    """An ETT-shaped CSV: `date` (YYYY-MM-DD HH:MM:SS every step_minutes
    from `start`) and the seven ETT columns, daily and weekly cycles with
    a slow drift and noise, 3 decimals as in the published files."""
    from sie_tpu_torch.data.table import write_table
    rng = np.random.default_rng(seed)
    t = np.arange(n_rows) * step_minutes / 60.0                 # hours
    dates = np.datetime64(start, "s") + (np.arange(n_rows) * step_minutes
                                         ).astype("timedelta64[m]")
    cols = []
    for k in range(len(ETT_COLUMNS)):
        amp = rng.uniform(0.5, 3.0, 2)
        phase = rng.uniform(0, 2 * np.pi, 2)
        v = (5.0 + amp[0] * np.sin(2 * np.pi * t / 24 + phase[0])
             + amp[1] * np.sin(2 * np.pi * t / 168 + phase[1])
             + 0.002 * k * t / 24 + rng.normal(0, 0.3, n_rows))
        cols.append(np.round(v, 3))
    stamps = [d.replace("T", " ") for d in
              np.datetime_as_string(dates, unit="s")]
    rows = ([s] + [f"{c[i]:.3f}" for c in cols]
            for i, s in enumerate(stamps))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_table(path, ("date",) + ETT_COLUMNS, rows)
    return path


def write_synthetic_smd(root: str, n_train: int = 28479, n_test: int = 28479,
                        n_channels: int = 38, anomaly_frac: float = 0.04,
                        seed: int = 0) -> float:
    """SMD-shaped arrays {root}/SMD_train.npy, SMD_test.npy and
    SMD_test_label.npy: smooth per-channel signals in [0, 1] with noise;
    in the test rows, spike segments of 20-100 rows on a few channels,
    labelled 1, until about `anomaly_frac` of the rows are. -> the
    labelled fraction."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    period = rng.uniform(50, 1500, n_channels)
    phase = rng.uniform(0, 2 * np.pi, n_channels)

    def signal(n, offset):
        t = np.arange(offset, offset + n)[:, None]
        v = 0.5 + 0.3 * np.sin(2 * np.pi * t / period + phase)
        return (v + rng.normal(0, 0.03, (n, n_channels))).astype(np.float32)

    train = signal(n_train, 0)
    test = signal(n_test, n_train)
    labels = np.zeros(n_test, np.float32)
    while labels.mean() < anomaly_frac:
        lo = int(rng.integers(0, n_test - 100))
        hi = lo + int(rng.integers(20, 101))
        chans = rng.choice(n_channels, size=int(rng.integers(2, 8)),
                           replace=False)
        test[lo:hi, chans] += rng.uniform(0.5, 1.5, len(chans))
        labels[lo:hi] = 1.0
    np.save(os.path.join(root, "SMD_train.npy"), train)
    np.save(os.path.join(root, "SMD_test.npy"), test)
    np.save(os.path.join(root, "SMD_test_label.npy"), labels)
    return float(labels.mean())


def write_synthetic_m4(root: str, group: str = "Monthly",
                       n_series: int = 2000, min_len: int = 60,
                       max_len: int = 300, seed: int = 0) -> str:
    """An M4 group in the public layout: {group}-train.csv and
    {group}-test.csv (id, then the ragged values), the npz cache that
    `load_m4` and `M4Summary` read (data.m4.build_m4_cache), and
    submission-Naive2.csv (the last training value repeated). Series of
    min_len..max_len points: a positive level, trend, a seasonal cycle of
    the group's frequency and noise; test horizons of the group's length."""
    from sie_tpu_torch.data.m4 import M4Meta, build_m4_cache
    from sie_tpu_torch.data.table import write_table
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    h = M4Meta.horizons_map[group]
    freq = M4Meta.frequency_map[group]
    prefix = group[0]
    train_rows, test_rows, naive_rows = [], [], []
    for i in range(n_series):
        n = int(rng.integers(min_len, max_len + 1))
        t = np.arange(n + h)
        v = (rng.uniform(500, 5000) * (1 + rng.uniform(-1e-3, 3e-3) * t)
             * (1 + rng.uniform(0, 0.2) * np.sin(2 * np.pi * t / max(freq, 2)
                                                 + rng.uniform(0, 6.28)))
             * (1 + rng.normal(0, 0.02, n + h)))
        sid = f"{prefix}{i + 1}"
        train_rows.append([sid] + [f"{x:.2f}" for x in v[:n]])
        test_rows.append([sid] + [f"{x:.2f}" for x in v[n:]])
        naive_rows.append([sid] + [f"{v[n - 1]:.2f}"] * h)
    paths = []
    for name, rows in (("train", train_rows), ("test", test_rows)):
        width = max(len(r) for r in rows) - 1
        path = os.path.join(root, f"{group}-{name}.csv")
        write_table(path, ["V1"] + [f"V{j + 2}" for j in range(width)],
                    (r + [""] * (width + 1 - len(r)) for r in rows))
        paths.append(path)
    build_m4_cache({group: tuple(paths)}, root)
    write_table(os.path.join(root, "submission-Naive2.csv"),
                ["id"] + [f"V{j + 1}" for j in range(h)], naive_rows)
    return root
