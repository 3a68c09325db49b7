"""CHISCO imagined-speech EEG dataset (39-class 'EEG' and 3-class 'EEG3'):
a copy of sie_tpu/data/eeg.py on the port's preprocessing.

- host side: .fif reading (MNE when installed, else the port's own FIFF
  reader), a processed .npz cache, or the synthetic generator when
  `data_root` does not exist;
- preprocessing: `data.preprocess.preprocess_trials_host` in torch on the
  CPU, in batches of trials;
- labels: textmaps.json text -> 39 classes, then the fixed 39 -> 3 bucket
  map for EEG3; unmapped trials dropped;
- splits: one permutation (seed 42) shared by the three flags, processed
  once per config and cached in memory and on disk. Leave-one-subject-out
  splits are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sie_tpu_torch.config import Config
from sie_tpu_torch.data.loader import ArrayDataset
from sie_tpu_torch.data.preprocess import (preprocess_trials_host,
                                            validate_trials)

# reference eeg_processor.py:455-461 — 39-class id -> 3-category bucket
THREE_CATEGORY_MAP = {
    0: 0, 13: 0, 14: 0, 18: 0, 22: 0, 23: 0, 26: 0, 35: 0, 37: 0,       # daily life
    1: 1, 2: 1, 6: 1, 7: 1, 9: 1, 12: 1, 15: 1, 17: 1, 24: 1, 29: 1,
    34: 1, 36: 1, 38: 1,                                                 # social/emotion
    3: 2, 4: 2, 5: 2, 8: 2, 10: 2, 11: 2, 16: 2, 19: 2, 20: 2, 21: 2,
    25: 2, 27: 2, 28: 2, 30: 2, 31: 2, 32: 2, 33: 2,                     # professional
}


def load_text_maps(json_path: str) -> dict:
    with open(json_path, "r", encoding="utf-8") as f:
        return json.load(f)


# --------------------------------------------------------------------------
# raw trial acquisition (host side)
# --------------------------------------------------------------------------

def find_imagine_fif_files(data_dir: str, task_type: str = "imagine") -> List[str]:
    """Recursive *{task}*.fif[.gz] discovery (reference eeg_processor.py:35-42)."""
    out = []
    for root, _dirs, files in os.walk(data_dir):
        for f in sorted(files):
            if f.endswith((".fif", ".fif.gz")) and task_type in f.lower():
                out.append(os.path.join(root, f))
    return sorted(out)


def find_all_subjects(data_dir: str) -> List[str]:
    """Auto-discover sub-* directories (reference eeg_processor.py:1286-1298)."""
    if not os.path.isdir(data_dir):
        return []
    return sorted(d for d in os.listdir(data_dir)
                  if d.startswith("sub-") and os.path.isdir(os.path.join(data_dir, d)))


def resolve_subjects(cfg: Config) -> List[str]:
    """Subject resolution order (reference run.py:285-295 +
    eeg_processor.py:1006-1027): explicit `subject_ids` list (comma-splitting
    single-string entries) > singular `subject_id` fallback > auto-discovered
    sub-* directories capped at `max_subjects` (reference run.py:31)."""
    ids: List[str] = []
    for entry in cfg.subject_ids:
        ids.extend(s.strip() for s in str(entry).split(",") if s.strip())
    if ids:
        return ids
    if cfg.subject_id:
        return [cfg.subject_id]
    found = find_all_subjects(cfg.data_root)
    if cfg.max_subjects and cfg.max_subjects > 0:
        found = found[: cfg.max_subjects]
    return found


def _read_epochs_any(path: str):
    """One epochs file -> (data (n_ep, C, T) volts with EEG picks applied,
    per-epoch word labels). Prefers MNE when installed (the reference's
    `mne.read_epochs` path, eeg_processor.py:1100); otherwise the port's
    own FIFF reader (`data.fif`)."""
    try:
        import mne
    except ImportError:
        mne = None
    if mne is not None:
        epochs = mne.read_epochs(path, preload=True, verbose="ERROR")
        words = ["unknown"] * len(epochs)
        md = getattr(epochs, "metadata", None)
        if md is not None and "Word" in md.columns:
            words = [str(w).strip() if w == w else "unknown"
                     for w in md["Word"].tolist()]
        picks = mne.pick_types(epochs.info, eeg=True)
        return epochs.get_data()[:, picks, :], words
    from sie_tpu_torch.data.fif import read_epochs_fif
    epochs = read_epochs_fif(path)
    words = ["unknown"] * len(epochs)
    if epochs.metadata is not None:
        def norm(w):
            # JSON null / NaN -> "unknown", matching the MNE branch's
            # NaN handling (w == w check) rather than the strings "None"/"nan"
            if w is None or (isinstance(w, float) and w != w):
                return "unknown"
            return str(w).strip() or "unknown"
        words = [norm(rec.get("Word")) for rec in epochs.metadata]
    return epochs.get_data()[:, epochs.pick_eeg(), :], words


def read_fif_trials(data_dir: str, subject_ids: Sequence[str],
                    max_files: int, task_type: str = "imagine"):
    """CHISCO epochs reading (reference eeg_processor.py:1084-1160): per
    subject, *imagine*.fif[.gz] files capped at max_files, EEG picks, per-
    epoch 'Word' labels from the metadata.

    Returns (raw list of (C, T) float64 volts, text labels, subject index
    array). Uses MNE when present, else the built-in FIFF reader.
    """
    raws, labels, subjects = [], [], []
    for si, sub in enumerate(subject_ids):
        sub_dir = os.path.join(data_dir, sub)
        files = find_imagine_fif_files(
            sub_dir if os.path.isdir(sub_dir) else data_dir, task_type)
        for path in files[:max_files]:
            data, words = _read_epochs_any(path)
            for ti in range(data.shape[0]):
                raws.append(data[ti])
                labels.append(words[ti] if ti < len(words) else "unknown")
                subjects.append(si)
    return raws, labels, np.asarray(subjects, np.int32)


# --------------------------------------------------------------------------
# processing + dataset assembly
# --------------------------------------------------------------------------

def process_trials(raw: np.ndarray, text_labels: Sequence[str],
                   subjects: np.ndarray, text_maps: dict,
                   three_class: bool, cfg: Config,
                   batch: int = 256) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Raw volts (N, C_raw, T_raw) -> processed (N, 122, target_T) f32 +
    labels + subjects, with label mapping and QA filtering."""
    target_t = int(cfg.target_timepoints * cfg.target_fs / cfg.original_fs)
    # map text -> 39-class ids (reference eeg_processor.py:438-453)
    y = np.array([text_maps.get(t, -1) for t in text_labels], np.int32)
    if three_class:
        y = np.array([THREE_CATEGORY_MAP.get(int(v), -1) for v in y], np.int32)
    keep = y >= 0
    raw, y, subjects = raw[keep], y[keep], subjects[keep]

    # batched preprocessing on the CPU (see preprocess_trials_host for why
    # the raw trials stay off the card).
    # normalize=False: QA must see the scaled microvolt data, as in the
    # reference (validate_eeg_data runs before EEGDataset's per-sample
    # z-score, eeg_processor.py:402-426 + eeg.py:352-367) — on z-scored data
    # the 1e5 outlier bounds could never trigger.
    out = []
    for i in range(0, len(raw), batch):
        out.append(np.asarray(preprocess_trials_host(
            raw[i:i + batch], cfg.target_channels, target_t,
            normalize=False)))
    x = np.concatenate(out, axis=0) if out else np.zeros(
        (0, cfg.target_channels, target_t), np.float32)

    ok = validate_trials(x)
    x, y, subjects = x[ok], y[ok], subjects[ok]

    # per-channel ddof-1 z-score of the survivors (same math as the
    # pipeline's normalize step); constant (e.g. zero-padded) channels map to
    # zero instead of NaN — documented deviation from the reference's
    # eps-free pandas division, which NaNs there.
    tt = x.shape[-1]
    mean = x.mean(axis=-1, keepdims=True)
    sd = np.sqrt(x.var(axis=-1, keepdims=True) * (tt / max(tt - 1, 1)))
    x = np.where(sd > 0, (x - mean) / np.where(sd > 0, sd, 1.0), 0.0)
    return x.astype(np.float32), y, subjects


def split_indices(n: int, test_size: float, val_size: float,
                  seed: int = 42) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random split with the reference's min-1 guarantees (eeg.py:412-471)."""
    n_val = int(n * val_size)
    n_test = int(n * test_size)
    n_train = n - n_val - n_test
    if n_train < 1:
        n_train = 1
        n_val = min(n - 1, n_val)
        n_test = n - n_train - n_val
    elif n_val < 1 and n > 1:
        n_val = 1
        n_test = min(n - n_train - 1, n_test)
        n_train = n - n_val - n_test
    perm = np.random.default_rng(seed).permutation(n)
    return (perm[:n_train], perm[n_train:n_train + n_val],
            perm[n_train + n_val:])


_PROCESS_CACHE: dict = {}


def load_eeg_dataset(cfg: Config, flag: str, three_class: bool = True,
                     synthetic: Optional[bool] = None) -> ArrayDataset:
    """Build the EEG ArrayDataset for a flag. Processing runs once per config
    (in-memory + on-disk cache); the three flags share one processed tensor."""
    key = (cfg.data_root, cfg.json_path, three_class, cfg.max_files,
           tuple(cfg.subject_ids), cfg.subject_id, cfg.max_subjects,
           cfg.target_channels, cfg.target_timepoints,
           cfg.original_fs, cfg.target_fs,
           cfg.task_type, cfg.synthetic_trials,
           synthetic)  # None (auto) vs False (require real)
    if key not in _PROCESS_CACHE:
        _PROCESS_CACHE[key] = _load_processed(cfg, three_class, synthetic)
    x, y, subjects = _PROCESS_CACHE[key]

    tr, va, te = split_indices(len(x), cfg.test_size, cfg.val_size)
    idx = {"train": tr, "val": va, "test": te}[flag.lower()]

    num_class = 3 if three_class else 39
    xs = np.transpose(x[idx], (0, 2, 1))  # (n, T, C) — framework layout
    return ArrayDataset(
        x=xs, y=y[idx], padding_mask=np.ones(xs.shape[:2], np.float32),
        max_seq_len=xs.shape[1], enc_in=xs.shape[2], num_class=num_class,
        class_names=tuple(str(i) for i in range(num_class)),
        subject_ids=subjects[idx], original_fs=cfg.original_fs,
        target_fs=cfg.target_fs)


def _load_processed(cfg: Config, three_class: bool, synthetic: Optional[bool]):
    os.makedirs(cfg.cache_dir, exist_ok=True)
    tag = hashlib.md5(repr((cfg.data_root, cfg.subject_ids, cfg.subject_id,
                            cfg.max_subjects, cfg.max_files,
                            three_class, cfg.target_channels,
                            cfg.target_timepoints,
                            cfg.original_fs, cfg.target_fs, cfg.json_path,
                            synthetic, cfg.synthetic_trials,
                            cfg.task_type)).encode()).hexdigest()[:12]
    cache = os.path.join(cfg.cache_dir, f"eeg_processed_{tag}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return z["x"], z["y"], z["subjects"]

    use_synth = synthetic
    if use_synth is None:
        use_synth = not os.path.isdir(cfg.data_root)
    if use_synth:
        from sie_tpu_torch.data.synthetic import (synthetic_eeg_trials,
                                                  synthetic_textmaps)
        if cfg.synthetic_trials > 0:
            # CHISCO-scale cert mode: exact trial count, imbalanced classes,
            # LOSO-ready subject count (--synthetic_trials)
            raw, labels, subjects = synthetic_eeg_trials(
                n_trials=cfg.synthetic_trials,
                n_channels=cfg.target_channels,
                n_times=cfg.target_timepoints,
                n_subjects=max(cfg.max_subjects, 2), imbalanced=True)
        else:
            raw, labels, subjects = synthetic_eeg_trials(
                n_trials=min(cfg.max_files * 10, 240),
                n_channels=cfg.target_channels,
                n_times=cfg.target_timepoints)
        text_maps = synthetic_textmaps()
    else:
        subject_ids = resolve_subjects(cfg)
        raws, labels, subjects = read_fif_trials(
            cfg.data_root, subject_ids, cfg.max_files, cfg.task_type)
        if not raws:
            raise FileNotFoundError(
                f"no {cfg.task_type!r} .fif trials found under "
                f"{cfg.data_root!r} for subjects {list(subject_ids)}")
        # trials may differ in montage/length across subjects: stack into the
        # max box (channel crop/pad to target_channels happens downstream)
        t_max = max(r.shape[1] for r in raws)
        c_max = max(r.shape[0] for r in raws)
        raw = np.zeros((len(raws), c_max, t_max))
        for i, r in enumerate(raws):
            raw[i, : r.shape[0], : r.shape[1]] = r
        text_maps = load_text_maps(cfg.json_path)

    x, y, subjects = process_trials(np.asarray(raw), labels, subjects,
                                    text_maps, three_class, cfg)
    np.savez_compressed(cache, x=x, y=y, subjects=subjects)
    return x, y, subjects
