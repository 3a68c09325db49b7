"""UEA multivariate classification archive loader: a copy of
sie_tpu/data/uea.py on the port's parser and loader.

- flag 'train' reads `{dataset}_TRAIN.ts`; 'val' and 'test' both read
  `{dataset}_TEST.ts`;
- labels -> class codes via the sorted declared (else present) labels;
- whole-file normalization per dimension (`normalize_array`);
- EthanolConcentration keeps the reference's instance-norm quirk (mean
  over time, variance over channels).
"""

from __future__ import annotations

import os

import numpy as np

from sie_tpu_torch.data.loader import ArrayDataset, lengths_to_mask, normalize_array
from sie_tpu_torch.data.ts_parser import parse_ts_file, to_dense


def _find_ts(root_path: str, dataset: str, split: str) -> str:
    cands = [
        os.path.join(root_path, dataset, f"{dataset}_{split}.ts"),
        os.path.join(root_path, f"{dataset}_{split}.ts"),
    ]
    for c in cands:
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(
        f"no {split} .ts file for dataset {dataset!r} under {root_path!r} "
        f"(tried {cands})")


def ethanol_instance_norm(x: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Reference data_loader.py:704-712 quirk: subtract the per-channel mean
    over time, divide by the per-timestep std over channels (unbiased=False)."""
    out = x.copy()
    for i in range(len(x)):
        case = x[i, : lengths[i]]
        mean = case.mean(axis=0, keepdims=True)
        cen = case - mean
        std = np.sqrt(cen.var(axis=1, keepdims=True) + 1e-5)
        out[i, : lengths[i]] = cen / std
    return out


def load_uea_dataset(root_path: str, dataset: str, flag: str,
                     norm_type: str = "standardization") -> ArrayDataset:
    split = "TRAIN" if flag.lower() == "train" else "TEST"
    ts = parse_ts_file(_find_ts(root_path, dataset, split))
    x, lengths, max_len = to_dense(ts)

    # label ids from the @classLabel declaration (sorted, so the mapping
    # equals the reference's pd.Categorical codes whenever every class is
    # present) — deriving them from the labels PRESENT in each file, as the
    # reference does, silently permutes test ids when a class is missing
    # from one split
    declared = getattr(ts, "class_labels", None)
    classes = (tuple(sorted(declared)) if declared
               else tuple(sorted(set(ts.labels))))
    cls_index = {c: i for i, c in enumerate(classes)}
    y = np.array([cls_index[l] for l in ts.labels], np.int32)

    x = normalize_array(x, lengths, norm_type)
    if "EthanolConcentration" in dataset:
        x = ethanol_instance_norm(x, lengths)

    return ArrayDataset(
        x=x, y=y, padding_mask=lengths_to_mask(lengths, x.shape[1]),
        max_seq_len=max_len, enc_in=x.shape[2], num_class=len(classes),
        class_names=classes)
