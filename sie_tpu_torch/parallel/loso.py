"""Leave-one-subject-out (LOSO) fold driver (counterpart of
sie_tpu/parallel/loso.py).

The reference collects per-trial subject ids but never splits by them
(README.md:69 states LOSO as the intended protocol). Here each fold holds
one subject out as the test set, and the folds run one after another on one
device, each an `Experiment` with its checkpoints under
`<checkpoint_dir>/loso-<subject>`. `fold_slice` takes a subset of the
folds. Spreading the folds over hosts (the JAX package's
`run_loso_multihost`) is not ported yet: `multihost_requested` tells the
command line when the environment asks for it, and it raises naming
ROADMAP.md.
"""

from __future__ import annotations

import os
from typing import List, Optional

from sie_tpu_torch.config import Config
from sie_tpu_torch.device import DeviceLike


def multihost_requested() -> bool:
    """True when the environment asks for several processes, as the JAX
    package's `init_distributed` reads it (SIE_TPU_COORDINATOR and
    SIE_TPU_NUM_PROCESSES > 1)."""
    return bool(os.environ.get("SIE_TPU_COORDINATOR")) and int(
        os.environ.get("SIE_TPU_NUM_PROCESSES", "1") or 1) > 1


def run_loso(cfg: Config, n_subjects: Optional[int] = None,
             synthetic: Optional[bool] = None, verbose: bool = True,
             fold_slice: slice = slice(None),
             device: DeviceLike = None) -> List[dict]:
    """Train and test one experiment per held-out subject; returns the
    per-fold test metrics, each with its `held_out_subject`."""
    from sie_tpu_torch.data.eeg import load_eeg_dataset
    from sie_tpu_torch.train.experiment import Experiment

    if n_subjects is None:
        probe = load_eeg_dataset(cfg, "train", three_class=(cfg.data == "EEG3"),
                                 synthetic=synthetic)
        n_subjects = (int(probe.subject_ids.max()) + 1
                      if probe.subject_ids is not None else 1)

    results = []
    for subject in range(n_subjects)[fold_slice]:
        fold_cfg = cfg.replace(
            checkpoint_dir=f"{cfg.checkpoint_dir}/loso-{subject}")
        exp = Experiment(fold_cfg, loso_test_subject=subject,
                         verbose=verbose, device=device)
        exp.train()
        _loss, metrics, _ = exp.test(save_csv=False)
        metrics = dict(metrics)
        metrics["held_out_subject"] = subject
        results.append(metrics)
        if verbose:
            print(f"[LOSO] subject {subject}: acc {metrics['accuracy']:.2f}%")
    return results
