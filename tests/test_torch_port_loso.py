"""Leave-one-subject-out in the port against the JAX package, on the CPU:
`loso_split` gives the JAX split's indices exactly; `load_eeg_dataset(...,
loso_test_subject=k)` holds exactly subject k in its test split and none
of it in train or validation; `run_loso` on a 2-subject synthetic set runs
two folds, each holding out its subject, with checkpoints under
`loso-<subject>`; `python -m sie_tpu_torch.run --loso --device cpu` prints
the folds' mean, and asking for several processes raises naming
ROADMAP.md."""

import os

import numpy as np
import pytest

from sie_tpu.config import Config as JConfig
from sie_tpu.data.eeg import load_eeg_dataset as jax_load
from sie_tpu.data.eeg import loso_split as jax_loso_split
from sie_tpu_torch import run as port_run
from sie_tpu_torch.config import Config
from sie_tpu_torch.data.eeg import load_eeg_dataset, loso_split
from sie_tpu_torch.parallel.loso import run_loso

DATA = dict(data="EEG3", max_files=4, target_channels=8,
            target_timepoints=200, synthetic_trials=48, max_subjects=2)
MODEL = dict(model="InterpGN", dnn_type="Transformer", num_shapelet=2,
             d_model=16, d_ff=32, n_heads=2, e_layers=1, dropout=0.0,
             amp=False, use_pallas=False, batch_size=8, train_epochs=1,
             log_interval=1, seed=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loso_split_equals_jax(seed):
    rng = np.random.default_rng(seed)
    subjects = rng.integers(0, 4, 57)
    for k in range(5):   # subject 4 has no trials
        for got, want in zip(loso_split(subjects, k),
                             jax_loso_split(subjects, k)):
            np.testing.assert_array_equal(got, want)
    one = np.zeros(3, np.int64)
    for got, want in zip(loso_split(one, 0), jax_loso_split(one, 0)):
        np.testing.assert_array_equal(got, want)


def test_load_holds_exactly_one_subject_in_test(tmp_path):
    kw = dict(DATA, data_root=str(tmp_path / "none"),
              cache_dir=str(tmp_path / "cache"))
    cfg, jcfg = Config(**kw), JConfig(**kw)
    for k in (0, 1):
        splits = {f: load_eeg_dataset(cfg, f, loso_test_subject=k)
                  for f in ("train", "val", "test")}
        assert set(splits["test"].subject_ids.tolist()) == {k}
        assert k not in set(splits["train"].subject_ids.tolist()) | set(
            splits["val"].subject_ids.tolist())
        assert sum(len(s) for s in splits.values()) == 48
        want = jax_load(jcfg, "test", loso_test_subject=k)
        np.testing.assert_array_equal(splits["test"].y, want.y)
        np.testing.assert_allclose(splits["test"].x, want.x, atol=1e-5)


def test_run_loso_runs_one_fold_per_subject(tmp_path):
    cfg = Config(**DATA, **MODEL, data_root=str(tmp_path / "none"),
                 cache_dir=str(tmp_path / "cache"),
                 checkpoint_dir=str(tmp_path / "ck"),
                 result_dir=str(tmp_path / "result"))
    folds = run_loso(cfg, verbose=False, device="cpu")
    assert [f["held_out_subject"] for f in folds] == [0, 1]
    subjects = load_eeg_dataset(cfg, "train").subject_ids.tolist() + \
        load_eeg_dataset(cfg, "val").subject_ids.tolist() + \
        load_eeg_dataset(cfg, "test").subject_ids.tolist()
    for f in folds:
        assert f["num_samples"] == subjects.count(f["held_out_subject"])
        assert 0 <= f["accuracy"] <= 100
        sub = tmp_path / "ck" / f"loso-{f['held_out_subject']}"
        found = [p for p, _, names in os.walk(sub)
                 if "checkpoint.msgpack" in names]
        assert len(found) == 1


def test_cli_loso_prints_the_fold_mean(tmp_path, capsys, monkeypatch):
    argv = ["--device", "cpu", "--loso", "--data", "EEG3", "--data_root",
            str(tmp_path / "none"), "--max_files", "4", "--target_channels",
            "8", "--target_timepoints", "200", "--synthetic_trials", "48",
            "--max_subjects", "2", "--model", "InterpGN", "--num_shapelet",
            "2", "--d_model", "16", "--d_ff", "32", "--n_heads", "2",
            "--e_layers", "1", "--batch_size", "8", "--train_epochs", "1",
            "--log_interval", "1", "--seed", "0",
            "--checkpoint_dir", str(tmp_path / "ck"),
            "--result_dir", str(tmp_path / "result"),
            "--cache_dir", str(tmp_path / "cache")]
    [(seed, loss, metrics)] = port_run.main(argv)
    out = capsys.readouterr().out
    folds = metrics["per_fold"]
    mean = np.mean([f["accuracy"] for f in folds])
    assert (seed, loss, len(folds)) == (0, None, 2)
    assert metrics["accuracy"] == pytest.approx(mean)
    assert f"LOSO (2 folds): accuracy {mean:.2f}" in out
    assert "(random baseline 33.33)" in out
    monkeypatch.setenv("SIE_TPU_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("SIE_TPU_NUM_PROCESSES", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_run.main(argv)
