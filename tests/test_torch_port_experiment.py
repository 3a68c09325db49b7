"""The port's experiment and command line against the JAX package's, on
the CPU.

A tiny InterpGN + Transformer (2 shapelets, d_model 16, one layer, dropout
0, f32) on synthetic EEG3 at 8 channels x 200 samples: the port's
`Experiment` (device "cpu") starts from the JAX `Experiment`'s initial
parameters, and the two train 2 epochs through their staged steps. Per
epoch the train and validation losses agree within 1e-4 (f32 sums in
another order, carried through 8 Adam steps), with the same validation
accuracy and early-stopping decisions. Checkpoints cross both ways: each
package's best checkpoint, loaded by the other, gives the writer's test
logits within 1e-5 (one f32 forward). `python -m sie_tpu_torch.run
--device cpu` trains, writes the CSV and the pickle, and a re-run skips
training with the same accuracy; its parser takes run.py's options plus
`--device`, and the flags of unported paths raise naming ROADMAP.md."""

import argparse
import glob
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import run as jax_run
from sie_tpu.config import Config as JConfig
from sie_tpu.train.experiment import Experiment as JExperiment
from sie_tpu_torch import run as port_run
from sie_tpu_torch.compat.from_jax import load_jax_params
from sie_tpu_torch.config import Config
from sie_tpu_torch.data.synthetic import write_synthetic_uea
from sie_tpu_torch.train.experiment import Experiment

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(data="EEG3", max_files=4, target_channels=8, target_timepoints=200,
          model="InterpGN", dnn_type="Transformer", num_shapelet=2,
          d_model=16, d_ff=32, n_heads=2, e_layers=1, dropout=0.0, amp=False,
          use_pallas=False, batch_size=8, lr=5e-3, train_epochs=2,
          patience=5, log_interval=1, seed=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both experiments trained from the same initial parameters: (JAX
    experiment, port experiment, JAX epoch records, port epoch records,
    the config's keyword arguments without checkpoint_dir)."""
    tmp = tmp_path_factory.mktemp("exp")
    kw = dict(KW, data_root=str(tmp / "no_chisco"),
              cache_dir=str(tmp / "cache"), result_dir=str(tmp / "result"))
    jrec, prec = [], []
    jexp = JExperiment(JConfig(**kw, checkpoint_dir=str(tmp / "jck")),
                       verbose=False, metrics_hook=jrec.append)
    jexp._init_state()
    pexp = Experiment(Config(**kw, checkpoint_dir=str(tmp / "pck")),
                      verbose=False, metrics_hook=prec.append, device="cpu")
    load_jax_params(pexp.trainer.model,
                    jax.tree.map(np.asarray, jexp.state.params))
    jexp.train()
    pexp.train()
    return jexp, pexp, jrec, prec, kw, tmp


def test_epochs_match_the_jax_experiment(runs):
    jexp, pexp, jrec, prec, _kw, _tmp = runs
    assert len(jrec) == len(prec) == KW["train_epochs"]
    for j, p in zip(jrec, prec):
        assert p["train_loss"] == pytest.approx(j["train_loss"], abs=1e-4)
        assert p["val_loss"] == pytest.approx(j["val_loss"], abs=1e-4)
        assert p["val_accuracy"] == j["val_accuracy"]
        assert p["beta"] == j["beta"]
    assert pexp.epoch_stop == jexp.epoch_stop
    assert len(pexp.train_data) == len(jexp.train_data) == 28
    assert np.array_equal(pexp.test_data.y, jexp.test_data.y)


def _test_logits(exp):
    _loss, metrics, result = exp.test(save_csv=False)
    return metrics, np.asarray(result.preds)


def test_checkpoints_cross_both_ways(runs):
    jexp, pexp, _jrec, _prec, kw, tmp = runs
    jm, jlogits = _test_logits(jexp)
    pm, plogits = _test_logits(pexp)
    assert np.abs(plogits - jlogits).max() <= 1e-4
    # the JAX package's best checkpoint in a fresh port experiment
    p2 = Experiment(Config(**kw, checkpoint_dir=str(tmp / "jck")),
                    verbose=False, device="cpu")
    assert p2.has_checkpoint() and p2.load_checkpoint()
    assert p2.epoch_stop == jexp.epoch_stop
    assert np.abs(_test_logits(p2)[1] - jlogits).max() <= 1e-5
    # the port's best checkpoint in a fresh JAX experiment
    j2 = JExperiment(JConfig(**kw, checkpoint_dir=str(tmp / "pck")),
                     verbose=False)
    assert j2.has_checkpoint() and j2.load_checkpoint()
    assert np.abs(_test_logits(j2)[1] - plogits).max() <= 1e-5


def _accuracy(text):
    return re.search(r"Test accuracy (\S+)%", text).group(1)


def test_cli_trains_checkpoints_and_skips_on_a_rerun(tmp_path, capsys):
    write_synthetic_uea(str(tmp_path), "Toy", n_train=24, n_test=12,
                        n_dims=3, length=30, n_classes=2, seed=9)
    argv = ["--device", "cpu", "--data", "UEA", "--data_root", str(tmp_path),
            "--dataset", "Toy", "--model", "InterpGN", "--dnn_type",
            "Transformer", "--num_shapelet", "2", "--d_model", "16",
            "--d_ff", "32", "--n_heads", "2", "--e_layers", "1",
            "--batch_size", "8", "--train_epochs", "3", "--patience", "3",
            "--log_interval", "1", "--seed", "0",
            "--checkpoint_dir", str(tmp_path / "ck"),
            "--result_dir", str(tmp_path / "result"),
            "--cache_dir", str(tmp_path / "cache")]
    first = subprocess.run([sys.executable, "-m", "sie_tpu_torch.run", *argv],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
    assert first.returncode == 0, first.stderr
    assert len(re.findall(r"Epoch \d/3 \| Train Loss", first.stdout)) == 3
    assert "checkpoint exists" not in first.stdout
    csvs = glob.glob(str(tmp_path / "result" / "InterpGN" / "Toy-0-*.csv"))
    pkls = glob.glob(str(tmp_path / "ck" / "**" / "test_results.pkl"),
                     recursive=True)
    ckpts = glob.glob(str(tmp_path / "ck" / "**" / "checkpoint.msgpack"),
                      recursive=True)
    assert len(csvs) == len(pkls) == len(ckpts) == 1
    with open(csvs[0]) as f:
        header, row = f.read().splitlines()
    assert "test_accuracy" in header.split(",") and len(row.split(",")) == \
        len(header.split(","))
    results = port_run.main(argv)
    again = capsys.readouterr().out
    assert "checkpoint exists — skipping training" in again
    assert "Epoch" not in again
    assert _accuracy(again) == _accuracy(first.stdout)
    assert f"{results[0][2]['accuracy']:.2f}" == _accuracy(first.stdout)


def _options(get_args):
    """(option strings, parsed defaults) of a get_args function."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen["parser"] = self
        return real(self, args, namespace)

    argparse.ArgumentParser.parse_args = grab
    try:
        defaults = vars(get_args([]))
    finally:
        argparse.ArgumentParser.parse_args = real
    return ({s for a in seen["parser"]._actions for s in a.option_strings},
            defaults)


def test_parser_takes_run_py_options_plus_device():
    jopts, jdefaults = _options(jax_run.get_args)
    popts, pdefaults = _options(port_run.get_args)
    assert popts == jopts | {"--device"}
    assert pdefaults.pop("device") == "cuda"
    assert pdefaults == jdefaults


UNPORTED = [["--loso"], ["--mesh", "8"], ["--task_name", "regression"],
            ["--task_name", "long_term_forecast"], ["--augment", "noise"],
            ["--stream_from_disk"], ["--task_name", "short_term_forecast"],
            ["--task_name", "imputation"],
            ["--task_name", "anomaly_detection"],
            ["--export_torch_ckpt", "t.pth"], ["--import_torch_ckpt", "t.pth"],
            ["--profile_dir", "p"], ["--debug_nans"], ["--data", "Monash"]]


@pytest.mark.parametrize("flags", UNPORTED, ids=lambda f: f[0].strip("-"))
def test_unported_flags_raise(flags, tmp_path):
    argv = ["--device", "cpu", "--seed", "0", "--checkpoint_dir",
            str(tmp_path), "--cache_dir", str(tmp_path)] + flags
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_run.main(argv)


def test_default_device_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment(Config(**KW, data_root=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_run.main(["--seed", "0", "--data_root", str(tmp_path),
                       "--cache_dir", str(tmp_path)])
