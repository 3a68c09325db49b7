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
training with the same accuracy (with TimesNet and PatchTST too, whose
checkpoints also go out and back in as reference `checkpoint.pth`); its
parser takes run.py's options plus `--device`, and the flags of unported
paths raise naming ROADMAP.md
(`--loso`, `--augment`, regression on Monash and the reference checkpoints
have tests of their own: test_torch_port_loso.py, _augment.py,
_regression.py and _torch_ckpt.py)."""

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


@pytest.mark.parametrize("dnn", ["TimesNet", "PatchTST"])
def test_cli_trains_timesnet_and_patchtst_and_moves_checkpoints(
        dnn, tmp_path, capsys):
    """InterpGN with either backbone through `python -m sie_tpu_torch.run
    --device cpu` (in process): trains, checkpoints, re-runs without
    training at the same accuracy, and `--export_torch_ckpt` then
    `--import_torch_ckpt` gives the same accuracy and test loss."""
    write_synthetic_uea(str(tmp_path), "Toy", n_train=24, n_test=12,
                        n_dims=3, length=30, n_classes=2, seed=9)
    argv = ["--device", "cpu", "--data", "UEA", "--data_root", str(tmp_path),
            "--dataset", "Toy", "--model", "InterpGN", "--dnn_type", dnn,
            "--num_shapelet", "2", "--d_model", "8", "--d_ff", "16",
            "--n_heads", "2", "--e_layers", "1", "--top_k", "2",
            "--num_kernels", "2", "--patch_chunk_rows", "40",
            "--batch_size", "8", "--train_epochs", "2", "--log_interval",
            "1", "--seed", "0", "--result_dir", str(tmp_path / "result"),
            "--cache_dir", str(tmp_path / "cache")]
    pth = str(tmp_path / "ck.pth")
    first = port_run.main(argv + ["--checkpoint_dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert len(re.findall(r"Epoch \d/2 \| Train Loss", out)) == 2
    again = port_run.main(argv + ["--checkpoint_dir", str(tmp_path / "a"),
                                  "--export_torch_ckpt", pth])
    out = capsys.readouterr().out
    assert "checkpoint exists — skipping training" in out
    assert again[0][2]["accuracy"] == first[0][2]["accuracy"]
    imported = port_run.main(argv + ["--checkpoint_dir", str(tmp_path / "b"),
                                     "--import_torch_ckpt", pth])
    assert "Epoch" not in capsys.readouterr().out
    assert imported[0][2]["accuracy"] == first[0][2]["accuracy"]
    assert imported[0][1] == pytest.approx(first[0][1], abs=1e-6)


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


# every mesh axis is ported (tests/test_torch_port_mesh*.py): a mesh of
# 'pipe' is refused only as the JAX CLI's make_mesh refuses any mesh, on
# too few cards, before a worker starts
UNPORTED = [["--mesh", "8", "--mesh_axes", "pipe", "--device", "cuda"]]


@pytest.mark.parametrize("flags", UNPORTED, ids=lambda f: f[0].strip("-"))
def test_unported_flags_raise(flags, tmp_path, monkeypatch):
    monkeypatch.delenv("SIE_TPU_COORDINATOR", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = ["--device", "cpu", "--seed", "0", "--checkpoint_dir",
            str(tmp_path), "--cache_dir", str(tmp_path)] + flags
    with pytest.raises(ValueError, match="needs 8 devices"):
        port_run.main(argv)


# the flags refused until the tasks and --stream_from_disk were ported,
# each now a run at a small width on a small synthetic set
_SMALL = ["--d_model", "16", "--d_ff", "32", "--n_heads", "2",
          "--e_layers", "1", "--d_layers", "1", "--train_epochs", "1",
          "--batch_size", "16", "--seq_len", "24", "--label_len", "8",
          "--pred_len", "8"]
PORTED = {
    "long_term_forecast": ["--task_name", "long_term_forecast", "--data",
                           "custom", "--dataset", "ett"],
    "stream_from_disk": ["--stream_from_disk", "--data", "UEA", "--dataset",
                         "Toy", "--model", "SBM", "--num_shapelet", "2"],
    "short_term_forecast": ["--task_name", "short_term_forecast", "--data",
                            "m4", "--seasonal_patterns", "Yearly",
                            "--seq_len", "12"],
    "imputation": ["--task_name", "imputation", "--data", "custom",
                   "--dataset", "ett", "--dnn_type", "PatchTST"],
    "anomaly_detection": ["--task_name", "anomaly_detection", "--data",
                          "SMD"],
    "ETTh1": ["--task_name", "long_term_forecast", "--data", "ETTh1",
              "--dataset", "ETTh1", "--dnn_type", "PatchTST",
              "--batch_size", "1024"],
}


@pytest.mark.parametrize("case", sorted(PORTED))
def test_formerly_unported_flags_run(case, tmp_path):
    from sie_tpu_torch.data.synthetic import (write_synthetic_ett,
                                              write_synthetic_m4,
                                              write_synthetic_smd)
    root = str(tmp_path)
    if case == "stream_from_disk":
        write_synthetic_uea(root, "Toy", n_train=20, n_test=10, n_dims=2,
                            length=24, n_classes=2, seed=3)
    elif case == "short_term_forecast":
        write_synthetic_m4(root, "Yearly", n_series=24, min_len=14,
                           max_len=30, seed=1)
    elif case == "anomaly_detection":
        write_synthetic_smd(root, n_train=300, n_test=240, n_channels=3,
                            seed=2)
    else:
        name = "ETTh1" if case == "ETTh1" else "ett"
        # ETTh1's borders need 20 months of hourly rows
        write_synthetic_ett(os.path.join(root, f"{name}.csv"),
                            n_rows=14400 if case == "ETTh1" else 200)
    argv = (["--device", "cpu", "--seed", "0", "--data_root", root,
             "--checkpoint_dir", os.path.join(root, "ck"),
             "--cache_dir", os.path.join(root, "cache"),
             "--result_dir", os.path.join(root, "result")]
            + _SMALL + PORTED[case])
    [(seed, _loss, metrics)] = port_run.main(argv)
    assert seed == 0 and metrics and all(
        np.isfinite(v) for v in metrics.values() if isinstance(v, float))
    if case != "stream_from_disk":
        task = argv[argv.index("--task_name") + 1]
        assert os.path.exists(os.path.join(root, "result", "InterpGN",
                                           f"{task}_seed0.pkl"))
    else:
        assert any(d.startswith("stream_UEA_train_")
                   for d in os.listdir(os.path.join(root, "cache")))


def test_default_device_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment(Config(**KW, data_root=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_run.main(["--seed", "0", "--data_root", str(tmp_path),
                       "--cache_dir", str(tmp_path)])
