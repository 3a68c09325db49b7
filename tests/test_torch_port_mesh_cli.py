"""The command line over several processes, on the CPU (gloo):

- `--loso` under the launch variables (SIE_TPU_COORDINATOR,
  SIE_TPU_NUM_PROCESSES, SIE_TPU_PROCESS_ID), two processes, 3 synthetic
  subjects: each prints `[multihost] process i/2 took folds ...`, the
  folds are disjoint and cover every subject, and each fold's accuracy
  equals a one-process `run_loso` of the same config;
- `--mesh 2 --device cpu` without the variables starts its two workers
  itself: it trains over 'data' and tests once (process 0 writes one CSV
  and the checkpoint), at the test accuracy of the run without a mesh;
  `--mesh 2 --mesh_axes seq` with the FCN expert does the same over
  time blocks;
- `--mesh 2` with a forecast task trains in this one process, says that
  the mesh is ignored and gives the metrics of the run without it, as
  the JAX CLI does; a bare `--device cuda` with more cards than the host
  has raises make_mesh's ValueError first.
"""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import torch

from sie_tpu_torch import run as port_run
from sie_tpu_torch.data.synthetic import (write_synthetic_ett,
                                          write_synthetic_uea)
from sie_tpu_torch.parallel.loso import run_loso
from sie_tpu_torch.parallel.multihost import free_port
from sie_tpu_torch.run import args_to_config, get_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = ["--model", "InterpGN", "--num_shapelet", "2", "--d_model", "16",
         "--d_ff", "32", "--n_heads", "2", "--e_layers", "1",
         "--log_interval", "1", "--seed", "0", "--no-amp"]


def _run(argv, env, log):
    with open(log, "wb") as f:
        return subprocess.Popen([sys.executable, "-m", "sie_tpu_torch.run",
                                 *argv], cwd=REPO, env=env, stdout=f,
                                stderr=subprocess.STDOUT)


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SIE_TPU_")}
    env.update(OMP_NUM_THREADS="1", **kw)
    return env


def test_loso_folds_split_across_two_processes(tmp_path):
    argv = ["--device", "cpu", "--loso", "--data", "EEG3", "--data_root",
            str(tmp_path / "none"), "--max_files", "4", "--target_channels",
            "8", "--target_timepoints", "200", "--synthetic_trials", "48",
            "--max_subjects", "3", "--batch_size", "8", "--train_epochs",
            "1", "--checkpoint_dir", str(tmp_path / "ck"), "--result_dir",
            str(tmp_path / "result"), "--cache_dir", str(tmp_path / "cache"),
            *WIDTH]
    base = _env(SIE_TPU_COORDINATOR=f"localhost:{free_port()}",
                SIE_TPU_NUM_PROCESSES="2", SIE_TPU_BACKEND="gloo")
    procs = [_run(argv, dict(base, SIE_TPU_PROCESS_ID=str(i)),
                  tmp_path / f"loso_{i}.log") for i in range(2)]
    for p in procs:
        p.wait(timeout=300)
    folds, accs = [], {}
    for i, p in enumerate(procs):
        out = (tmp_path / f"loso_{i}.log").read_text()
        assert p.returncode == 0, out[-3000:]
        m = re.search(r"\[multihost\] process (\d)/2 took folds "
                      r"slice\((\d+), (\d+), None\)", out)
        assert m and int(m.group(1)) == i, out[-2000:]
        got = [int(s) for s in re.findall(r"\[LOSO\] subject (\d+)", out)]
        assert got == list(range(int(m.group(2)), int(m.group(3))))
        folds.extend(got)
        accs.update({int(k): float(v) for k, v in re.findall(
            r"\[LOSO\] subject (\d+): acc ([0-9.]+)%", out)})
    assert sorted(folds) == [0, 1, 2]
    cfg = args_to_config(get_args(argv + ["--checkpoint_dir",
                                          str(tmp_path / "one")]), 0)
    alone = run_loso(cfg, verbose=False, device="cpu")
    assert {f["held_out_subject"]: round(f["accuracy"], 2)
            for f in alone} == accs


@pytest.fixture(scope="module")
def uea(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_cli")
    write_synthetic_uea(str(root), "Toy", n_train=24, n_test=12, n_dims=3,
                        length=30, n_classes=2, seed=9)
    return root


def _uea_argv(root, tag, *extra):
    return ["--device", "cpu", "--data", "UEA", "--data_root", str(root),
            "--dataset", "Toy", "--dnn_type", "Transformer", "--batch_size",
            "8", "--train_epochs", "2", "--patience", "3",
            "--checkpoint_dir", str(root / tag / "ck"), "--result_dir",
            str(root / tag / "result"), "--cache_dir", str(root / "cache"),
            *WIDTH, *extra]


def test_mesh_flag_spawns_its_workers_and_trains_as_one_process(uea):
    logs = {}
    for tag, extra in (("mesh", ["--mesh", "2"]), ("one", [])):
        p = _run(_uea_argv(uea, tag, *extra), _env(), uea / f"{tag}.log")
        p.wait(timeout=300)
        logs[tag] = (uea / f"{tag}.log").read_text()
        assert p.returncode == 0, logs[tag][-3000:]
    acc = [re.findall(r"Test accuracy ([0-9.]+)%", logs[t])
           for t in ("mesh", "one")]
    assert len(acc[0]) == 1 and acc[0] == acc[1]
    assert len(glob.glob(str(uea / "mesh" / "result" / "InterpGN" /
                             "*.csv"))) == 1
    assert glob.glob(str(uea / "mesh" / "ck" / "**" / "checkpoint.msgpack"),
                     recursive=True)


def test_mesh_seq_flag_trains_fcn_as_one_process(uea):
    """`--mesh 2 --mesh_axes seq` (two workers, time blocks of 15 steps)
    with the FCN expert in f32 against the run without a mesh: the same
    test accuracy, each epoch's train loss within 1e-4 and validation
    loss within 2e-3, the test loss within 2e-3. These are the limits
    tests/test_torch_port_bn_experiment.py sets between the JAX and the
    port's FCN runs on this data, for the same reason: FCN's conv biases
    stand in front of a BatchNorm, their gradient is rounding noise that
    Adam turns into moves of ~lr a step, and the eval losses read them
    through the running means (the two runs round differently: time
    blocks and sums over 'seq')."""
    import pickle
    out = {}
    for tag, extra in (("seq", ["--mesh", "2", "--mesh_axes", "seq"]),
                       ("seq_one", [])):
        p = _run(_uea_argv(uea, tag, "--dnn_type", "FCN", *extra), _env(),
                 uea / f"{tag}.log")
        p.wait(timeout=300)
        log = (uea / f"{tag}.log").read_text()
        assert p.returncode == 0, log[-3000:]
        [pkl] = glob.glob(str(uea / tag / "ck" / "**" / "test_results.pkl"),
                          recursive=True)
        with open(pkl, "rb") as f:
            saved = pickle.load(f)
        out[tag] = (re.findall(r"Test accuracy ([0-9.]+)%", log),
                    saved["test_loss"],
                    np.array(re.findall(r"Train Loss ([0-9.]+) \| Val Loss "
                                        r"([0-9.]+)", log), float))
    assert len(out["seq"][0]) == 1 and out["seq"][0] == out["seq_one"][0]
    (_, loss, epochs), (_, one_loss, one_epochs) = out["seq"], out["seq_one"]
    assert epochs.shape == one_epochs.shape == (2, 2)
    np.testing.assert_allclose(epochs[:, 0], one_epochs[:, 0], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(epochs[:, 1], one_epochs[:, 1], rtol=0,
                               atol=2e-3)
    assert loss == pytest.approx(one_loss, abs=2e-3)


def _task_argv(root, *extra):
    return ["--device", "cpu", "--task_name", "long_term_forecast",
            "--model", "DNN", "--data", "custom", "--data_root", str(root),
            "--dataset", "ett", "--seq_len", "24", "--label_len", "8",
            "--pred_len", "8", "--d_model", "16", "--d_ff", "32",
            "--n_heads", "2", "--e_layers", "1", "--d_layers", "1",
            "--batch_size", "16", "--train_epochs", "1", "--seed", "0",
            "--result_dir", str(root / "result"), *extra]


def test_mesh_with_a_task_trains_in_one_process(tmp_path, monkeypatch,
                                                capsys):
    for k in [k for k in os.environ if k.startswith("SIE_TPU_")]:
        monkeypatch.delenv(k)
    write_synthetic_ett(str(tmp_path / "ett.csv"), n_rows=300, seed=2)
    alone = port_run.main(_task_argv(tmp_path))
    capsys.readouterr()
    meshed = port_run.main(_task_argv(tmp_path, "--mesh", "2",
                                      "--mesh_axes", "data"))
    out = capsys.readouterr().out
    assert "[long_term_forecast] --mesh 2 is ignored" in out
    assert meshed[0][2] == alone[0][2]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = max(have + 1, 2)
    argv = _task_argv(tmp_path, "--mesh", str(n))
    argv[argv.index("cpu")] = "cuda"
    with pytest.raises(ValueError, match=f"needs {n} devices"):
        port_run.main(argv)
