"""The port's task experiments (sie_tpu_torch/train/tasks.py) against the
JAX package's (sie_tpu/train/tasks.py), on the CPU, from the same initial
weights (`load_jax_params`) at dropout 0 in f32, d_model 16, d_ff 32, 2
heads, 1 layer: both feed the same rows in the same order to optax-
semantics Adam, so

- forecast (Transformer, features MS, --inverse) and anomaly detection
  (PatchTST): per-epoch train and validation losses within 1e-4
  relative over 2 epochs, the same metric keys, values within 1e-4
  relative;
- short-term forecasting on M4 (TimesNet): sMAPE within 1e-4 relative;
- imputation (TimesNet, and the Transformer that ignores the mask): the
  loss and the test metrics within 1e-5 relative, given the keep masks
  the JAX package draws (reproduced here with jax.random);
- `adjust_predictions` bit-equal; the command line writes the pickle
  and M4's forecast CSV; the Autoformer family's forecast (Autoformer),
  imputation (FEDformer) and anomaly (Crossformer) experiments run as the
  JAX ones.
"""

import os
import pickle

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.train import tasks as jtasks
from sie_tpu_torch import run as port_run
from sie_tpu_torch.compat.from_jax import load_jax_params
from sie_tpu_torch.config import Config
from sie_tpu_torch.data.synthetic import write_synthetic_ett, write_synthetic_m4
from sie_tpu_torch.train import tasks as ptasks
from sie_tpu_torch.utils.m4_summary import M4Summary

REL = 1e-4
KW = dict(model="DNN", seq_len=24, label_len=8, pred_len=8, d_model=16,
          d_ff=32, n_heads=2, e_layers=1, d_layers=1, top_k=2, num_kernels=2,
          dropout=0.0, amp=False, batch_size=16, train_epochs=2, patience=5,
          lr=1e-3, seed=0)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = tmp_path_factory.mktemp("tasks")
    write_synthetic_ett(str(d / "ett.csv"), n_rows=300, seed=2)
    rng = np.random.default_rng(3)
    np.save(d / "SMD_train.npy", rng.normal(size=(520, 4)).astype(np.float32))
    test = rng.normal(size=(400, 4)).astype(np.float32)
    labels = np.zeros(400, np.float32)
    test[150:170] += 4.0
    labels[150:170] = 1.0
    np.save(d / "SMD_test.npy", test)
    np.save(d / "SMD_test_label.npy", labels)
    write_synthetic_m4(str(d / "m4"), "Yearly", n_series=40, min_len=20,
                       max_len=40, seed=4)
    return str(d)


# the JAX experiments' un-jitted forward passes (their test passes call
# them batch by batch) and the position of their static `train` argument
_EAGER = {"_apply": 3, "_reconstruct": 5, "_recon": 3}


def _pair(kind, **kw):
    """(JAX experiment, its initial params, port experiment at them). The
    JAX experiment's forward passes are jitted here (the same function):
    eagerly, its test pass spends seconds compiling op by op."""
    kw = dict(KW, **kw)
    jexp = getattr(jtasks, kind)(JConfig(**kw, use_pallas=False))
    for name, static in _EAGER.items():
        if hasattr(jexp, name):
            setattr(jexp, name, jax.jit(getattr(jexp, name),
                                        static_argnums=static))
    params = jexp.init_params(max(kw["seed"], 0))
    pexp = getattr(ptasks, kind)(Config(**kw), device="cpu")
    load_jax_params(pexp.model, jax.tree.map(np.asarray, params["params"]))
    return jexp, params, pexp


def _jax_train(jexp):
    """jexp.train() with its per-epoch train and validation losses."""
    step, evaluate = jax.jit(jexp._train_step), jexp.evaluate
    losses, vals = [], []

    def record(*a):
        out = step(*a)
        losses.append(out[2])
        return out

    jexp._jit_train = record
    jexp.evaluate = lambda p, d: vals.append(evaluate(p, d)) or vals[-1]
    best = jexp.train(seed=jexp.cfg.seed)
    n = jexp.steps_per_epoch
    train = [float(np.mean([float(l) for l in losses[e * n:(e + 1) * n]]))
             for e in range(len(vals))]
    return best, train, vals


def _close(got, want, rel):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= rel * max(abs(want[k]), 1e-6), \
            (k, got[k], want[k])


def _trains_like_jax(jexp, pexp):
    best, train, vals = _jax_train(jexp)
    pbest = pexp.train()
    assert len(pexp.history) == len(vals) == 2
    for rec, t, v in zip(pexp.history, train, vals):
        assert abs(rec["train_loss"] - t) <= REL * abs(t)
        assert abs(rec["val_loss"] - v) <= REL * abs(v)
    return best, pbest


def test_forecast_experiment_trains_like_jax(root):
    jexp, _, pexp = _pair("ForecastExperiment", dnn_type="Transformer",
                          data="custom", data_root=root, dataset="ett",
                          features="MS", inverse=True)
    best, pbest = _trains_like_jax(jexp, pexp)
    _close(pexp.test(pbest), jexp.test(best), REL)


def test_anomaly_experiment_trains_like_jax(root):
    jexp, _, pexp = _pair("AnomalyExperiment", dnn_type="PatchTST",
                          data="SMD", data_root=root, seq_len=40,
                          anomaly_ratio=5.0)
    best, pbest = _trains_like_jax(jexp, pexp)
    got, want = pexp.test(pbest), jexp.test(best)
    _close(got, want, REL)
    assert got["recall"] > 0


def test_short_term_smape_like_jax(root):
    jexp, _, pexp = _pair("ShortTermForecastExperiment", dnn_type="TimesNet",
                          data="m4", data_root=os.path.join(root, "m4"),
                          seasonal_patterns="Yearly", seq_len=12,
                          batch_size=8)
    assert pexp.cfg.pred_len == 6 and pexp.cfg.label_len == 0
    best, pbest = _trains_like_jax(jexp, pexp)
    got, want = pexp.test(pbest), jexp.test(best)
    assert list(got) == list(want)
    _close(got, want, REL)


@pytest.mark.parametrize("dnn", ["TimesNet", "Transformer"])
def test_imputation_loss_and_test_with_the_jax_masks(root, dnn):
    _imputes_like_jax(root, dnn)


def _imputes_like_jax(root, dnn, **kw):
    jexp, params, pexp = _pair("ImputationExperiment", dnn_type=dnn,
                               data="custom", data_root=root, dataset="ett",
                               mask_rate=0.25, **kw)
    rate = 0.25
    x, xm = (np.array(a[:16]) for a in jexp.train_data)
    rng = jax.random.key(11)
    want = float(jexp._loss(params, (x, xm), rng, False)[0])
    mask_rng, _ = jax.random.split(jax.random.fold_in(rng, 7))
    keep = np.asarray(jax.random.uniform(mask_rng, x.shape) >= rate,
                      np.float32)
    pexp.model.eval()
    with torch.no_grad():
        got = float(pexp._loss((torch.from_numpy(x), torch.from_numpy(xm)),
                               False,
                               keep=torch.from_numpy(keep)))
    assert abs(got - want) <= 1e-5 * abs(want)
    # the test pass, batch k keyed on fold_in(key(seed), k) there
    n = len(pexp._stage("test")[0])
    keeps = [np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.key(0), k),
        (min(16, n - 16 * k),) + tuple(x.shape[1:])) >= rate, np.float32)
        for k in range(-(-n // 16))]
    _close(pexp.test(keeps=keeps), jexp.test(params, seed=0), 1e-5)


def test_adjust_predictions_is_the_jax_one():
    rng = np.random.default_rng(5)
    for _ in range(20):
        gt = (rng.uniform(size=200) < 0.2).astype(np.int32)
        pred = (rng.uniform(size=200) < 0.1).astype(np.int32)
        got = ptasks.adjust_predictions(gt, pred)
        assert got.dtype == np.int32
        assert np.array_equal(got, jtasks.adjust_predictions(gt, pred))


def _cli(root, *flags):
    return ["--device", "cpu", "--model", "DNN", "--d_model", "16",
            "--d_ff", "32", "--n_heads", "2", "--e_layers", "1",
            "--d_layers", "1", "--top_k", "2", "--num_kernels", "2",
            "--batch_size", "16", "--train_epochs", "1", "--seed", "0",
            "--result_dir", os.path.join(root, "result"), *flags]


def test_cli_writes_the_pickle_and_the_m4_forecasts(root, capsys):
    out = port_run.main(_cli(root, "--task_name", "long_term_forecast",
                             "--data", "custom", "--data_root", root,
                             "--dataset", "ett", "--seq_len", "24",
                             "--label_len", "8", "--pred_len", "8"))
    with open(os.path.join(root, "result", "DNN",
                           "long_term_forecast_seed0.pkl"), "rb") as f:
        saved = pickle.load(f)
    assert saved["metrics"] == out[0][2] and set(saved["metrics"]) == \
        {"mse", "mae", "rmse", "mape", "mspe"}
    m4 = os.path.join(root, "m4")
    port_run.main(_cli(root, "--task_name", "short_term_forecast",
                       "--data", "m4", "--data_root", m4,
                       "--seasonal_patterns", "Yearly", "--seq_len", "12",
                       "--dnn_type", "TimesNet"))
    text = capsys.readouterr().out
    assert "[short_term_forecast] test: smape" in text
    csv_path = os.path.join(root, "result", "DNN", "Yearly_forecast.csv")
    fc = pd.read_csv(csv_path)
    assert fc.shape == (40, 6) and list(fc.columns) == \
        [f"V{j}" for j in range(1, 7)]
    smape, owa, _mape, _mase = M4Summary(os.path.dirname(csv_path),
                                         m4).evaluate()
    assert np.isfinite(smape["Yearly"]) and np.isfinite(owa["Average"])


@pytest.mark.parametrize("task", ["forecast", "imputation", "anomaly"])
def test_autoformer_family_raises_naming_the_roadmap(root, task):
    """Once a refusal (the family was not ported; the name is kept): the
    Autoformer family's branch of each task now runs as the JAX one from
    the same weights. Forecast (Autoformer): 2 epochs' losses and the test
    metrics within 1e-4 relative; imputation (FEDformer): the loss and the
    test metrics under the JAX masks within 1e-5; anomaly (Crossformer): 2
    epochs' losses and the metrics within 1e-4."""
    if task == "forecast":
        jexp, _, pexp = _pair("ForecastExperiment", dnn_type="Autoformer",
                              data="custom", data_root=root, dataset="ett",
                              features="MS", moving_avg=5)
        best, pbest = _trains_like_jax(jexp, pexp)
        _close(pexp.test(pbest), jexp.test(best), REL)
    elif task == "imputation":
        _imputes_like_jax(root, "FEDformer", moving_avg=5)
    else:
        jexp, _, pexp = _pair("AnomalyExperiment", dnn_type="Crossformer",
                              data="SMD", data_root=root, seq_len=40,
                              anomaly_ratio=5.0)
        best, pbest = _trains_like_jax(jexp, pexp)
        _close(pexp.test(pbest), jexp.test(best), REL)
