"""Monash extrinsic regression in the port against the JAX package, on the
CPU.

- `load_monash_dataset` gives the JAX loader's x, y, mask and bin edges on
  a synthetic archive that both packages' writers write byte for byte;
- `make_crps_head` equals the JAX head within 1e-6 (f32 softmax and
  cumulative sums), with and without `truncate_targets`;
- float targets are kept: a target of 1.7 gives the JAX package's loss, not
  the truncated one, through the port's `Trainer` (whose batches once cast
  every target to int64);
- subsampling strides the mask with the data;
- one InterpGN + Transformer train step with the CRPS head at the JAX
  `Trainer(loss_head=...)`'s weights: the loss within 1e-5, the parameters
  within the limits of tests/test_torch_port_train.py (1e-6 where |g| >=
  1e-6, 2.1 x lr everywhere, f32);
- a 2-epoch `RegressionExperiment` from the JAX one's initial weights:
  per-epoch train and validation losses and the test loss within 1e-4 (f32
  sums in another order over 8 Adam steps, as
  tests/test_torch_port_experiment.py holds classification), the test
  logits (up to ~60 after training) within 1e-3 abs + 1e-3 relative;
- the best-variables snapshot is a copy, so a later step cannot move it;
- `python -m sie_tpu_torch.run --task_name regression --data Monash
  --device cpu` writes the CSV and the checkpoint, and a re-run skips
  training with the same test loss."""

import glob
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.data.monash import load_monash_dataset as jax_load
from sie_tpu.data.synthetic import write_synthetic_monash as jax_write
from sie_tpu.train.regression import RegressionExperiment as JExperiment
from sie_tpu.train.regression import make_crps_head as jax_crps
from sie_tpu.train.regression import subsample_factor as jax_factor
from sie_tpu.train.trainer import Trainer as JTrainer
from sie_tpu_torch import run as port_run
from sie_tpu_torch.compat.from_jax import (_flatten, _target, load_jax_params,
                                           to_jax_variables)
from sie_tpu_torch.config import Config
from sie_tpu_torch.data.monash import load_monash_dataset
from sie_tpu_torch.data.synthetic import write_synthetic_monash
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.train.regression import (RegressionExperiment,
                                            make_crps_head, subsample_batch,
                                            subsample_factor)
from sie_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(model="InterpGN", dnn_type="Transformer", num_shapelet=2,
             shapelet_lengths=(0.05, 0.1), d_model=16, d_ff=32, n_heads=2,
             e_layers=1, dropout=0.0, amp=False, use_pallas=False, lr=5e-3,
             seed=0)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A synthetic archive of 1100 steps (subsampled x2 to 550), written by
    both packages' writers."""
    root = tmp_path_factory.mktemp("monash")
    kw = dict(n_train=24, n_test=12, n_dims=2, length=1100, seed=3)
    write_synthetic_monash(str(root / "port"), "Reg", **kw)
    jax_write(str(root / "jax"), "Reg", **kw)
    return root


def test_writer_and_loader_match_jax(archive):
    for split in ("TRAIN", "TEST"):
        with open(archive / "port" / "Reg" / f"Reg_{split}.ts", "rb") as a, \
                open(archive / "jax" / "Reg" / f"Reg_{split}.ts", "rb") as b:
            assert a.read() == b.read()
    root = str(archive / "port")
    edges = None
    for flag in ("train", "test"):
        got = load_monash_dataset(root, "Reg", flag, bin_edges=edges)
        want = jax_load(root, "Reg", flag, bin_edges=edges)
        for f in ("x", "y", "padding_mask", "bin_edges"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.y.dtype == np.float32
        assert (got.num_class, got.enc_in, got.class_names) == \
            (want.num_class, want.enc_in, want.class_names)
        edges = got.bin_edges
    assert len(edges) == 10 and np.isinf(edges[-1])


@pytest.mark.parametrize("truncate", [False, True])
def test_crps_head_matches_jax(truncate):
    rng = np.random.default_rng(0)
    edges = np.sort(rng.uniform(0, 5, 9)).tolist() + [np.inf]
    logits = rng.normal(size=(8, 10)).astype(np.float32) * 3
    targets = rng.uniform(-0.5, 5.5, 8).astype(np.float32)
    for w in (rng.random(8).astype(np.float32), np.zeros(8, np.float32)):
        got = make_crps_head(np.array(edges), truncate)(
            torch.from_numpy(logits), torch.from_numpy(targets),
            torch.from_numpy(w))
        want = jax_crps(np.array(edges), truncate)(
            jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(w))
        assert float(got) == pytest.approx(float(want), abs=1e-6)


def test_subsampling_strides_the_mask():
    for t in (50, 999, 1000, 1001, 2500, 4000):
        assert subsample_factor(t) == jax_factor(t)
    x = np.arange(2 * 2500 * 1, dtype=np.float32).reshape(2, 2500, 1)
    mask = np.zeros((2, 2500), np.float32)
    mask[0, :2500], mask[1, :1201] = 1, 1
    assert subsample_batch(x).shape == (2, 834, 1)
    exp = RegressionExperiment.__new__(RegressionExperiment)
    jexp = JExperiment.__new__(JExperiment)
    batch = (x, np.zeros(2, np.float32), mask, np.ones(2, np.float32))
    got, want = exp._batch(batch), jexp._batch(batch)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2][1].sum() == 401    # rows 0, 3, ..., 1200 of the 1201


def _regression_batch(kw):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, kw["seq_len"], kw["enc_in"])).astype(np.float32)
    y = np.array([1.7, 0.2, 3.9, 2.5], np.float32)
    return x, y, np.ones((4, kw["seq_len"]), np.float32), \
        np.ones(4, np.float32)


EDGES = np.array([0.5, 1.0, 1.5, 2.0, 3.0, np.inf])


@pytest.fixture(scope="module")
def step_pair():
    """One CRPS train step of the JAX trainer and of the port's from the
    same weights: (port trainer, port loss, JAX loss, the JAX loss with
    truncated targets, JAX gradients and new params in port layout)."""
    kw = dict(MODEL, seq_len=40, enc_in=2, num_class=len(EDGES))
    batch = _regression_batch(kw)
    jt = JTrainer(JConfig(**kw), steps_per_epoch=1,
                  loss_head=jax_crps(EDGES))
    state = jt.init_state(batch, seed=0)
    params = jax.tree.map(np.asarray, state.params)
    jbatch = tuple(jnp.asarray(a) for a in batch)
    grad_fn = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True),
                      static_argnums=(4,))
    (jloss, _), jgrads = grad_fn(state.params, state.batch_stats, jbatch,
                                 jnp.float32(1.0), True, jax.random.key(0))
    trunc = JTrainer(JConfig(**kw), 1, loss_head=jax_crps(EDGES, True))
    tloss, _ = jax.jit(trunc.loss_fn, static_argnums=(4,))(
        state.params, state.batch_stats, jbatch, jnp.float32(1.0), True,
        jax.random.key(0))
    new_state, _, _ = jt.train_step(state, batch, 1.0)
    model = load_jax_params(build_model(Config(**kw), "cpu"), params)
    trainer = Trainer(Config(**kw), steps_per_epoch=1, model=model,
                      device="cpu", loss_head=make_crps_head(EDGES))
    loss, _ = trainer.train_step(batch, 1.0)
    layout = lambda tree: dict(_target(model, p, v) for p, v in
                               _flatten(jax.tree.map(np.asarray,
                                                     tree)).items())
    return dict(trainer=trainer, loss=float(loss), jloss=float(jloss),
                tloss=float(tloss), grads=layout(jgrads),
                new=layout(new_state.params))


def test_float_target_gives_the_jax_loss_not_the_truncated_one(step_pair):
    sp = step_pair
    assert sp["loss"] == pytest.approx(sp["jloss"], abs=1e-5)
    assert abs(sp["jloss"] - sp["tloss"]) > 1e-2
    t = sp["trainer"]
    x, y, mask, w = _regression_batch(dict(MODEL, seq_len=40, enc_in=2))
    ds = type("DS", (), dict(x=x, y=y, padding_mask=mask))()
    dev_y = t.device_data("train", ds)[1]
    assert dev_y.dtype == torch.float32 and torch.equal(
        dev_y, torch.from_numpy(y))
    assert t._device_batch((x, y, mask, w))[1].dtype == torch.float32
    assert t._device_batch((x, y.astype(np.int32), mask, w))[1].dtype == \
        torch.int64


def test_regression_step_updates_match_jax(step_pair):
    sp = step_pair
    params = dict(sp["trainer"].model.named_parameters())
    lr = MODEL["lr"]
    assert set(params) == set(sp["new"])
    for name, want in sp["new"].items():
        got = params[name].detach().numpy()
        sure = np.abs(sp["grads"][name]) >= 1e-6
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-6, rtol=0,
                                   err_msg=name)
        assert np.abs(got - want).max() <= 2.1 * lr, name


def test_best_snapshot_is_a_copy():
    model = build_model(Config(**dict(MODEL, seq_len=40, enc_in=2,
                                      num_class=3)), "cpu")
    snap = to_jax_variables(model)
    bank = snap["params"]["sbm"]["shapelets_0"].copy()
    with torch.no_grad():
        model.sbm.shapelets_0.add_(1.0)
    np.testing.assert_array_equal(snap["params"]["sbm"]["shapelets_0"], bank)


@pytest.fixture(scope="module")
def experiments(archive, tmp_path_factory):
    """Both experiments trained 2 epochs from the JAX one's initial
    weights: (JAX experiment, port experiment, JAX records, port
    records)."""
    tmp = tmp_path_factory.mktemp("reg")
    kw = dict(MODEL, task_name="regression", data="Monash", dataset="Reg",
              data_root=str(archive / "port"), batch_size=8, train_epochs=2,
              patience=5, log_interval=1, result_dir=str(tmp / "result"),
              cache_dir=str(tmp / "cache"))
    jrec, prec = [], []
    jexp = JExperiment(JConfig(**kw, checkpoint_dir=str(tmp / "jck")),
                       verbose=False, metrics_hook=jrec.append)
    jexp._init_state()
    pexp = RegressionExperiment(Config(**kw, checkpoint_dir=str(tmp / "pck")),
                                verbose=False, metrics_hook=prec.append,
                                device="cpu")
    load_jax_params(pexp.trainer.model,
                    jax.tree.map(np.asarray, jexp.state.params))
    jexp.train()
    pexp.train()
    return jexp, pexp, jrec, prec


def test_two_epochs_match_the_jax_experiment(experiments):
    jexp, pexp, jrec, prec = experiments
    assert pexp.cfg.seq_len == jexp.cfg.seq_len == 550
    assert pexp.cfg.num_class == 10
    assert len(jrec) == len(prec) == 2
    for j, p in zip(jrec, prec):
        assert p["train_loss"] == pytest.approx(j["train_loss"], abs=1e-4)
        assert p["val_loss"] == pytest.approx(j["val_loss"], abs=1e-4)
        assert p["beta"] == j["beta"]
    assert pexp.epoch_stop == jexp.epoch_stop
    jloss, jm, jdf = jexp.test(save_csv=False)
    ploss, pm, pdf = pexp.test(save_csv=False)
    assert jm is None and pm is None
    assert ploss == pytest.approx(jloss, abs=1e-4)
    np.testing.assert_allclose(pdf["pred"], jdf["pred"], atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_array_equal(pdf["target"], jdf["target"])
    assert pdf["w"].shape == jdf["w"].shape
    assert [l for _, l in pdf["shapelets"]] == [l for _, l in
                                                jdf["shapelets"]]


def _test_loss(text):
    return float(re.search(r"Test loss (\S+)", text).group(1))


def test_cli_writes_csv_and_checkpoint_and_skips_on_a_rerun(archive,
                                                            tmp_path, capsys):
    argv = ["--device", "cpu", "--task_name", "regression", "--data",
            "Monash", "--data_root", str(archive / "port"), "--dataset",
            "Reg", "--model", "InterpGN", "--num_shapelet", "2",
            "--d_model", "16", "--d_ff", "32", "--n_heads", "2",
            "--e_layers", "1", "--batch_size", "8", "--train_epochs", "2",
            "--log_interval", "1", "--seed", "0",
            "--checkpoint_dir", str(tmp_path / "ck"),
            "--result_dir", str(tmp_path / "result"),
            "--cache_dir", str(tmp_path / "cache")]
    first = subprocess.run([sys.executable, "-m", "sie_tpu_torch.run", *argv],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
    assert first.returncode == 0, first.stderr
    assert len(re.findall(r"Epoch \d/2 \| Train", first.stdout)) == 2
    assert "accuracy" not in first.stdout
    csvs = glob.glob(str(tmp_path / "result" / "InterpGN" / "Reg-0-*.csv"))
    ckpts = glob.glob(str(tmp_path / "ck" / "**" / "checkpoint.msgpack"),
                      recursive=True)
    assert len(csvs) == len(ckpts) == 1
    with open(csvs[0]) as f:
        header, row = f.read().splitlines()
    assert {"test_loss", "epoch_stop", "w_gini_abs", "eta_mean"} <= \
        set(header.split(","))
    assert len(row.split(",")) == len(header.split(","))
    results = port_run.main(argv)
    again = capsys.readouterr().out
    assert "checkpoint exists — skipping training" in again
    assert "Epoch" not in again
    assert _test_loss(again) == _test_loss(first.stdout)
    assert results[0][2] is None
