"""Serving bundles across the two packages, on the CPU: a bundle that
sie_tpu.serve.Predictor saves serves in the port and one the port saves
serves in the JAX package (f32 and int8, with batch_stats) at the same
logits; `from_checkpoint` on a port experiment's directory, and a missing
checkpoint raising; re-export switching the weight format and clearing a
stale calibration.json; `calibrate` against the JAX package's T;
`warmup`'s buckets; and `python -m sie_tpu_torch.run --device cpu
--export_bundle [--quantize_bundle]` on a tiny synthetic UEA set, whose
bundles serve in both packages at the experiment's test accuracy."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sie_tpu.config import Config as JConfig
from sie_tpu.data.provider import data_provider
from sie_tpu.models import build_model as jax_build
from sie_tpu.serve import Predictor as JPredictor
from sie_tpu_torch import run as port_run
from sie_tpu_torch.config import Config
from sie_tpu_torch.data.synthetic import write_synthetic_uea
from sie_tpu_torch.serve import Predictor
from sie_tpu_torch.train import checkpoint as ckpt

BASE = dict(model="InterpGN", seq_len=24, enc_in=3, num_class=4,
            num_shapelet=2, d_model=16, d_ff=32, n_heads=2, e_layers=1,
            dropout=0.0, use_pallas=False, seed=0)
CONFIGS = {"fcn": dict(BASE, dnn_type="FCN", amp=False),
           "transformer_amp": dict(BASE, dnn_type="Transformer", amp=True,
                                   fused_attention_min_len=0)}
TOL = {"fcn": 1e-4, "transformer_amp": 5e-2}   # f32 / bf16 logits
QTOL = 1e-4    # the same int8 weights in both packages: f32 sums
MIN_SIZE = 64


@functools.lru_cache(maxsize=None)
def _init(name):
    """(JAX config, flax variables with moved batch_stats where the model
    has BatchNorm)."""
    cfg = JConfig(**CONFIGS[name])
    v = jax.device_get(jax_build(cfg).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((2, 24, 3)), jnp.ones((2, 24)), train=False))
    out = {"params": v["params"]}
    if v.get("batch_stats"):
        rng = np.random.default_rng(5)
        out["batch_stats"] = jax.tree.map(
            lambda a: (np.abs(rng.normal(size=a.shape)) + 0.5).astype(
                np.float32), v["batch_stats"])
    return cfg, out


def _x(b, seed=0):
    return np.random.default_rng(seed).normal(size=(b, 24, 3)).astype(
        np.float32)


CASES = [("jax", "fcn", False), ("jax", "fcn", True), ("port", "fcn", False),
         ("port", "fcn", True), ("jax", "transformer_amp", True),
         ("port", "transformer_amp", False)]


@pytest.mark.parametrize("writer,name,quantize", CASES,
                         ids=lambda v: str(v))
def test_bundles_cross_both_ways(writer, name, quantize, tmp_path):
    jcfg, variables = _init(name)
    d = str(tmp_path / "bundle")
    if writer == "jax":
        JPredictor(jcfg, variables).save_bundle(d, quantize=quantize,
                                                min_size=MIN_SIZE)
    else:
        Predictor(Config(**CONFIGS[name]), variables, device="cpu"
                  ).save_bundle(d, quantize=quantize, min_size=MIN_SIZE)
        with open(os.path.join(d, "bundle_meta.json")) as f:
            meta = json.load(f)
        assert meta["framework"] == "sie_tpu_torch"
        assert meta["quantized"] is quantize
    files = set(os.listdir(d))
    assert ("weights_q.npz" in files) is quantize
    assert ("checkpoint.msgpack" in files) is not quantize
    tp = Predictor.load_bundle(d, device="cpu", max_batch=4)
    jp = JPredictor.load_bundle(d, max_batch=4)
    assert tp.quantized is quantize
    if "batch_stats" in variables:
        bn = tp.model.deep_model.bn1
        np.testing.assert_array_equal(
            bn.mean.numpy(), variables["batch_stats"]["deep_model"]["bn1"][
                "mean"])
    x = _x(6, seed=3)
    got, want = tp.predict(x), jp.predict(x)
    tol = QTOL if quantize and name == "fcn" else TOL[name]
    np.testing.assert_allclose(got.logits, want.logits, atol=tol)
    np.testing.assert_array_equal(got.classes, want.classes)


def test_from_checkpoint_and_missing_checkpoint(tmp_path):
    jcfg, variables = _init("fcn")
    cfg = Config(**CONFIGS["fcn"], checkpoint_dir=str(tmp_path / "ck"))
    ckpt.save_checkpoint(os.path.join(cfg.checkpoint_dir,
                                      cfg.checkpoint_key()),
                         variables["params"], variables["batch_stats"])
    got = Predictor.from_checkpoint(cfg, device="cpu").predict(_x(3))
    want = Predictor(cfg, variables, device="cpu").predict(_x(3))
    np.testing.assert_array_equal(got.logits, want.logits)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Predictor.from_checkpoint(cfg.replace(seed=1), device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Predictor.from_checkpoint(cfg, str(tmp_path / "none"), device="cpu")


def test_reexport_switches_format_and_clears_calibration(tmp_path):
    _, variables = _init("fcn")
    pred = Predictor(Config(**CONFIGS["fcn"]), variables, device="cpu")
    d = str(tmp_path / "b")
    pred.save_bundle(d, quantize=True, min_size=MIN_SIZE)
    assert os.path.exists(os.path.join(d, "weights_q.npz"))
    pred.save_bundle(d)                       # back to f32 in place
    assert not os.path.exists(os.path.join(d, "weights_q.npz"))
    assert not Predictor.load_bundle(d, device="cpu").quantized
    pred.save_bundle(d, quantize=True, min_size=MIN_SIZE)
    assert not os.path.exists(os.path.join(d, "checkpoint.msgpack"))
    qpred = Predictor.load_bundle(d, device="cpu")
    assert qpred.quantized
    with pytest.raises(ValueError, match="no f32 weights"):
        qpred.save_bundle(str(tmp_path / "again"))
    pred.temperature = 2.5
    pred.save_bundle(d)
    assert Predictor.load_bundle(d, device="cpu").temperature == 2.5
    assert JPredictor.load_bundle(d).temperature == 2.5
    pred.temperature = 1.0
    pred.save_bundle(d)                       # re-export uncalibrated
    assert not os.path.exists(os.path.join(d, "calibration.json"))
    assert Predictor.load_bundle(d, device="cpu").temperature == 1.0


def test_calibrate_matches_jax(tmp_path):
    jcfg, variables = _init("fcn")
    tp = Predictor(Config(**CONFIGS["fcn"]), variables, device="cpu")
    jp = JPredictor(jcfg, variables)
    x = _x(40, seed=7)
    y = np.random.default_rng(8).integers(0, 4, size=40)
    t_port, t_jax = tp.calibrate(x, y), jp.calibrate(x, y)
    assert t_port != 1.0
    np.testing.assert_allclose(t_port, t_jax, rtol=1e-3)
    d = str(tmp_path / "cal")
    tp.save_bundle(d)
    assert Predictor.load_bundle(d, device="cpu").temperature == t_port
    out = tp.predict(x)
    np.testing.assert_array_equal(out.classes, out.logits.argmax(-1))


def test_warmup_runs_every_bucket_reached():
    _, variables = _init("fcn")
    tp = Predictor(Config(**CONFIGS["fcn"]), variables, device="cpu",
                   max_batch=4)
    seen = []
    chunk = tp._predict_chunk
    tp._predict_chunk = lambda x, *a: seen.append(tp._bucket(x.shape[0])) \
        or chunk(x, *a)
    tp.warmup(batch_sizes=(1, 3))
    assert sorted(seen) == [1, 4]
    seen.clear()
    tp.warmup(batch_sizes=(2, 300))
    assert sorted(seen) == [2, 4]


def test_cli_exports_bundles_that_serve_in_both(tmp_path):
    write_synthetic_uea(str(tmp_path), "Toy", n_train=24, n_test=12,
                        n_dims=2, length=30, n_classes=2, seed=1)
    common = ["--device", "cpu", "--data", "UEA", "--data_root",
              str(tmp_path), "--dataset", "Toy", "--model", "InterpGN",
              "--dnn_type", "FCN", "--num_shapelet", "2", "--batch_size",
              "8", "--train_epochs", "2", "--patience", "3", "--seed", "0",
              "--no-amp", "--log_interval", "1",
              "--checkpoint_dir", str(tmp_path / "ck"),
              "--result_dir", str(tmp_path / "result"),
              "--cache_dir", str(tmp_path / "cache")]
    f32, q = str(tmp_path / "f32"), str(tmp_path / "q")
    acc = port_run.main(common + ["--export_bundle", f32])[0][2]["accuracy"]
    # the re-run skips training and exports the same weights as int8
    res = port_run.main(common + ["--export_bundle", q, "--quantize_bundle"])
    assert res[0][2]["accuracy"] == acc
    assert os.path.exists(os.path.join(q, "weights_q.npz"))
    test_data, _ = data_provider(JPredictor.load_bundle(f32).cfg, "test")
    for d in (f32, q):
        tp = Predictor.load_bundle(d, device="cpu")
        jp = JPredictor.load_bundle(d)
        got, want = tp.predict(test_data.x), jp.predict(test_data.x)
        np.testing.assert_allclose(got.logits, want.logits, atol=1e-4)
        np.testing.assert_array_equal(got.classes, want.classes)
        if d == f32:   # the experiment's weights: its test accuracy
            assert abs(100.0 * float((got.classes == test_data.y).mean())
                       - acc) < 1e-6
