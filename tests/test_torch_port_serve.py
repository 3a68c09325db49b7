"""sie_tpu_torch.serve.Predictor vs sie_tpu.serve.Predictor at the same
flax weights, on the CPU: buckets, chunking, gating_value, fields,
temperature, the empty batch, and the device rule (no silent CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.models import build_model as jax_build
from sie_tpu.serve import Predictor as JPredictor
from sie_tpu_torch.config import Config, config_from_json, config_to_json
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.serve import Predictor

KW = dict(model="InterpGN", dnn_type="Transformer", seq_len=24, enc_in=3,
          num_class=4, num_shapelet=2, d_model=16, d_ff=32, n_heads=2,
          e_layers=1, dropout=0.0, amp=False, use_pallas=False, seed=0)
TOL = 1e-4   # f32, summation order


@pytest.fixture(scope="module")
def pair():
    jcfg = JConfig(**KW)
    model = jax_build(jcfg)
    variables = model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((2, 24, 3)), jnp.ones((2, 24)), train=False)
    variables = {"params": jax.tree.map(np.asarray, variables["params"])}
    jp = JPredictor(jcfg, variables, max_batch=4, temperature=1.7)
    tp = Predictor(Config(**KW), variables, device="cpu", max_batch=4,
                   temperature=1.7)
    return jp, tp


def _x(b, seed=0):
    return np.random.default_rng(seed).normal(size=(b, 24, 3)).astype(
        np.float32)


@pytest.mark.parametrize("b", [1, 3, 6])
def test_predict_matches_jax(pair, b):
    jp, tp = pair
    x = _x(b, seed=b)
    got, want = tp.predict(x), jp.predict(x)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.shape == w.shape, f.name
        if f.name == "classes":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=TOL, err_msg=f.name)


def test_gating_value_and_fields(pair):
    jp, tp = pair
    x = _x(5, seed=9)
    for gv in (None, 0.0, 0.3):
        got = tp.predict(x, gating_value=gv, fields={"eta"})
        want = jp.predict(x, gating_value=gv, fields={"eta"})
        np.testing.assert_allclose(got.logits, want.logits, atol=TOL)
        np.testing.assert_allclose(got.eta, want.eta, atol=1e-5)
        assert got.p is None and got.d is None and got.dnn_preds is None
    assert (tp.predict(x, gating_value=0.0).eta == 1.0).all()


def test_buckets_chunking_and_padding_rows(pair):
    _, tp = pair
    assert [tp._bucket(b) for b in (1, 2, 3, 4, 5, 100)] == [1, 2, 4, 4, 4, 4]
    x = _x(6, seed=4)
    whole = tp.predict(x)
    # each row alone gives the same logits: padding and chunking never mix rows
    for i in (0, 4, 5):
        np.testing.assert_allclose(tp.predict(x[i:i + 1]).logits,
                                   whole.logits[i:i + 1], atol=1e-6)


def test_temperature_scales_probs_only(pair):
    _, tp = pair
    x = _x(3, seed=5)
    hot = tp.predict(x)
    tp.temperature = 1.0
    try:
        cold = tp.predict(x)
    finally:
        tp.temperature = 1.7
    np.testing.assert_array_equal(hot.logits, cold.logits)
    np.testing.assert_array_equal(hot.classes, cold.classes)
    assert not np.allclose(hot.probs, cold.probs)


def test_empty_batch(pair):
    jp, tp = pair
    got, want = tp.predict(_x(0)), jp.predict(_x(0))
    assert got.logits.shape == want.logits.shape == (0, 4)
    assert got.classes.shape == (0,)


def test_bad_shape_raises(pair):
    _, tp = pair
    with pytest.raises(ValueError):
        tp.predict(np.zeros((2, 23, 3), np.float32))


def test_from_module_serves_torch_weights():
    cfg = Config(**KW)
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(3))
    p = Predictor.from_module(cfg, model, device="cpu", max_batch=2)
    out = p.predict(_x(3, seed=1))
    assert out.logits.shape == (3, 4) and np.isfinite(out.logits).all()
    np.testing.assert_array_equal(out.classes, out.logits.argmax(-1))


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(**KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg, {"params": {}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_module(cfg, build_model(cfg, "cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)


def test_config_json_round_trip():
    cfg = Config(**KW).replace(shapelet_lengths=(0.1, 0.3), gating_value=0.5)
    text = config_to_json(cfg)
    assert config_from_json(text) == cfg
    assert config_from_json(text[:-2] + ', "not_a_field": 1\n}') == cfg
    # the JAX package's config.json reads in the port
    from sie_tpu.serve import config_to_json as jax_to_json
    jcfg = JConfig(**KW)
    assert config_from_json(jax_to_json(jcfg)) == Config(**KW)
