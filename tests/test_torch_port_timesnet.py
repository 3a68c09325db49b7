"""The port's TimesNet (sie_tpu_torch/models/timesnet.py) against the JAX
package's (sie_tpu/models/timesnet.py), on the CPU, at the same flax
weights carried over by `load_jax_params`; the same inputs from a numpy
seed go through both.

Tolerances (f32, amp off): 1e-5 abs for the modules (InceptionConvSeq,
fft_periods' weights), 1e-4 abs for the models' logits and gradients,
from f32 summation order (the port sums a row's taps in one product, the
JAX module in an einsum; the model adds LayerNorm and the projection over
T * d_model inputs). The periods are integers and equal exactly. Bundles:
the same bytes (checkpoint.msgpack) or arrays (weights_q.npz) as the JAX
package's `save_bundle` for the same variables, and the same logits
within 1e-4 through both packages' predictors."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.models import build_model as jax_build
from sie_tpu.models.timesnet import InceptionConvSeq as JInception
from sie_tpu.models.timesnet import _inception_taps as jax_taps
from sie_tpu.models.timesnet import fft_periods as jax_fft_periods
from sie_tpu.serve import Predictor as JPredictor
from sie_tpu_torch.compat.from_jax import load_jax_params
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.models.timesnet import (InceptionConvSeq, _inception_taps,
                                           fft_periods)
from sie_tpu_torch.serve import Predictor

MOD_TOL, MODEL_TOL = 1e-5, 1e-4
T = 37
KW = dict(seq_len=T, enc_in=3, num_class=3, num_shapelet=2, d_model=8,
          d_ff=8, top_k=2, num_kernels=3, e_layers=2, dropout=0.0,
          amp=False, use_pallas=False, dnn_type="TimesNet", seed=0)


def _x(b=4, seed=0):
    return np.random.default_rng(seed).normal(size=(b, T, 3)).astype(
        np.float32)


def test_tap_table_is_the_jax_one():
    for k in (1, 2, 6):
        np.testing.assert_array_equal(_inception_taps(k), jax_taps(k))


@functools.lru_cache(maxsize=None)
def _inception():
    """(jitted JAX apply, its params, the port module with them)."""
    jm = JInception(4, 5, num_kernels=3)
    canvas = jnp.zeros((2, 2 * T, 4))
    params = jax.device_get(jm.init(jax.random.key(3), canvas, 3, T))
    params = jax.tree.map(np.asarray, params)
    apply = jax.jit(lambda x, p, n: jm.apply(params, x, p, n))
    port = InceptionConvSeq(4, 5, 3, torch.float32,
                            torch.Generator().manual_seed(0))
    load_jax_params(port, params["params"])
    return apply, port


# 1 and T at the ends, 3 and 7 do not divide 37, 5 neither, 37 // 2 = 18
@pytest.mark.parametrize("period", [1, 3, 7, 18, T])
def test_inception_conv_seq_matches_jax(period):
    apply, port = _inception()
    rng = np.random.default_rng(period)
    x = np.zeros((2, 2 * T, 4), np.float32)
    x[:, :T] = rng.normal(size=(2, T, 4))
    canvas_len = -(-T // period) * period
    want = np.asarray(apply(jnp.asarray(x), period, canvas_len))
    got = port(torch.from_numpy(x), torch.tensor(period),
               torch.tensor(canvas_len))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=MOD_TOL,
                               rtol=0)


def test_inception_conv_seq_gradient_through_the_recompute():
    """The rows are recomputed in the backward pass (no random draws
    there): the gradients equal, bit for bit, those of the same sums
    without recompute."""
    _apply, port = _inception()
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 2 * T, 4)).astype(np.float32)).requires_grad_()
    p, n = torch.tensor(7), torch.tensor(42)
    wrt = (x, port.tap_weights, port.bias)
    got = torch.autograd.grad(port(x, p, n).square().sum(), wrt)
    w_eff = port.collapsed()
    acc = torch.zeros(2, 2 * T, 5)
    for i, dr in enumerate(range(-2, 3)):
        acc = acc + port._row(x, w_eff[i], dr, p, n)
    plain = acc / 3 + port.bias.mean(dim=0)[None, None, :]
    want = torch.autograd.grad(plain.square().sum(), wrt)
    for a, b in zip(got, want):
        assert float(b.abs().max()) > 0
        assert torch.equal(a, b)


def test_fft_periods_match_jax_on_random_data():
    x = np.random.default_rng(4).normal(size=(3, T, 5)).astype(np.float32)
    jp, jw = jax_fft_periods(jnp.asarray(x), 4)
    tp, tw = fft_periods(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=MOD_TOL)


def test_fft_periods_break_ties_by_the_lower_frequency():
    """A unit impulse has an amplitude of exactly 1 at every frequency, so
    every bin ties: `lax.top_k` takes bins 1, 2, 3 in that order, and so
    must the port (torch.topk does not promise it)."""
    x = np.zeros((2, 32, 3), np.float32)
    x[:, 0, :] = 1.0
    jp, _ = jax_fft_periods(jnp.asarray(x), 3)
    tp, tw = fft_periods(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(np.asarray(jp), [32, 16, 10])
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tw.numpy(), np.ones((2, 3), np.float32))


@functools.lru_cache(maxsize=None)
def _model(model: str):
    kw = dict(KW, model=model)
    jm = jax_build(JConfig(**kw))
    v = jm.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                jnp.zeros((2, T, 3)), jnp.ones((2, T)), train=False)
    params = jax.tree.map(np.asarray, jax.device_get(v["params"]))
    return kw, jm, params


def test_timesnet_logits_and_gradients_match_jax():
    kw, jm, params = _model("DNN")
    x, mask = _x(), np.ones((4, T), np.float32)
    r = np.random.default_rng(9).normal(size=(4, 3)).astype(np.float32)

    def loss(p):
        logits, _ = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask),
                             train=False)
        return jnp.sum(logits * r), logits

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    port = load_jax_params(build_model(Config(**kw), "cpu"), params)
    got, _ = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=MODEL_TOL, rtol=0)
    (got * torch.from_numpy(r)).sum().backward()
    flat = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(grads)}
    from sie_tpu_torch.compat.from_jax import to_jax_tree
    mine = to_jax_tree(port, {n: p.grad for n, p in port.named_parameters()})
    mine = {"/".join(k.key for k in path): g for path, g in
            jax.tree_util.tree_leaves_with_path(mine)}
    assert sorted(mine) == sorted(flat)
    assert any("block_1/conv2/tap_weights" in k for k in flat)
    for k in flat:
        np.testing.assert_allclose(mine[k], flat[k], atol=MODEL_TOL, rtol=0,
                                   err_msg=k)


def test_interpgn_timesnet_logits_match_jax():
    kw, jm, params = _model("InterpGN")
    x, mask = _x(seed=2), np.ones((4, T), np.float32)
    want, jinfo = jm.apply({"params": params}, jnp.asarray(x),
                           jnp.asarray(mask), train=False)
    port = load_jax_params(build_model(Config(**kw), "cpu"), params)
    with torch.inference_mode():
        got, info = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL,
                               rtol=0)
    np.testing.assert_allclose(info.eta.numpy(), np.asarray(jinfo.eta),
                               atol=MODEL_TOL)


@pytest.mark.parametrize("quantize", [False, True])
def test_bundle_bytes_and_logits_equal_the_jax_package(quantize, tmp_path):
    """InterpGN + TimesNet served from bundles: the port's save_bundle
    writes what the JAX package's writes for the same variables (int8 at
    a min_size that quantizes the tap tables and the projection), and
    each package serves the other's bundle at the same logits."""
    kw, _jm, params = _model("InterpGN")
    variables = {"params": params, "batch_stats": {}}
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    Predictor(Config(**kw), variables, device="cpu").save_bundle(
        mine, quantize=quantize, min_size=64)
    JPredictor(JConfig(**kw), variables).save_bundle(
        theirs, quantize=quantize, min_size=64)
    if quantize:
        a, b = (np.load(os.path.join(d, "weights_q.npz"))
                for d in (mine, theirs))
        assert sorted(a.files) == sorted(b.files)
        assert any("tap_weights" in k for k in a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    else:
        with open(os.path.join(mine, "checkpoint.msgpack"), "rb") as f, \
                open(os.path.join(theirs, "checkpoint.msgpack"), "rb") as g:
            assert f.read() == g.read()
    x = _x(5, seed=6)
    got = Predictor.load_bundle(theirs, device="cpu", max_batch=8).predict(x)
    want = JPredictor.load_bundle(mine, max_batch=8).predict(x)
    assert Predictor.load_bundle(mine, device="cpu").quantized is quantize
    np.testing.assert_allclose(got.logits, want.logits, atol=MODEL_TOL)
    np.testing.assert_array_equal(got.classes, want.classes)
