"""The task branches of the port's Transformer, TimesNet and PatchTST
(forecast, imputation, anomaly: nine classes) against the JAX package's,
on the CPU, at JAX-initialised weights carried over by `load_jax_params`
(which consumes every flax leaf exactly once and fills every parameter),
on the same inputs from numpy seeds, at d_model 16, d_ff 32, 2 heads, 1
layer.

Tolerances: forward 1e-5 abs in f32 (summation order); 5e-2 abs under
amp (bf16 products rounded at the same places, on outputs of order 1);
f32 gradients within 1e-4 of each parameter's largest gradient. The
causal decoder's output at step t does not move when decoder inputs
after t change; M4's one-column zero marks make a temporal embedding one
column wide."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.train.tasks import build_task_model as jax_build
from sie_tpu_torch.compat.from_jax import (load_jax_params, to_jax_params,
                                           to_jax_tree)
from sie_tpu_torch.config import Config
from sie_tpu_torch.train.tasks import build_task_model

FWD_TOL, AMP_TOL, GRAD_TOL = 1e-5, 5e-2, 1e-4
B, T, C, LABEL, PRED, MARKS = 3, 24, 3, 8, 8, 4
KW = dict(seq_len=T, label_len=LABEL, pred_len=PRED, enc_in=C, dec_in=C,
          c_out=C, d_model=16, d_ff=32, n_heads=2, e_layers=1, d_layers=1,
          top_k=2, num_kernels=2, dropout=0.0, freq="h", seed=0)
BRANCHES = [(task, dnn) for task in ("forecast", "imputation", "anomaly")
            for dnn in ("Transformer", "TimesNet", "PatchTST")]


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    keep = (rng.uniform(size=(B, T, C)) >= 0.25).astype(np.float32)
    return dict(x=f(B, T, C), xm=f(B, T, MARKS),
                dec=np.concatenate([f(B, LABEL, C),
                                    np.zeros((B, PRED, C), np.float32)], 1),
                dm=f(B, LABEL + PRED, MARKS), keep=keep)


def _args(task, dnn, inp, to):
    """The branch's call arguments, as train/tasks.py passes them."""
    a = {k: to(v) for k, v in inp.items()}
    if task == "forecast":
        return ((a["x"], a["xm"], a["dec"], a["dm"]) if dnn == "Transformer"
                else (a["x"], a["xm"]))
    if task == "imputation":
        return ((a["x"] * a["keep"], a["xm"]) if dnn == "Transformer"
                else (a["x"] * a["keep"], a["xm"], a["keep"]))
    return (a["x"],)


@functools.lru_cache(maxsize=None)
def _pair(task, dnn, amp=False):
    """(JAX module, flax params, port module holding them)."""
    kw = dict(KW, dnn_type=dnn, amp=amp)
    jm = jax_build(JConfig(**kw, use_pallas=False), task)
    args = _args(task, dnn, _inputs(), jnp.asarray)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        {"params": jax.random.key(1), "dropout": jax.random.key(2)},
        *args)["params"])
    pm = build_task_model(Config(**kw), task, marks=MARKS)
    load_jax_params(pm, params)
    return jm, params, pm.eval()


def _target(task):
    return np.random.default_rng(6).normal(
        size=(B, PRED if task == "forecast" else T, C)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_f32(task, dnn):
    """The JAX branch's f32 output and the gradients of a squared error
    against `_target`, at `_inputs(3)`: one jitted program."""
    jm, params, _pm = _pair(task, dnn)
    args = _args(task, dnn, _inputs(3), jnp.asarray)
    target = _target(task)

    def loss(p):
        out = jm.apply({"params": p}, *args)
        return jnp.mean((out - target) ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(out), jax.tree.map(np.asarray, grads)


def _port_f32(task, dnn):
    _jm, _params, pm = _pair(task, dnn)
    pm.zero_grad()
    out = pm(*_args(task, dnn, _inputs(3), torch.from_numpy))
    torch.mean((out - torch.from_numpy(_target(task))) ** 2).backward()
    grads = to_jax_tree(pm, {n: p.grad for n, p in pm.named_parameters()})
    return out.detach(), grads


@pytest.mark.parametrize("task,dnn", BRANCHES)
def test_forward_matches_jax_f32(task, dnn):
    want, _ = _jax_f32(task, dnn)
    got, _ = _port_f32(task, dnn)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=0)
    # the trees match leaf for leaf both ways
    _jm, params, pm = _pair(task, dnn)
    assert jax.tree.structure(to_jax_params(pm)) == \
        jax.tree.structure(params)


@pytest.mark.parametrize("task,dnn", BRANCHES)
def test_forward_matches_jax_amp(task, dnn):
    jm, params, pm = _pair(task, dnn, amp=True)
    inp = _inputs(4)
    want = np.asarray(jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
        params, *_args(task, dnn, inp, jnp.asarray)))
    with torch.no_grad():
        got = pm(*_args(task, dnn, inp, torch.from_numpy))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, atol=AMP_TOL, rtol=0)


@pytest.mark.parametrize("task,dnn", BRANCHES)
def test_gradients_match_jax_f32(task, dnn):
    """Each parameter's gradient within GRAD_TOL of its largest, floored
    at 1e-3 of the model's largest: the attention's key bias has a zero
    gradient up to rounding (the softmax ignores a shift shared by every
    key), and both packages' rounding noise there is ~1e-9."""
    _, want = _jax_f32(task, dnn)
    _, got = _port_f32(task, dnn)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_w.keys() == flat_g.keys()
    top = max(float(np.abs(w).max()) for w in flat_w.values())
    for path, w in flat_w.items():
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        err = float(np.abs(flat_g[path] - w).max())
        assert err <= GRAD_TOL * scale, (path, err, scale)


def test_decoder_is_causal():
    """The decoder's output at step t depends on its (embedded) inputs up
    to t only: the self-attention is causal (the token embedding's
    circular k=3 conv, before it, is not)."""
    _jm, _params, pm = _pair("forecast", "Transformer")
    a = _args("forecast", "Transformer", _inputs(7), torch.from_numpy)
    with torch.no_grad():
        enc = pm.encoder(pm.enc_embedding(a[0], None, a[1]))
        dec = pm.dec_embedding(a[2], None, a[3])
        full = pm.decoder(dec, enc)
        moved = dec.clone()
        moved[:, 10:] += 5.0
        changed = pm.decoder(moved, enc)
    assert torch.equal(full[:, :10], changed[:, :10])
    assert not torch.allclose(full[:, 10:], changed[:, 10:])


def test_m4_embedding_takes_one_column_marks():
    """M4's marks are one zero column (train/tasks.py): flax infers a
    temporal embedding one column wide from them, and the port builds the
    same, which then takes the JAX tree and runs."""
    kw = dict(KW, dnn_type="Transformer", enc_in=1, dec_in=1, c_out=1,
              label_len=0, amp=False)
    jm = jax_build(JConfig(**kw, use_pallas=False), "forecast")
    x = np.random.default_rng(8).normal(size=(2, T, 1)).astype(np.float32)
    xm = np.zeros((2, T, 1), np.float32)
    dec = np.zeros((2, PRED, 1), np.float32)
    dm = np.zeros((2, PRED, 1), np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), x, xm, dec,
                            dm)["params"]
    assert shapes["enc_embedding"]["temporal_embedding"]["kernel"].shape \
        == (1, 16)
    pm = build_task_model(Config(**kw), "forecast", marks=1)
    assert pm.enc_embedding.temporal_embedding.in_features == 1
    params = jax.tree.map(lambda s: np.random.default_rng(0).normal(
        size=s.shape).astype(np.float32), shapes)
    load_jax_params(pm, params)       # every leaf, one column wide
    with torch.no_grad():
        out = pm(*(torch.from_numpy(a) for a in (x, xm, dec, dm)))
    assert out.shape == (2, PRED, 1) and torch.isfinite(out).all()


def test_anomaly_heads_have_no_temporal_embedding():
    """flax builds no temporal embedding where no marks are passed: the
    anomaly heads take none whatever `marks` says."""
    for dnn in ("Transformer", "TimesNet"):
        pm = build_task_model(Config(**KW, dnn_type=dnn), "anomaly",
                              marks=MARKS)
        assert pm.enc_embedding.temporal_embedding is None
