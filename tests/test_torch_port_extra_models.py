"""The Autoformer, FEDformer, ETSformer, Pyraformer and Crossformer models
of the port (sie_tpu_torch/models/extra/backbones.py, forecasters.py)
against the JAX package's, on the CPU, at the same weights (the port's
draw carried to flax by `to_jax_params`, whose tree has every leaf and
shape of the flax init's and loads back leaf for leaf through
`load_jax_variables`), on the same numpy-seeded inputs (d_model 16, d_ff
32, 2 heads, 2 layers, T 32):

- the classification backbones (with a padding mask that zeroes the last
  steps), the imputation / anomaly heads of `make_dense_task` and the five
  forecasters (and FEDformer's multiwavelet variant), each with time
  marks where it reads them: outputs within 1e-4 (FFT paths) in f32, and
  f32 gradients within 1e-4 of each leaf's largest (floored at 1e-2 of the
  model's largest: biases in front of a softmax or a decomposition have a
  zero gradient up to rounding);
- one InterpGN step with each family as the deep expert against
  `sie_tpu.train.trainer.Trainer` from the same weights: the loss within
  1e-5, the gradients as above, Pyraformer's moved batch_stats within
  1e-5;
- the parameters with an exactly zero gradient in the JAX package's
  InterpGN loss are chip_smoke.py's UNREAD table, the only ones its card
  run lets stand still;
- `python -m sie_tpu_torch.run --dnn_type FEDformer --task_name
  long_term_forecast --device cpu` trains an epoch and writes its pickle.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.models.extra import backbones as jb
from sie_tpu.models.extra import forecasters as jfc
from sie_tpu.models.extra import multiwavelet as jm
from sie_tpu.models.registry import DNN_REGISTRY
from sie_tpu.train.trainer import Trainer as JTrainer
from sie_tpu_torch import run as port_run
from sie_tpu_torch.compat.from_jax import (_flatten, _target,
                                           batch_stats_buffers,
                                           load_jax_variables, to_jax_params,
                                           to_jax_tree)
from sie_tpu_torch.config import Config
from sie_tpu_torch.data.synthetic import write_synthetic_ett
from sie_tpu_torch.models.extra import backbones as pb
from sie_tpu_torch.models.extra import forecasters as pfc
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.train.tasks import build_task_model
from sie_tpu_torch.train.trainer import Trainer

# the JAX package caches its multiwavelet filter banks as jnp constants;
# made first inside a jit trace, the cache would hold a tracer
jm._bank.cache_clear()
jm._bank("legendre", 4)

FAMILIES = ["Autoformer", "FEDformer", "ETSformer", "Pyraformer",
            "Crossformer"]
FFT, GRAD = 1e-4, 1e-4
B, T, C, MARKS = 2, 32, 3, 4
KW = dict(seq_len=T, label_len=8, pred_len=8, enc_in=C, dec_in=C, c_out=C,
          num_class=4, d_model=16, d_ff=32, n_heads=2, e_layers=2,
          d_layers=1, moving_avg=5, factor=1, top_k=2, dropout=0.0,
          amp=False, freq="h", seed=0)


def _np(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _flax_variables(port, jmod=None, *jargs):
    """The port's own initial draw as flax variables (`to_jax_params`, and
    the BatchNorm buffers as batch_stats): both packages run the same
    weights without compiling a flax init (seconds here). With `jmod`, the
    tree must have the leaves and shapes of jmod's init (traced by
    eval_shape), and load back into the port leaf for leaf."""
    v = {"params": to_jax_params(port)}
    stats = batch_stats_buffers(port)
    if stats:
        v["batch_stats"] = to_jax_tree(port, stats)
    if jmod is not None:
        want = jax.eval_shape(jmod.init, {"params": jax.random.key(1),
                                          "dropout": jax.random.key(2)},
                              *jargs)
        shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), dict(t))
        assert shapes(want) == shapes(v)
        load_jax_variables(port, v)
    return v


def _check(jmod, port, args, seed=11):
    """Forward (eval) and f32 gradients of both at the same weights."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    pargs = [None if a is None else torch.from_numpy(a) for a in args]
    port.eval()
    v = _flax_variables(port, jmod, *jargs)
    fwd = lambda p: jmod.apply({**v, "params": p}, *jargs)
    w = _np(seed, *jax.eval_shape(fwd, v["params"]).shape)
    (_, want), jg = jax.jit(jax.value_and_grad(
        lambda p: (jnp.sum(fwd(p) * w), fwd(p)), has_aux=True))(v["params"])
    got = port(*pargs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FFT, rtol=0)
    (got * torch.from_numpy(w)).sum().backward()
    _grads_close(port, jax.tree.map(np.asarray, jg))


def _grads_close(port, jgrads):
    want = dict(_target(port, p, g) for p, g in _flatten(jgrads).items())
    params = dict(port.named_parameters())
    assert set(params) == set(want)
    top = max(float(np.abs(g).max()) for g in want.values())
    for name, p in params.items():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        tol = GRAD * max(float(np.abs(want[name]).max()), 1e-2 * top)
        np.testing.assert_allclose(got.numpy(), want[name], atol=tol,
                                   rtol=0, err_msg=name)


G = lambda: torch.Generator().manual_seed(0)


@pytest.mark.parametrize("family", FAMILIES)
def test_backbone_matches_jax(family):
    cfg = dict(KW, dnn_type=family)
    mask = np.ones((B, T), np.float32)
    mask[1, -5:] = 0.0
    _check(DNN_REGISTRY[family](JConfig(**cfg)),
           pb.BACKBONES[family](Config(**cfg), G()), (_np(0, B, T, C), mask))


@pytest.mark.parametrize("family", FAMILIES)
def test_dense_task_matches_jax(family):
    cfg = dict(KW, dnn_type=family)
    _check(jb.make_dense_task(family)(JConfig(**cfg)),
           build_task_model(Config(**cfg), "imputation", G(), marks=MARKS),
           (_np(1, B, T, C),))


FORECASTERS = FAMILIES + ["FEDformer-wavelet"]


@pytest.mark.parametrize("family", FORECASTERS)
def test_forecaster_matches_jax(family):
    name, _, attention = family.partition("-")
    cfg = dict(KW, dnn_type=name)
    if attention:
        jmod = jfc.AutoformerForecaster(JConfig(**cfg), attention=attention)
        port = pfc.AutoformerForecaster(Config(**cfg), G(), MARKS,
                                        attention=attention)
    else:
        from sie_tpu.train.tasks import build_task_model as jax_build
        jmod = jax_build(JConfig(**cfg), "forecast")
        port = build_task_model(Config(**cfg), "forecast", G(), marks=MARKS)
    dec = np.concatenate([_np(3, B, 8, C), np.zeros((B, 8, C), np.float32)],
                         1)
    _check(jmod, port, (_np(2, B, T, C), _np(4, B, T, MARKS), dec,
                        _np(5, B, 16, MARKS)))


def _batch(seed=0, b=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, T, C)).astype(np.float32),
            rng.integers(0, 4, b).astype(np.int32),
            np.ones((b, T), np.float32), np.ones((b,), np.float32))


@pytest.mark.parametrize("family", FAMILIES)
def test_interpgn_step_matches_the_jax_trainer(family):
    kw = dict(KW, model="InterpGN", dnn_type=family, num_shapelet=2,
              lr=5e-3, use_pallas=False)
    batch = _batch()
    model = build_model(Config(**kw), "cpu")
    v = _flax_variables(model)
    jt = JTrainer(JConfig(**kw), steps_per_epoch=1)
    grad_fn = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True),
                      static_argnums=(4,))
    (jloss, (_, _, jstats)), jgrads = grad_fn(
        v["params"], v.get("batch_stats", {}), tuple(map(jnp.asarray, batch)),
        jnp.float32(1.0), True, jax.random.key(0))
    trainer = Trainer(Config(**kw), steps_per_epoch=1, model=model,
                      device="cpu")
    loss, _ = trainer.train_step(batch, 1.0)
    assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
    _grads_close(model, jax.tree.map(np.asarray, jgrads))
    if family == "Pyraformer":
        moved = to_jax_tree(model, batch_stats_buffers(model))
        assert jax.tree.structure(moved) == jax.tree.structure(
            dict(jstats))
        for a, b in zip(jax.tree.leaves(moved), jax.tree.leaves(jstats)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_the_card_exempts_only_what_the_jax_loss_leaves_unread(family):
    """chip_smoke.py's UNREAD table (the parameters its captured InterpGN
    steps may leave unmoved on the card) is the set of leaves whose
    gradient is exactly zero in the JAX package's training loss, at that
    script's configuration cut to narrow widths (2 layers as there)."""
    import dataclasses
    import chip_smoke
    cfg = chip_smoke.extra_config(family).replace(
        seq_len=T, enc_in=C, c_out=C, d_model=16, d_ff=32, n_heads=2,
        num_shapelet=2, dropout=0.0, amp=False)
    jfields = {f.name for f in dataclasses.fields(JConfig)}
    jcfg = JConfig(use_pallas=False, **{
        k: v for k, v in dataclasses.asdict(cfg).items()
        if k in jfields and k != "use_pallas"})
    model = build_model(cfg, "cpu", G())
    v = _flax_variables(model)
    jt = JTrainer(jcfg, steps_per_epoch=1)
    grads = jax.jit(jax.grad(lambda p: jt.loss_fn(
        p, v.get("batch_stats", {}), tuple(map(jnp.asarray, _batch())),
        jnp.float32(1.0), True, jax.random.key(0))[0]))(v["params"])
    zero = {_target(model, p, g)[0]
            for p, g in _flatten(jax.tree.map(np.asarray, grads)).items()
            if not np.any(g)}
    assert zero == chip_smoke.UNREAD[family]
    assert zero <= {n for n, _ in model.named_parameters()}

def test_cli_forecasts_with_fedformer(tmp_path, capsys):
    write_synthetic_ett(str(tmp_path / "ett.csv"), n_rows=240, seed=2)
    out = port_run.main([
        "--device", "cpu", "--model", "DNN", "--dnn_type", "FEDformer",
        "--task_name", "long_term_forecast", "--data", "custom",
        "--data_root", str(tmp_path), "--dataset", "ett", "--seq_len", "24",
        "--label_len", "8", "--pred_len", "8", "--d_model", "16",
        "--d_ff", "32", "--n_heads", "2", "--e_layers", "1",
        "--d_layers", "1", "--batch_size", "16", "--train_epochs", "1",
        "--seed", "0", "--result_dir", str(tmp_path / "result")])
    assert "[long_term_forecast] test:" in capsys.readouterr().out
    with open(os.path.join(tmp_path, "result", "DNN",
                           "long_term_forecast_seed0.pkl"), "rb") as f:
        saved = pickle.load(f)
    assert saved["metrics"] == out[0][2]
    assert all(np.isfinite(v) for v in saved["metrics"].values())
