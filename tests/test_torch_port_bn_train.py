"""BatchNorm state through the port's trainer, checkpoint and Predictor,
against the JAX package, on the CPU.

- Train steps of InterpGN + FCN and of EEGCNN (f32, dropout 0) through
  both packages' `train_step_staged` from the same flax variables: losses
  within 1e-5; parameters after the first update within 1e-6 where |g| >=
  1e-6 and 2.1 x lr everywhere (the limits of
  tests/test_torch_port_train.py: Adam's first step is ~lr * sign(g), and
  a tiny g's sign may flip on summation order), within twice that after
  later ones; batch_stats within 1e-5 after the first step (statistics of
  the same weights), and after later ones within the parameters' limit
  (statistics of weights that differ by it).
- Every eval path leaves the buffers as they were; a train step moves
  them once per micro-step, also inside an accumulation group.
- `state_tree` carries the buffers: a trainer restored from the snapshot
  takes the next steps bit for bit.
- A `checkpoint.msgpack` of the port loads in the JAX package's
  `load_checkpoint` and gives the JAX model the port's eval logits (f32
  1e-4), and the reverse.
- `Predictor(cfg, variables)` against `sie_tpu.serve.Predictor` on the
  same variables with non-trivial batch_stats (f32 1e-4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.models import build_model as jax_build
from sie_tpu.serve import Predictor as JPredictor
from sie_tpu.train import checkpoint as jckpt
from sie_tpu.train.trainer import Trainer as JTrainer
from sie_tpu_torch.compat.from_jax import (batch_stats_buffers,
                                           load_jax_variables, port_layout,
                                           to_jax_variables)
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.serve import Predictor
from sie_tpu_torch.train import checkpoint as pckpt
from sie_tpu_torch.train.trainer import Trainer
from test_torch_port_backbones import _assert_stats, _stats_like

F32_TOL = 1e-4
COMMON = dict(num_class=3, dropout=0.0, amp=False, use_pallas=False,
              lr=5e-3, seed=0)
MODELS = {
    "interpgn_fcn": dict(COMMON, model="InterpGN", dnn_type="FCN",
                         seq_len=24, enc_in=3, num_shapelet=2),
    "eegcnn": dict(COMMON, model="EEGCNN", seq_len=60, enc_in=4,
                   eegcnn_cnn_f1=4, eegcnn_cnn_f2=2, eegcnn_kernel1=8,
                   eegcnn_kernel2=5, eegcnn_pool1=2, eegcnn_pool2=3,
                   eegcnn_n_heads=2, eegcnn_d_ff=16, d_model=16,
                   eegcnn_dropout1=0.0, eegcnn_dropout2=0.0),
}
ROWS, B, STEPS = 16, 4, 3


def _rows(kw, seed=0):
    rng = np.random.default_rng(seed)
    t = kw["seq_len"]
    mask = np.ones((ROWS, t), np.float32)
    mask[::3, (2 * t) // 3:] = 0.0    # padded tails on some rows
    return type("Rows", (), dict(
        x=(0.5 + rng.normal(size=(ROWS, t, kw["enc_in"]))).astype(np.float32),
        y=rng.integers(0, kw["num_class"], ROWS).astype(np.int32),
        padding_mask=mask))()


def _schedule(seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.permutation(ROWS)[:B], np.ones(B, np.float32))
            for _ in range(STEPS)]


def _jax_state(kw, ds, sched):
    jt = JTrainer(JConfig(**kw), steps_per_epoch=STEPS)
    i = sched[0][0]
    state = jt.init_state((ds.x[i], ds.y[i], ds.padding_mask[i],
                           sched[0][1]), seed=0)
    return jt, state


def _variables(state):
    return {"params": jax.tree.map(np.asarray, state.params),
            "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}


def _port_trainer(kw, variables=None, seed=3):
    cfg = Config(**kw)
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(seed))
    if variables is not None:
        load_jax_variables(model, variables)
    return Trainer(cfg, STEPS, model=model, device="cpu")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_steps_match_the_jax_trainer(name):
    kw = MODELS[name]
    ds, sched = _rows(kw), _schedule()
    jt, state = _jax_state(kw, ds, sched)
    t = _port_trainer(kw, _variables(state))
    dev, staged = t.device_data("train", ds), t.stage_steps(sched, 1.0)
    jdev, jstaged = jt.device_data("train", ds), jt.stage_steps(sched, 1.0)
    i, w = sched[0]
    grad_fn = jax.jit(jax.grad(lambda p, b: jt.loss_fn(
        p, state.batch_stats, b, jnp.float32(1.0), True,
        jax.random.key(0))[0]))
    g0 = port_layout(t.model, jax.tree.map(np.asarray, grad_fn(
        state.params, tuple(jnp.asarray(a) for a in (
            ds.x[i], ds.y[i], ds.padding_mask[i], w)))))
    lr = kw["lr"]
    for k in range(STEPS):
        loss, _ = t.train_step_staged(dev, staged, k)
        state, jloss, _ = jt.train_step_staged(state, jdev, jstaged, k)
        assert float(loss) == pytest.approx(float(jloss), abs=1e-5), k
        want = _variables(state)
        limit = min(k + 1, 2) * 2.1 * lr
        got_s = to_jax_variables(t.model)["batch_stats"]
        if k == 0:      # statistics of the same weights
            _assert_stats(got_s, want["batch_stats"])
        else:           # of weights that differ within the limit below
            for a, b in zip(jax.tree.leaves(got_s),
                            jax.tree.leaves(want["batch_stats"])):
                assert np.abs(a - b).max() <= limit, k
        want_p = port_layout(t.model, want["params"])
        for pname, p in t.model.named_parameters():
            diff = np.abs(p.detach().numpy() - want_p[pname])
            if k == 0:
                sure = np.abs(g0[pname]) >= 1e-6
                assert diff[sure].max(initial=0) <= 1e-6, pname
            assert diff.max() <= limit, (k, pname)
    assert batch_stats_buffers(t.model)


def _stats(model):
    return {k: v.clone() for k, v in batch_stats_buffers(model).items()}


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_paths_keep_and_train_steps_move_the_buffers(name):
    kw = dict(MODELS[name], gradient_accumulation_steps=2)
    ds, sched = _rows(kw), _schedule()
    t = _port_trainer(kw)
    dev, staged = t.device_data("train", ds), t.stage_steps(sched)
    before = _stats(t.model)
    i, w = sched[0]
    t.eval_step((ds.x[i], ds.y[i], ds.padding_mask[i], w))
    t.eval_step_staged(dev, staged, 1)
    t.eval_step_indexed(dev, i)
    t.eval_epoch_staged_scan(dev, staged, collect=True)
    assert _equal(before, _stats(t.model)) and t.model.training
    for k in range(2):     # one accumulation group: each micro-step moves
        t.train_step_staged(dev, staged, k)
        after = _stats(t.model)
        assert all(not torch.equal(before[n], after[n]) for n in before), k
        before = after
    assert t.optimizer.count == 1


@pytest.mark.parametrize("name", sorted(MODELS))
def test_state_tree_carries_the_buffers(tmp_path, name):
    kw = MODELS[name]
    ds, sched = _rows(kw), _schedule()
    a = _port_trainer(kw, seed=3)
    dev, staged = a.device_data("train", ds), a.stage_steps(sched, 1.0)
    a.train_step_staged(dev, staged, 0)
    pckpt.save_train_state(str(tmp_path), a, 1, {"counter": 0})
    tree = a.state_tree()
    assert tree["batch_stats"]
    _assert_stats(tree["batch_stats"], to_jax_variables(a.model)[
        "batch_stats"])
    want = [a.train_step_staged(dev, staged, k)[0] for k in (1, 2)]
    b = _port_trainer(kw, seed=4)   # other weights: all from the snapshot
    pckpt.load_train_state(str(tmp_path), b)
    dev_b, staged_b = b.device_data("train", ds), b.stage_steps(sched, 1.0)
    got = [b.train_step_staged(dev_b, staged_b, k)[0] for k in (1, 2)]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _equal(_stats(a.model), _stats(b.model))


def _nontrivial(kw):
    """(JAX model, flax variables with non-trivial batch_stats)."""
    jmodel = jax_build(JConfig(**kw))
    init = jax.jit(jmodel.init, static_argnames=("train",))
    variables = jax.tree.map(np.asarray, init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((2, kw["seq_len"], kw["enc_in"])),
        jnp.ones((2, kw["seq_len"])), train=False))
    variables["batch_stats"] = _stats_like(variables["batch_stats"],
                                           np.random.default_rng(5))
    return jmodel, variables


@pytest.mark.parametrize("name", sorted(MODELS))
def test_checkpoints_cross_both_ways(tmp_path, name):
    kw = MODELS[name]
    jmodel, variables = _nontrivial(kw)
    ds = _rows(kw, seed=6)
    apply = jax.jit(jmodel.apply, static_argnames=("train",))

    def jax_logits(v):
        return np.asarray(apply(v, jnp.asarray(ds.x),
                                jnp.asarray(ds.padding_mask), train=False)[0])

    def port_logits(model):
        with torch.inference_mode():
            return model.eval()(torch.from_numpy(ds.x),
                                torch.from_numpy(ds.padding_mask))[0].numpy()

    template = jax.tree.map(np.zeros_like, variables)
    # the port writes; the JAX package reads
    port = build_model(Config(**kw), "cpu", torch.Generator().manual_seed(7))
    port.train()(torch.from_numpy(ds.x))          # moved statistics
    v = to_jax_variables(port)
    pckpt.save_checkpoint(str(tmp_path / "p"), v["params"], v["batch_stats"])
    restored = jckpt.load_checkpoint(str(tmp_path / "p"), template)
    assert restored["batch_stats"]
    np.testing.assert_allclose(jax_logits(restored), port_logits(port),
                               atol=F32_TOL, rtol=0)
    # the JAX package writes; the port reads
    jckpt.save_checkpoint(str(tmp_path / "j"), variables["params"],
                          variables["batch_stats"])
    loaded = load_jax_variables(build_model(Config(**kw), "cpu"),
                                pckpt.load_checkpoint(str(tmp_path / "j")))
    np.testing.assert_allclose(port_logits(loaded), jax_logits(variables),
                               atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_predictor_matches_the_jax_predictor(name):
    kw = dict(MODELS[name], gating_value=0.5)
    _, variables = _nontrivial(kw)
    jp = JPredictor(JConfig(**kw), variables, max_batch=4)
    tp = Predictor(Config(**kw), variables, device="cpu", max_batch=4)
    x = _rows(kw, seed=8).x[:6]
    got, want = tp.predict(x), jp.predict(x)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert (g is None) == (w is None), f.name
        if g is None:
            continue
        if f.name == "classes":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=F32_TOL, err_msg=f.name)
    assert not tp.model.training
