"""`train_state.msgpack`, the full-state snapshot, read and written by
both packages (sie_tpu_torch/train/trainer.py `state_tree`,
`opt_state_tree`, train/checkpoint.py, and sie_tpu/train/checkpoint.py),
on the CPU, for the three layouts of optax's state that
`sie_tpu.train.trainer.make_optimizer` gives:

- gradient_clip 0, a constant learning rate:
  {"0": {"0": {count, mu, nu}, "1": {}}};
- gradient_clip > 0 and lr_decay:
  {"0": {}, "1": {"0": {count, mu, nu}, "1": {count}}};
- gradient accumulation (3 micro-steps, clip and decay as above):
  {mini_step, gradient_step, inner_opt_state, acc_grads, skip_state},
  the snapshot taken inside a group (mini_step 2).

InterpGN + Transformer at seq_len 24, d_model 16, f32, dropout 0, 4 steps
of a batch of 8. In each layout:
- the JAX Trainer takes 2 steps and writes the snapshot; the port loads
  it (into other initial weights) and takes 2 more: losses and
  parameters within tests/test_torch_port_mesh_dist.py's limits of the
  JAX Trainer's 4 steps (losses rtol 1e-5, atol 1e-6; parameters whose
  gradient is >= 1e-4 at every update, under accumulation the group's
  mean gradient, rtol 1e-5, atol 1e-6; every parameter within 2.1 lr a
  step), and the step, count and mini_step carried over;
- the port takes 2 steps and writes the snapshot (the JAX tree plus the
  generators under "rng"); the JAX package's `load_train_state` reads
  it and the JAX Trainer takes 2 more, with the same limits;
- the port's own resume equals its uninterrupted run bit for bit;
- `Experiment.train(resume=True)` in the port resumes from a directory
  the JAX package wrote (snapshot after epoch 1 and best checkpoint) and
  trains epoch 2 as the port's uninterrupted experiment does (train and
  validation losses within 1e-4, as tests/test_torch_port_experiment.py
  holds the two packages' experiments).
A snapshot of another optimizer layout raises ValueError.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.train import checkpoint as jckpt
from sie_tpu.train.trainer import Trainer as JTrainer
from sie_tpu_torch.compat import flax_msgpack
from sie_tpu_torch.compat.from_jax import (_flatten, load_jax_params,
                                           to_jax_variables)
from sie_tpu_torch.config import Config
from sie_tpu_torch.data.synthetic import write_synthetic_uea
from sie_tpu_torch.train import checkpoint as pckpt
from sie_tpu_torch.train.experiment import Experiment
from sie_tpu_torch.train.trainer import Trainer, read_opt_state

BASE = dict(model="InterpGN", dnn_type="Transformer", seq_len=24, enc_in=3,
            num_class=3, num_shapelet=2, d_model=16, d_ff=32, n_heads=2,
            e_layers=1, dropout=0.0, amp=False, use_pallas=False,
            fused_attention_min_len=0, lr=5e-3, seed=0, batch_size=8,
            train_epochs=4)
LAYOUTS = {"clip0_constant": dict(gradient_clip=0.0),
           "clip_decay": dict(gradient_clip=0.05, lr_decay=True),
           "accum3": dict(gradient_clip=0.05, lr_decay=True,
                          gradient_accumulation_steps=3)}
STEPS, HALF, PER_EPOCH, BETA = 4, 2, 2, 1.0


def _batches(kw):
    rng = np.random.default_rng(3)
    t, c = kw["seq_len"], kw["enc_in"]
    out = []
    for _ in range(STEPS):
        y = rng.integers(0, kw["num_class"], 8).astype(np.int32)
        x = (rng.normal(size=(8, t, c)) + 0.7 * y[:, None, None]
             ).astype(np.float32)
        mask = np.ones((8, t), np.float32)
        mask[::3, (2 * t) // 3:] = 0.0
        out.append((x, y, mask, np.ones(8, np.float32)))
    return out


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in _flatten(tree).items()}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def case(request, tmp_path_factory):
    """The JAX Trainer's 4 steps (losses, the state after 2 and 4, each
    step's gradient) and the config."""
    kw = dict(BASE, **LAYOUTS[request.param])
    batches = _batches(kw)
    jt = JTrainer(JConfig(**kw), steps_per_epoch=PER_EPOCH)
    state = jt.init_state(batches[0], seed=0)
    init = jax.tree.map(np.asarray, state.params)
    grad_fn = jax.jit(jax.grad(lambda p, s, b: jt.loss_fn(
        p, s, b, jnp.float32(BETA), True, jax.random.key(0))[0]))
    losses, grads = [], []
    for k, b in enumerate(batches):
        grads.append(_flat(grad_fn(state.params, state.batch_stats,
                                   tuple(jnp.asarray(a) for a in b))))
        state, loss, _ = jt.train_step(state, b, BETA)
        losses.append(float(loss))
        if k == HALF - 1:         # host copies: a step donates its state
            half = jax.device_get(state)
    return dict(name=request.param, kw=kw, batches=batches, jt=jt,
                init=init, losses=losses, half=half,
                final=jax.device_get(state),
                grads=grads, tmp=tmp_path_factory.mktemp(request.param))


def _port_trainer(case, seed=0):
    cfg = Config(**case["kw"])
    tr = Trainer(cfg, PER_EPOCH, device="cpu",
                 generator=torch.Generator().manual_seed(seed))
    if seed == 0:
        load_jax_params(tr.model, case["init"])
    return tr


def _assert_like_jax(case, losses, params):
    """The last 2 steps' losses and the parameters after 4 steps against
    the JAX Trainer's uninterrupted run (module docstring's limits)."""
    np.testing.assert_allclose(losses, case["losses"][HALF:], rtol=1e-5,
                               atol=1e-6)
    want = _flat(jax.tree.map(np.asarray, case["final"].params))
    assert set(params) == set(want)
    lr = case["kw"]["lr"]
    # the gradients Adam sees: each step's, or each whole accumulation
    # group's mean (a mean near 0 moves by Adam's eps along its rounding)
    k = case["kw"].get("gradient_accumulation_steps", 1)
    seen = [{key: np.mean([g[key] for g in case["grads"][i:i + k]], axis=0)
             for key in want} for i in range(0, STEPS - k + 1, k)]
    for key, a in params.items():
        sure = np.all([np.abs(g[key]) >= 1e-4 for g in seen], axis=0)
        np.testing.assert_allclose(a[sure], want[key][sure], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
        assert np.abs(a - want[key]).max() <= STEPS * 2.1 * lr, key


def test_a_jax_snapshot_resumes_in_the_port(case):
    d = str(case["tmp"] / "jax_written")
    early = {"best_score": -0.5, "counter": 1, "has_best": True}
    jckpt.save_train_state(d, case["half"], 1, early)
    tr = _port_trainer(case, seed=5)     # every value from the file
    epoch, got_early = pckpt.load_train_state(d, tr)
    assert epoch == 1 and got_early == early
    half = case["half"]
    opt = tr.optimizer
    assert tr.step == int(half.step) == HALF
    accum = case["kw"].get("gradient_accumulation_steps", 1)
    assert (opt.count, opt.mini_step) == (HALF // accum, HALF % accum)
    losses = [float(tr.train_step(b, BETA)[0])
              for b in case["batches"][HALF:]]
    _assert_like_jax(case, losses, _flat(to_jax_variables(tr.model)[
        "params"]))


def test_a_port_snapshot_resumes_in_the_jax_package(case):
    d = str(case["tmp"] / "port_written")
    tr = _port_trainer(case)
    for b in case["batches"][:HALF]:
        tr.train_step(b, BETA)
    pckpt.save_train_state(d, tr, 1, {"best_score": -0.25, "counter": 0,
                                      "has_best": True})
    with open(os.path.join(d, pckpt.FULL_STATE_NAME), "rb") as f:
        raw = flax_msgpack.from_bytes(f.read())
    assert set(raw) == {"step", "params", "batch_stats", "opt_state",
                        "epoch", "early", "rng"}
    jt = case["jt"]
    template = jt.init_state(case["batches"][0], seed=1)
    state, epoch, early = jckpt.load_train_state(d, template)
    assert epoch == 1 and early["counter"] == 0
    losses = []
    for b in case["batches"][HALF:]:
        state, loss, _ = jt.train_step(state, b, BETA)
        losses.append(float(loss))
    _assert_like_jax(case, losses, _flat(jax.tree.map(np.asarray,
                                                      state.params)))
    # the optax state tree matches the JAX package's, leaf for leaf
    want = jax.tree.structure(case["half"].opt_state)
    assert jax.tree.structure(state.opt_state) == want


def test_the_port_resumes_its_own_snapshot_bit_for_bit(case):
    d = str(case["tmp"] / "port_own")
    a = _port_trainer(case)
    for b in case["batches"][:HALF]:
        a.train_step(b, BETA)
    pckpt.save_train_state(d, a, 1, {"counter": 0})
    want = [a.train_step(b, BETA)[0] for b in case["batches"][HALF:]]
    b_tr = _port_trainer(case, seed=7)
    pckpt.load_train_state(d, b_tr)
    got = [b_tr.train_step(b, BETA)[0] for b in case["batches"][HALF:]]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for (n, p), q in zip(a.model.named_parameters(),
                         b_tr.model.parameters()):
        assert torch.equal(p, q), n
    assert (b_tr.step, b_tr.optimizer.count, b_tr.optimizer.mini_step) == \
        (a.step, a.optimizer.count, a.optimizer.mini_step)
    assert torch.equal(b_tr.generator.get_state(), a.generator.get_state())


def test_experiment_resumes_from_a_jax_written_directory(case):
    root = case["tmp"] / "exp"
    write_synthetic_uea(str(root), "Toy", n_train=24, n_test=12, n_dims=3,
                        length=24, n_classes=3, seed=9)
    kw = dict(case["kw"], data="UEA", data_root=str(root), dataset="Toy",
              train_epochs=2, patience=5, log_interval=1,
              cache_dir=str(root / "cache"), result_dir=str(root / "res"))
    recs = {}
    exps = {}
    for tag in ("whole", "resumed"):
        recs[tag] = []
        exps[tag] = Experiment(Config(**kw, checkpoint_dir=str(root / tag)),
                               verbose=False, metrics_hook=recs[tag].append,
                               device="cpu")
        load_jax_params(exps[tag].trainer.model, case["init"])
    exps["whole"].train()
    # the JAX package trains epoch 1 on the same batches and writes the
    # directory: its best checkpoint and the snapshot after epoch 1
    res = exps["resumed"]
    jt = JTrainer(JConfig(**kw), steps_per_epoch=len(res.train_loader))
    params = jax.tree.map(jnp.asarray, case["init"])
    state = jt.init_state(next(res.train_loader.epoch(0)), seed=0).replace(
        params=params, opt_state=jt.tx.init(params))
    beta = recs["whole"][0]["beta"]
    for b in res.train_loader.epoch(0):
        state, _loss, _ = jt.train_step(state, b, beta)
    jckpt.save_checkpoint(res.checkpoint_dir, jax.device_get(state.params),
                          jax.device_get(state.batch_stats),
                          meta={"epoch_stop": 0, "val_accuracy": 0.0})
    jckpt.save_train_state(res.checkpoint_dir, state, 1,
                           {"best_score": 0.0, "counter": 0,
                            "has_best": True})
    res.train(resume=True)
    assert [r["epoch"] for r in recs["resumed"]] == [1]
    got, want = recs["resumed"][0], recs["whole"][1]
    assert got["train_loss"] == pytest.approx(want["train_loss"], abs=1e-4)
    assert got["val_loss"] == pytest.approx(want["val_loss"], abs=1e-4)
    assert res.trainer.step == exps["whole"].trainer.step


def test_another_optimizer_layout_raises(case):
    tr = _port_trainer(case)
    tree = tr.state_tree()
    other = dict(case["kw"], gradient_accumulation_steps=1 if case[
        "kw"].get("gradient_accumulation_steps", 1) > 1 else 2)
    with pytest.raises(ValueError, match="opt_state"):
        read_opt_state(Config(**other), tree["opt_state"])
