"""The port's multi-seed ensemble (train/ensemble.py, train/ensemble_driver.py,
scripts/port_uea_ensemble_sweep.py) against the JAX package's, on the CPU.

- From the JAX `EnsembleTrainer.init_states` weights (slice i into seed
  i), 6 steps of both ensembles over the same per-seed batches (f32,
  dropout 0, lr 1e-2), for the SBM of tests/test_ensemble.py, InterpGN +
  FCN (BatchNorm) and a narrow InterpGN + Transformer: every seed's loss
  at every step within 1e-5, and the SBM's parameters within 1e-5 after
  the 6 steps (7.7e-7 seen). The InterpGN parameters are held to Adam's
  limits of tests/test_torch_port_bn_experiment.py: a parameter whose
  gradient is 0 in exact arithmetic (the FCN's conv biases in front of a
  BatchNorm, the attention's key bias, which the softmax cancels) moves
  by ~lr a step along rounding noise that differs between the packages
  (Adam's second moment ~1e-20), so within 2 x lr a step; every other
  one within 2.1 x lr (Adam's step), since that noise, and near-ties of
  the SBM's window argmin, reach gradients that Adam then scales up
  where they are small (worst seen 4.1e-3, the FCN's conv2 weight, at an
  element with sqrt(nu) 5e-6 against a median 1.2e-4; 1.7e-5 on the
  Transformer model's shapelets).
- Seed i of the port's ensemble equals a lone port `Trainer` at seed i,
  bit for bit (`torch.equal`), at dropout 0.1, also under gradient
  accumulation.
- `alive`: a stopped seed's parameters, Adam moments, counts, the
  accumulation mean and BatchNorm buffers stay as they were, and its
  optimizer count and micro-batch position read as the JAX package's
  frozen optax state (`MultiSteps` at accumulation 2); live seeds go on
  matching JAX.
- `eval_step`: (N, B, C) logits within 1e-5 of JAX's, one result per
  gating value.
- `run_ensemble_experiment` at the sizes of tests/test_ensemble.py's
  driver test (4 classes and patience 2, so that a seed stops early and
  the accuracies differ between seeds), from the JAX initial weights:
  per-seed accuracy, val_accuracy and epoch_stop equal to the JAX
  driver's.
- The sweep script skips a missing archive and summarises the others.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.train.ensemble import EnsembleTrainer as JEnsemble
from sie_tpu_torch.compat.from_jax import (ParamLoadError,
                                           load_jax_seed_variables,
                                           port_layout, to_jax_variables)
from sie_tpu_torch.config import Config
from sie_tpu_torch.data.synthetic import write_synthetic_uea
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.train.ensemble import EnsembleTrainer, stack_seed_batches
from sie_tpu_torch.train.trainer import Trainer, read_opt_state

SEEDS = (0, 42, 7)
TOL = 1e-5
COMMON = dict(data="UEA", seq_len=20, enc_in=3, num_class=2, batch_size=6,
              dropout=0.0, amp=False, use_pallas=False, lr=1e-2, seed=0)
MODELS = {
    "sbm": dict(COMMON, model="SBM", num_shapelet=2),
    "interpgn_fcn": dict(COMMON, model="InterpGN", dnn_type="FCN",
                         num_shapelet=2),
    "interpgn_transformer": dict(COMMON, model="InterpGN",
                                 dnn_type="Transformer", num_shapelet=2,
                                 d_model=16, d_ff=32, n_heads=2, e_layers=1,
                                 fused_attention_min_len=0),
}
N_ROWS, N_STEPS = 24, 6


def _data(kw):
    rng = np.random.default_rng(3)
    y = rng.integers(0, kw["num_class"], N_ROWS).astype(np.int32)
    x = (rng.normal(size=(N_ROWS, kw["seq_len"], kw["enc_in"]))
         + 1.5 * y[:, None, None]).astype(np.float32)
    return x, y, np.ones((N_ROWS, kw["seq_len"]), np.float32)


def _schedules(b, steps=N_STEPS):
    """Per-seed schedules, as tests/test_ensemble.py draws them."""
    out = {}
    for s in SEEDS:
        rng = np.random.default_rng(s + 100)
        out[s] = [(rng.choice(N_ROWS, b, replace=False),
                   np.ones(b, np.float32)) for _ in range(steps)]
    return out


def _zero_gradient(name):
    """A parameter whose gradient is 0 in exact arithmetic."""
    return ((name.startswith("deep_model.conv") and name.endswith(".bias"))
            or name.endswith("attention.key.bias"))


def _both(kw, seeds=SEEDS):
    """The JAX ensemble at its init_states, and the port's from the same
    weights."""
    x, y, mask = _data(kw)
    b = kw["batch_size"]
    je = JEnsemble(JConfig(**kw), steps_per_epoch=N_STEPS, seeds=seeds)
    states = je.init_states((x[:b], y[:b], mask[:b], np.ones(b, np.float32)))
    pe = EnsembleTrainer(Config(**kw), N_STEPS, seeds, device="cpu")
    pe.init_states((x[:b], y[:b], mask[:b], None), variables={
        "params": jax.tree.map(np.asarray, states.params),
        "batch_stats": jax.tree.map(np.asarray, states.batch_stats)})
    return je, states, pe, (x, y, mask)


def _seed_params(states, i):
    return jax.tree.map(lambda a: np.asarray(a)[i], states.params)


def _assert_params_close(pe, states, steps, lr):
    for i in range(len(pe.seeds)):
        model = pe.trainers[i].model
        want = port_layout(model, _seed_params(states, i))
        for name, p in model.named_parameters():
            if pe.cfg.model == "SBM":
                limit = TOL
            else:
                limit = 2 * steps * lr if _zero_gradient(name) else 2.1 * lr
            gap = np.abs(p.detach().numpy() - want[name]).max()
            assert gap <= limit, (pe.seeds[i], name, gap)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_steps_match_the_jax_ensemble(name):
    kw = MODELS[name]
    je, states, pe, (x, y, mask) = _both(kw)
    sched = _schedules(kw["batch_size"])
    for k in range(N_STEPS):
        batches = stack_seed_batches([sched[s][k] for s in SEEDS], x, y,
                                     mask)
        states, jloss, jlogits = je.train_step(states, batches, beta=1.0)
        loss, logits = pe.train_step(batches, 1.0)
        assert loss.shape == (len(SEEDS),)
        assert logits.shape == (len(SEEDS), kw["batch_size"],
                                kw["num_class"])
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss),
                                   atol=TOL, rtol=0, err_msg=str(k))
    _assert_params_close(pe, states, N_STEPS, kw["lr"])
    if name == "interpgn_fcn":
        want = jax.tree.map(lambda a: np.asarray(a)[1], states.batch_stats)
        got = to_jax_variables(pe.trainers[1].model)["batch_stats"]
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert np.abs(a - b).max() <= 2 * N_STEPS * kw["lr"]


ACCUM = {"plain": {}, "accum2": dict(gradient_accumulation_steps=2,
                                     gradient_clip=0.5)}


@pytest.mark.parametrize("opt", sorted(ACCUM))
def test_each_seed_equals_a_lone_trainer_bit_for_bit(opt):
    kw = dict(MODELS["interpgn_transformer"], dropout=0.1, **ACCUM[opt])
    cfg = Config(**kw)
    x, y, mask = _data(kw)
    b = kw["batch_size"]
    sched = _schedules(b)
    pe = EnsembleTrainer(cfg, N_STEPS, SEEDS, device="cpu")
    dev = pe.device_data("train", type("Rows", (), dict(
        x=x, y=y, padding_mask=mask))())
    staged = pe.stage_steps([sched[s] for s in SEEDS], 0.5)
    losses = [pe.train_step_staged(dev, staged, k)[0]
              for k in range(N_STEPS)]
    for i, s in enumerate(SEEDS):
        lone = Trainer(cfg.replace(seed=s), N_STEPS, device="cpu",
                       generator=torch.Generator().manual_seed(s))
        for k, (idx, w) in enumerate(sched[s]):
            loss, _ = lone.train_step((x[idx], y[idx], mask[idx], w), 0.5)
            assert torch.equal(loss, losses[k][i]), (s, k)
        for (name, p), q in zip(lone.model.named_parameters(),
                                pe.trainers[i].model.parameters()):
            assert torch.equal(p, q), (s, name)
        opt_a, opt_b = lone.optimizer, pe.trainers[i].optimizer
        assert (opt_a.count, opt_a.mini_step) == (opt_b.count, opt_b.mini_step)
        for p, q in zip(opt_a.params, opt_b.params):
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt_a.adam.state[p][key],
                                   opt_b.adam.state[q][key])


def _opt_fields(tree, out=None):
    """The first `count`, `mini_step`, `mu` and `nu` of an optax state,
    searched depth first."""
    out = {} if out is None else out
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            if f in ("count", "mini_step", "mu", "nu") and f not in out:
                out[f] = getattr(tree, f)
            else:
                _opt_fields(getattr(tree, f), out)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _opt_fields(t, out)
    return out


def _moved_state(trainer):
    opt = trainer.optimizer
    return ([p.detach().clone() for p in opt.params]
            + [opt.adam.state[p][k].clone() for p in opt.params
               for k in ("exp_avg", "exp_avg_sq", "step")]
            + [opt.count_t.clone()] + [a.clone() for a in opt._acc or []]
            + [b.clone() for b in trainer.model.buffers()])


@pytest.mark.parametrize("opt", sorted(ACCUM))
def test_alive_freezes_a_stopped_seed_as_jax_does(opt):
    kw = dict(MODELS["interpgn_fcn"], **ACCUM[opt])
    je, states, pe, (x, y, mask) = _both(kw)
    sched = _schedules(kw["batch_size"])
    alive = np.ones(len(SEEDS), np.float32)
    for k in range(N_STEPS):
        if k == 3:
            alive[1] = 0.0
            frozen = _moved_state(pe.trainers[1])
            others = [_moved_state(pe.trainers[i]) for i in (0, 2)]
            host = (pe.trainers[1].optimizer.count,
                    pe.trainers[1].optimizer.mini_step)
        batches = stack_seed_batches([sched[s][k] for s in SEEDS], x, y,
                                     mask)
        states, jloss, _ = je.train_step(states, batches, 1.0, alive=alive)
        loss, _ = pe.train_step(batches, 1.0, alive=alive)
        live = alive > 0
        np.testing.assert_allclose(loss.numpy()[live],
                                   np.asarray(jloss)[live], atol=TOL, rtol=0)
    after = _moved_state(pe.trainers[1])
    assert all(torch.equal(a, b) for a, b in zip(frozen, after))
    opt1 = pe.trainers[1].optimizer
    assert (opt1.count, opt1.mini_step) == host
    jopt = _opt_fields(states.opt_state)
    counts = [pe.trainers[i].optimizer.count for i in range(len(SEEDS))]
    assert counts == np.asarray(jopt["count"]).tolist()
    if "mini_step" in jopt:
        assert [pe.trainers[i].optimizer.mini_step
                for i in range(len(SEEDS))] == \
            np.asarray(jopt["mini_step"]).tolist() == [0, 1, 0]
        assert counts == [3, 1, 3]
    assert [t.step for t in pe.trainers] == \
        np.asarray(states.step).tolist() == [N_STEPS] * len(SEEDS)
    # the frozen seed against JAX's frozen one, the live ones as they move
    _assert_params_close(pe, states, N_STEPS, kw["lr"])
    tree = read_opt_state(pe.trainers[1].cfg,
                          pe.trainers[1].state_tree()["opt_state"])
    want_mu = jax.tree.map(lambda a: np.asarray(a)[1], jopt["mu"])
    for a, b in zip(jax.tree.leaves(tree["mu"]), jax.tree.leaves(want_mu)):
        assert np.abs(a - b).max() <= 2 * N_STEPS * kw["lr"]
    # the live seeds moved on after seed 1 stopped
    for i, before in zip((0, 2), others):
        assert not any(torch.equal(a, b) for a, b in zip(
            _moved_state(pe.trainers[i])[:3], before[:3]))


def test_a_stopped_seed_passes_a_nonfinite_update_on():
    """updates * alive, as in the JAX package: a frozen seed keeps its
    parameters while its update is finite, and a NaN update still reaches
    them (a select would hide it)."""
    kw = MODELS["sbm"]
    x, y, mask = _data(kw)
    pe = EnsembleTrainer(Config(**kw), N_STEPS, (0, 1), device="cpu")
    b = kw["batch_size"]
    batches = stack_seed_batches([(np.arange(b), np.ones(b, np.float32))] * 2,
                                 x, y, mask)
    pe.train_step(batches, 1.0)
    before = [p.detach().clone() for p in pe.trainers[0].model.parameters()]
    pe.train_step(batches, 1.0, alive=[0.0, 1.0])
    assert all(torch.equal(a, p) for a, p in
               zip(before, pe.trainers[0].model.parameters()))
    bad = tuple(a.copy() for a in batches)
    bad[0][0, 0, 0, 0] = np.nan
    pe.train_step(bad, 1.0)
    assert any(torch.isnan(p).any() for p in pe.trainers[0].model.parameters())
    assert all(torch.isfinite(p).all()
               for p in pe.trainers[1].model.parameters())


def test_eval_step_matches_jax_per_gating_value():
    kw = MODELS["interpgn_fcn"]
    je, states, pe, (x, y, mask) = _both(kw, seeds=(0, 1))
    batch = (x[:4], y[:4], mask[:4], np.ones(4, np.float32))
    out = {}
    for gv in (None, 0.0):
        jlogits, _ = je.eval_step(states, batch, gating_value=gv)
        logits, info = pe.eval_step(batch, gating_value=gv)
        assert logits.shape == (2, 4, kw["num_class"])
        assert info.shapelet_preds.shape == (2, 4, kw["num_class"])
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=TOL, rtol=0)
        by_idx, _ = pe.eval_step_indexed(pe.device_data("rows", type(
            "Rows", (), dict(x=x, y=y, padding_mask=mask))()),
            np.arange(4), gv)
        assert torch.equal(by_idx, logits)
        out[gv] = logits
    assert (out[None] - out[0.0]).abs().max() > 1e-6


def test_seed_variables_load_every_leaf_once():
    kw = MODELS["interpgn_fcn"]
    je, states, pe, _ = _both(kw, seeds=(0, 1))
    stacked = {"params": jax.tree.map(np.asarray, states.params),
               "batch_stats": jax.tree.map(np.asarray, states.batch_stats)}
    models = [build_model(Config(**kw), "cpu",
                          torch.Generator().manual_seed(9)) for _ in range(2)]
    load_jax_seed_variables(models, stacked)
    for i, m in enumerate(models):
        got = to_jax_variables(m)
        for part in ("params", "batch_stats"):
            want = jax.tree.map(lambda a: np.asarray(a)[i], stacked[part])
            assert jax.tree.structure(got[part]) == \
                jax.tree.structure(want)
            for a, b in zip(jax.tree.leaves(got[part]),
                            jax.tree.leaves(want)):
                assert np.array_equal(a, b)
    with pytest.raises(ParamLoadError):
        load_jax_seed_variables(models + models[:1], stacked)
    extra = dict(stacked, params=dict(stacked["params"],
                                      stray=np.zeros((2, 3), np.float32)))
    with pytest.raises(ParamLoadError):
        load_jax_seed_variables(models, extra)


DRIVER = dict(data="UEA", dataset="Toy", model="InterpGN", dnn_type="FCN",
              num_shapelet=2, batch_size=8, train_epochs=8, patience=2,
              min_epochs=0, dropout=0.0, amp=False, use_pallas=False,
              lr=5e-3, log_interval=100, seed=0)


def test_driver_matches_the_jax_driver(tmp_path):
    from sie_tpu.data.provider import data_provider as jdata
    from sie_tpu.train.ensemble_driver import \
        run_ensemble_experiment as jrun
    from sie_tpu_torch.train.ensemble_driver import run_ensemble_experiment
    write_synthetic_uea(str(tmp_path), "Toy", n_train=32, n_test=16,
                        n_dims=2, length=24, n_classes=4, seed=5)
    kw = dict(DRIVER, data_root=str(tmp_path), cache_dir=str(tmp_path / "c"))
    seeds = (0, 42, 7)
    want = jrun(JConfig(**kw), seeds=seeds, verbose=False)
    # the JAX driver's initial weights: init_states at the data's shapes
    train, loader = jdata(JConfig(**kw), "train")
    jcfg = JConfig(**kw).replace(seq_len=train.seq_len, enc_in=train.enc_in,
                                 num_class=train.num_class)
    states = JEnsemble(jcfg, len(loader), seeds).init_states(
        next(iter(loader.epoch(0))))
    got = run_ensemble_experiment(
        Config(**kw), seeds=seeds, verbose=False, device="cpu",
        init_variables={
            "params": jax.tree.map(np.asarray, states.params),
            "batch_stats": jax.tree.map(np.asarray, states.batch_stats)})
    assert got == want
    assert any(r["epoch_stop"] < DRIVER["train_epochs"] - 1 for r in got)
    assert len({r["accuracy"] for r in got}) > 1


def test_sweep_skips_a_missing_archive(tmp_path, capsys):
    sweep = importlib.import_module("scripts.port_uea_ensemble_sweep")
    write_synthetic_uea(str(tmp_path), "Here", n_train=16, n_test=8,
                        n_dims=2, length=20, n_classes=2, seed=6)
    summary = sweep.main([
        "--device", "cpu", "--data", "UEA", "--data_root", str(tmp_path),
        "--datasets", "Here", "Missing",
        "--model", "SBM", "--num_shapelet", "2", "--batch_size", "8",
        "--train_epochs", "2", "--patience", "2", "--seed", "0",
        "--no-amp", "--no_pallas", "--cache_dir", str(tmp_path / "c")])
    assert set(summary) == {"Here"}
    text = capsys.readouterr().out
    assert "[Missing] SKIPPED" in text and "=== sweep summary ===" in text
