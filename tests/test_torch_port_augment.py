"""On-device augmentation in the port against the JAX package, on the CPU.

The two packages draw from different generators (threefry keys folded per
step against a torch generator), so the arithmetic is held equal on the
same draws: the JAX function's draws (made here with
`jax.random.fold_in(key, i + 101)` at its shapes) go into the port's
`apply_augmentations`, and the result equals
`sie_tpu.data.augment.apply_augmentations` within 1e-6 (f32 sums over the
valid region in another order), with the padding exactly zero. The trainer
augments train steps and no eval path; with `augment=()` a step is the
plain loss bit for bit; the dropout generator draws the same with and
without augmentation (the augmentation has a generator of its own); the
staged step (eager on the CPU) equals the indexed step with augmentation
on, bit for bit; `python -m sie_tpu_torch.run --augment noise,tshift
--device cpu` trains, and an unknown name is refused."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.data import augment as jax_augment
from sie_tpu_torch import run as port_run
from sie_tpu_torch.config import Config
from sie_tpu_torch.data import augment
from sie_tpu_torch.data.synthetic import write_synthetic_uea
from sie_tpu_torch.train import trainer as trainer_mod
from sie_tpu_torch.train.trainer import Trainer

TOL = 1e-6
ALL = ("noise", "scale", "chdrop", "tshift")
KW = dict(model="InterpGN", dnn_type="Transformer", seq_len=24, enc_in=3,
          num_class=3, num_shapelet=2, d_model=16, d_ff=32, n_heads=2,
          e_layers=1, dropout=0.0, use_pallas=False, lr=5e-3, seed=0)
AUG = dict(augment_noise_std=0.3, augment_scale_std=0.2,
           augment_chdrop_prob=0.4, augment_tshift_max=5)


def _batch(b=6, t=24, c=3, seed=0):
    """x (B, T, C) with padded tails (zero there) and its mask."""
    rng = np.random.default_rng(seed)
    lengths = np.array([t, t - 3, t // 2, 1, t, t - 7])[:b]
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    x = (rng.normal(size=(b, t, c)) * 2 + 0.5).astype(np.float32)
    return x * mask[:, :, None], mask


def _jax_draws(names, cfg, key, shape):
    """The JAX function's draws, key by key, at its shapes."""
    b, _t, c = shape
    out = []
    for i, name in enumerate(names):
        k = jax.random.fold_in(key, i + 101)
        if name == "noise":
            d = jax.random.normal(k, shape, jnp.float32)
        elif name == "scale":
            d = jax.random.normal(k, (b, 1, 1), jnp.float32)
        elif name == "chdrop":
            d = jax.random.bernoulli(k, 1.0 - cfg.augment_chdrop_prob,
                                     (b, 1, c))
        else:
            m = cfg.augment_tshift_max
            d = jax.random.randint(k, (b,), -m, m + 1)
        out.append(torch.from_numpy(np.array(d)))
    return out


def test_validate_refuses_as_the_jax_one_does():
    assert augment.KNOWN == jax_augment.KNOWN
    assert augment.validate(ALL) == jax_augment.validate(ALL) == ALL
    for bad in (("noise", "flip"), ("Noise",)):
        with pytest.raises(ValueError) as mine:
            augment.validate(bad)
        with pytest.raises(ValueError) as theirs:
            jax_augment.validate(bad)
        assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("names", [("noise",), ("scale",), ("chdrop",),
                                   ("tshift",), ALL,
                                   ("tshift", "chdrop", "noise")],
                         ids=lambda n: "+".join(n))
def test_arithmetic_matches_jax_on_the_jax_draws(names):
    cfg = Config(augment=names, **AUG)
    jcfg = JConfig(augment=names, **AUG)
    x, mask = _batch()
    key = jax.random.key(3)
    want_x, want_m = jax_augment.apply_augmentations(
        jcfg, key, jnp.asarray(x), jnp.asarray(mask))
    got_x, got_m = augment.apply_augmentations(
        cfg, torch.from_numpy(x), torch.from_numpy(mask),
        _jax_draws(names, jcfg, key, x.shape))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=TOL,
                               rtol=TOL)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    pad = got_m.numpy() == 0
    assert pad.any() and (got_x.numpy()[pad] == 0).all()
    if "tshift" not in names:
        assert not np.array_equal(got_x.numpy(), x)


def test_draws_have_the_jax_shapes_and_ranges():
    cfg = Config(augment=ALL, **AUG)
    g = torch.Generator().manual_seed(0)
    noise, scale, keep, off = augment.draw(cfg, (64, 50, 30), g)
    assert noise.shape == (64, 50, 30) and scale.shape == (64, 1, 1)
    assert keep.shape == (64, 1, 30) and keep.dtype == torch.bool
    assert off.shape == (64,) and off.dtype == torch.int64
    assert int(off.min()) >= -5 and int(off.max()) <= 5
    assert set(off.tolist()) == set(range(-5, 6))
    n = keep.numel()
    rate = float(keep.float().mean())
    assert abs(rate - 0.6) <= 5 * np.sqrt(0.24 / n)
    assert abs(float(noise.mean())) <= 5 / np.sqrt(noise.numel())
    assert abs(float(noise.std()) - 1) <= 0.01


def _trainer(**kw):
    return Trainer(Config(**dict(KW, **kw)), 2, device="cpu",
                   generator=torch.Generator().manual_seed(4))


def _train_batch():
    x, mask = _batch(t=KW["seq_len"])
    y = np.array([0, 1, 2, 0, 1, 2], np.int32)
    return x, y, mask, np.ones(len(y), np.float32)


def test_train_steps_augment_and_eval_does_not(monkeypatch):
    calls = []
    real = trainer_mod.apply_augmentations
    monkeypatch.setattr(trainer_mod, "apply_augmentations",
                        lambda *a: calls.append(1) or real(*a))
    t = _trainer(augment=ALL, **AUG)
    plain = _trainer()
    batch = _train_batch()
    t.train_step(batch, 1.0)
    assert len(calls) == 1
    ds = type("DS", (), dict(x=batch[0], y=batch[1],
                             padding_mask=batch[2]))()
    dev = t.device_data("eval", ds)
    staged = t.stage_steps([(np.arange(6), batch[3])])
    plain.model.load_state_dict(t.model.state_dict())
    got = [t.eval_step(batch)[0], t.eval_step_indexed(dev, np.arange(6))[0],
           t.eval_step_staged(dev, staged, 0)[0],
           t.eval_epoch_staged_scan(dev, staged)[0][0]]
    assert len(calls) == 1
    want = plain.eval_step(batch)[0]
    for g in got:
        assert torch.equal(g, want)


def test_without_augment_the_step_is_the_plain_loss(monkeypatch):
    monkeypatch.setattr(trainer_mod, "draw_augment", None)   # never called
    t = _trainer()
    assert t.augment_generator is None
    ref = _trainer()
    batch = _train_batch()
    want, _ = ref.loss_fn(ref.model, ref._device_batch(batch), 1.0,
                          ref.generator)
    loss, _ = t.train_step(batch, 1.0)
    assert torch.equal(loss, want.detach())


def test_dropout_draws_the_same_with_and_without_augment():
    a = _trainer(dropout=0.1)
    b = _trainer(dropout=0.1, augment=ALL, **AUG)
    s0 = a.generator.get_state()
    assert torch.equal(s0, b.generator.get_state())
    assert not torch.equal(b.augment_generator.get_state(), s0)
    aug0 = b.augment_generator.get_state()
    for _ in range(2):
        a.train_step(_train_batch(), 1.0)
        b.train_step(_train_batch(), 1.0)
    assert not torch.equal(a.generator.get_state(), s0)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert not torch.equal(b.augment_generator.get_state(), aug0)
    # the snapshot carries the augmentation stream
    tree = b.state_tree()
    c = _trainer(dropout=0.1, augment=ALL, **AUG)
    c.load_state_tree(tree)
    assert torch.equal(c.augment_generator.get_state(),
                       b.augment_generator.get_state())


def test_staged_equals_indexed_with_augment():
    x, y, mask, _w = _train_batch()
    ds = type("DS", (), dict(x=x, y=y, padding_mask=mask))()
    steps = [(np.array(i, np.int64), np.ones(4, np.float32)) for i in
             ([0, 2, 4, 5], [1, 3, 0, 2], [5, 4, 3, 1])]
    a = _trainer(dropout=0.1, augment=ALL, **AUG)
    b = _trainer(dropout=0.1, augment=ALL, **AUG)
    dev_a, dev_b = a.device_data("train", ds), b.device_data("train", ds)
    staged = b.stage_steps(steps, 1.0)
    for k, (idx, w) in enumerate(steps):
        la, _ = a.train_step_indexed(dev_a, idx, w, 1.0)
        lb, _ = b.train_step_staged(dev_b, staged, k)
        assert torch.equal(la, lb), k
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n


def test_cli_augment_parses_and_trains(tmp_path, capsys):
    write_synthetic_uea(str(tmp_path), "Toy", n_train=24, n_test=12,
                        n_dims=3, length=30, n_classes=2, seed=9)
    argv = ["--device", "cpu", "--data", "UEA", "--data_root", str(tmp_path),
            "--dataset", "Toy", "--model", "InterpGN", "--num_shapelet", "2",
            "--d_model", "16", "--d_ff", "32", "--n_heads", "2",
            "--e_layers", "1", "--batch_size", "8", "--train_epochs", "2",
            "--log_interval", "1", "--seed", "0", "--augment",
            "noise, tshift", "--augment_noise_std", "0.2",
            "--checkpoint_dir", str(tmp_path / "ck"),
            "--result_dir", str(tmp_path / "result"),
            "--cache_dir", str(tmp_path / "cache")]
    args = port_run.get_args(argv)
    cfg = port_run.args_to_config(args, 0)
    assert cfg.augment == ("noise", "tshift")
    assert cfg.augment_noise_std == 0.2
    results = port_run.main(argv)
    out = capsys.readouterr().out
    assert len([l for l in out.splitlines() if "Train Loss" in l]) == 2
    assert np.isfinite(results[0][1])
    with pytest.raises(ValueError, match="unknown augmentations"):
        port_run.main(argv[:-6] + ["--augment", "noise,flip"] + argv[-6:])
