"""sie_tpu_torch training vs the JAX package, on the CPU: the optimizer
against optax, the loss pieces, one InterpGN train step against
`sie_tpu.train.trainer.Trainer` at the same flax weights (the attention
through the Pallas kernels in interpret mode on the JAX side, the plain
versions of K5/K6 and K1/K2 on the port's), and dropout.

Tolerances: f32 loss 1e-5 and gradients 1e-4 of each leaf's largest entry
(f32 summation order); bf16 (amp) loss 5e-3 and gradients 5e-2 relative
norm error per leaf (bf16 rounding at other places inside fused
operations)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.models.sbm import clamp_sbm_weights as jax_clamp
from sie_tpu.train.trainer import Trainer as JTrainer
from sie_tpu.train.trainer import compute_beta as jax_compute_beta
from sie_tpu.train.trainer import make_optimizer as jax_make_optimizer
from sie_tpu.train.trainer import weighted_ce as jax_weighted_ce
from sie_tpu_torch.compat.from_jax import _flatten, _target, load_jax_params
from sie_tpu_torch.config import Config
from sie_tpu_torch.models import layers as layers_mod
from sie_tpu_torch.models import sbm as sbm_mod
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.train.trainer import (Optimizer, Trainer, compute_beta,
                                         make_schedule, weighted_ce)

KW = dict(model="InterpGN", dnn_type="Transformer", seq_len=24, enc_in=3,
          num_class=3, num_shapelet=2, d_model=16, d_ff=32, n_heads=2,
          e_layers=1, dropout=0.0, use_pallas=False, fused_attention_min_len=0,
          lr=5e-3, seed=0)
B = 4


# ------------------------------------------------------------ optimizer
OPT_CASES = {
    "clip_accum_cosine_warmup": dict(gradient_clip=0.5,
                                     gradient_accumulation_steps=2,
                                     lr_decay=True, lr_warmup_epochs=1.0,
                                     train_epochs=3),
    "plain_adam": dict(),
    "clip_cosine": dict(gradient_clip=0.8, lr_decay=True, train_epochs=2),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    kw = dict(lr=0.01, **OPT_CASES[case])
    steps_per_epoch = 3
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    # norms from ~0.3 to ~3: clipping triggers on some steps, not others
    grads = [[rng.normal(size=s).astype(np.float32) * scale for s in shapes]
             for scale in (0.1, 1.0, 0.3, 0.05, 0.8, 0.2, 0.6, 0.1)]
    tx = jax_make_optimizer(JConfig(**kw), steps_per_epoch)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = Optimizer(Config(**kw), steps_per_epoch, tp)
    for i, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        moved = opt.device_step(opt.mini_step)
        opt.advance()
        assert moved == ((i + 1) % kw.get("gradient_accumulation_steps", 1)
                         == 0)
        for got, want in zip(tp, jp):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-6,
                                       err_msg=f"step {i}")
    assert opt.count == len(grads) // kw.get("gradient_accumulation_steps", 1)


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_schedule_matches_optax(case):
    """make_schedule at every optimizer count of train_epochs + 1 epochs
    against the learning rate the JAX package's optimizer applies: its
    update over that of the same optimizer at a constant lr of 1, on the
    same gradients."""
    kw = dict(lr=0.01, **OPT_CASES[case])
    steps_per_epoch = 3
    accum = kw.get("gradient_accumulation_steps", 1)
    unit = dict(kw, lr=1.0, lr_decay=False, lr_warmup_epochs=0.0)
    txs = [jax_make_optimizer(JConfig(**c), steps_per_epoch)
           for c in (kw, unit)]
    p = jnp.zeros((1,), jnp.float32)
    states = [tx.init(p) for tx in txs]
    want = []
    for i in range((kw.get("train_epochs", 10) + 1) * steps_per_epoch):
        g = jnp.full((1,), 0.3 + 0.1 * i, jnp.float32)
        (u, states[0]), (u1, states[1]) = (
            tx.update(g, st, p) for tx, st in zip(txs, states))
        if (i + 1) % accum == 0:
            want.append(float(u[0]) / float(u1[0]))
    schedule = make_schedule(Config(**kw), steps_per_epoch)
    got = [float(schedule(torch.tensor(float(c)))) for c in range(len(want))]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_loss_pieces_match():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 6).astype(np.int32)
    for w in (rng.random(6).astype(np.float32), np.zeros(6, np.float32)):
        got = weighted_ce(torch.from_numpy(logits), torch.from_numpy(labels),
                          torch.from_numpy(w))
        want = jax_weighted_ce(jnp.asarray(logits), jnp.asarray(labels),
                               jnp.asarray(w))
        np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    for schedule in ("cosine", "linear", "constant"):
        for epoch in (0, 3, 9):
            assert compute_beta(epoch, 10, schedule) == pytest.approx(
                float(jax_compute_beta(epoch, 10, schedule)), abs=1e-12)


def test_clamp_sbm_weights():
    cfg = Config(**KW)
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(1))
    w = model.sbm.output_layer.weight
    assert (w < 0).any()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    sbm_mod.clamp_sbm_weights(model)
    want = np.asarray(jax_clamp({"sbm": {"output_layer": {
        "kernel": jnp.asarray(before["sbm.output_layer.weight"].numpy().T)}}})
        ["sbm"]["output_layer"]["kernel"]).T
    np.testing.assert_array_equal(w.detach().numpy(), want)
    for n, p in model.named_parameters():   # nothing else moved
        if n != "sbm.output_layer.weight":
            assert torch.equal(p, before[n]), n


# ------------------------------------------------------------ train step
def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, KW["seq_len"], KW["enc_in"])).astype(np.float32)
    y = rng.integers(0, KW["num_class"], B).astype(np.int32)
    return (x, y, np.ones((B, KW["seq_len"]), np.float32),
            np.ones((B,), np.float32))


def _port_layout(module, tree):
    """{port parameter name: array} for a flax-shaped tree of leaves."""
    return dict(_target(module, path, v) for path, v in _flatten(tree).items())


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "amp"])
def step_pair(request):
    """One train step of the JAX trainer and of the port's, from the same
    flax-initialised weights: (port trainer, port loss, JAX loss, JAX grads
    and JAX updated params in port layout, amp)."""
    kw = dict(KW, amp=request.param)
    batch, beta = _batch(), 1.0
    jt = JTrainer(JConfig(**kw), steps_per_epoch=1)
    state = jt.init_state(batch, seed=0)
    params = jax.tree.map(np.asarray, state.params)
    jbatch = tuple(jnp.asarray(a) for a in batch)
    grad_fn = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True),
                      static_argnums=(4,))
    (jloss, _), jgrads = grad_fn(state.params, state.batch_stats, jbatch,
                                 jnp.float32(beta), True, jax.random.key(0))
    new_state, jloss2, _ = jt.train_step(state, batch, beta)
    model = load_jax_params(build_model(Config(**kw), "cpu"), params)
    trainer = Trainer(Config(**kw), steps_per_epoch=1, model=model,
                      device="cpu")
    loss, logits = trainer.train_step(batch, beta)
    assert logits.shape == (B, KW["num_class"])
    return dict(trainer=trainer, loss=float(loss), jloss=float(jloss),
                jloss2=float(jloss2),
                grads=_port_layout(model, jax.tree.map(np.asarray, jgrads)),
                new=_port_layout(model, jax.tree.map(np.asarray,
                                                     new_state.params)),
                amp=request.param)


def test_train_step_loss_matches(step_pair):
    sp = step_pair
    assert sp["jloss"] == pytest.approx(sp["jloss2"], abs=1e-6)
    tol = 5e-3 if sp["amp"] else 1e-5
    assert sp["loss"] == pytest.approx(sp["jloss"], abs=tol)


def test_train_step_gradients_match(step_pair):
    sp = step_pair
    params = dict(sp["trainer"].model.named_parameters())
    assert set(params) == set(sp["grads"])
    for name, want in sp["grads"].items():
        got = params[name].grad
        assert got is not None, name
        got = got.numpy()
        if name.endswith("attention.key.bias"):
            # 0 in exact arithmetic (each row's scores shift by q . b, and
            # the softmax ignores a shift): both hold rounding noise only
            assert np.abs(got).max() <= 1e-4 and np.abs(want).max() <= 1e-4
            continue
        if sp["amp"]:
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= 5e-2, (name, err)
        else:
            tol = 1e-4 * np.abs(want).max()
            np.testing.assert_allclose(got, want, atol=tol, rtol=0,
                                       err_msg=name)


def test_train_step_updates_match(step_pair):
    """Adam's first step is ~lr * sign(g): entries with |g| < 1e-6 may flip
    on summation order, so they are left out."""
    sp = step_pair
    params = dict(sp["trainer"].model.named_parameters())
    lr = KW["lr"]
    for name, want in sp["new"].items():
        got = params[name].detach().numpy()
        sure = np.abs(sp["grads"][name]) >= 1e-6
        # bf16: the gradients' sign can differ where |g| is small relative
        # to their rounding; f32: only rounding of the update
        tol = 2.1 * lr if sp["amp"] else 1e-6
        np.testing.assert_allclose(got[sure], want[sure], atol=tol, rtol=0,
                                   err_msg=name)
        if not sp["amp"]:
            assert np.abs(got - want).max() <= 2.1 * lr, name


def test_indexed_step_equals_plain_step():
    cfg = Config(**KW)
    ds_x, ds_y, ds_m, _ = _batch(3)
    ds = type("DS", (), dict(x=ds_x, y=ds_y, padding_mask=ds_m))()
    idx = np.array([2, 0, 3], np.int64)
    w = np.array([1.0, 0.5, 1.0], np.float32)
    a = Trainer(cfg, 2, device="cpu", generator=torch.Generator().manual_seed(4))
    b = Trainer(cfg, 2, device="cpu", generator=torch.Generator().manual_seed(4))
    la, _ = a.train_step_indexed(a.device_data("train", ds), idx, w, 0.5)
    lb, _ = b.train_step((ds_x[idx], ds_y[idx], ds_m[idx], w), 0.5)
    assert torch.equal(la, lb)
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    logits, info = a.eval_step((ds_x, ds_y, ds_m, np.ones(4, np.float32)))
    assert logits.shape == (4, 3) and not logits.requires_grad
    assert info.eta.shape == (4, 1) and a.model.training


def test_pos_weight_clamps_after_the_step():
    t = Trainer(Config(**dict(KW, pos_weight=True)), 1, device="cpu")
    t.train_step(_batch(5), 1.0)
    assert (t.model.sbm.output_layer.weight >= 0).all()


# ------------------------------------------------------------ dropout
def test_dropout_keep_rate_and_scale():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = layers_mod.dropout(x, 0.3, g, training=True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert layers_mod.dropout(x, 0.3, None, training=False) is x
    assert layers_mod.dropout(x, 0.0, None, training=True) is x
    with pytest.raises(ValueError, match="Generator"):
        layers_mod.dropout(x, 0.3, None, training=True)


@pytest.mark.parametrize("fused", [True, False])
def test_dropout_in_training_only(fused):
    kw = dict(KW, dropout=0.5, amp=False,
              fused_attention_min_len=0 if fused else 256)
    model = build_model(Config(**kw), "cpu", torch.Generator().manual_seed(2))
    ref = build_model(Config(**dict(kw, dropout=0.0)), "cpu",
                      torch.Generator().manual_seed(2))
    x = torch.from_numpy(_batch(1)[0])
    with torch.no_grad():
        ev, _ = model(x)
        np.testing.assert_array_equal(ev.numpy(), ref(x)[0].numpy())
        model.train()
        tr1, _ = model(x, generator=torch.Generator().manual_seed(9))
        tr2, _ = model(x, generator=torch.Generator().manual_seed(9))
        tr3, _ = model(x, generator=torch.Generator().manual_seed(10))
    assert torch.equal(tr1, tr2)                   # the generator decides
    assert not torch.allclose(tr1, ev, atol=1e-3)  # dropout is on
    assert not torch.allclose(tr1, tr3, atol=1e-3)


def test_bilinear_draws_three_independent_masks(monkeypatch):
    cfg = Config(**dict(KW, model="SBM", sbm_cls="bilinear", dropout=0.5))
    model = build_model(cfg, "cpu").train()
    masks = []
    real = sbm_mod.dropout

    def spy(z, rate, generator, training):
        out = real(z, rate, generator, training)
        masks.append(out != 0)
        return out

    monkeypatch.setattr(sbm_mod, "dropout", spy)
    model(torch.from_numpy(_batch(2)[0]),
          generator=torch.Generator().manual_seed(0))
    assert len(masks) == 3
    for i in range(3):
        for j in range(i + 1, 3):
            assert not torch.equal(masks[i], masks[j])


def test_train_step_with_dropout_is_finite_and_moves_weights():
    t = Trainer(Config(**dict(KW, dropout=0.1)), 1, device="cpu")
    before = [p.detach().clone() for p in t.model.parameters()]
    loss, _ = t.train_step(_batch(4), 1.0)
    assert np.isfinite(float(loss))
    assert all(not torch.equal(a, p) for a, p in
               zip(before, t.model.parameters()))


# ------------------------------------------------------------ refusals
def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Config(**KW), 1)


def test_unported_training_paths_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(Config(**KW), 1, device="cpu", mesh=object())
    # augmentation is ported (tests/test_torch_port_augment.py); an unknown
    # name is refused
    assert Trainer(Config(**dict(KW, augment=("noise",))), 1,
                   device="cpu").augment_generator is not None
    with pytest.raises(ValueError, match="unknown augmentations"):
        Trainer(Config(**dict(KW, augment=("flip",))), 1, device="cpu")


def test_config_fields_match_the_jax_package():
    assert {f.name for f in dataclasses.fields(Config)} == \
        {f.name for f in dataclasses.fields(JConfig)}
