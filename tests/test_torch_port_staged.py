"""The port's epoch-staged paths on the CPU, where they run eagerly: bit for
bit (`torch.equal`) the eager indexed steps they stand for, and held
against the JAX package's `Trainer.train_step_staged` from the same flax
weights.

On the CPU `train_step_staged`, `train_epoch_staged`, `eval_step_staged`,
`eval_step_indexed` and `eval_epoch_staged_scan` run the work that the
card captures as CUDA graphs (tests/test_torch_port_graphs.py holds the
graphs against these eager steps on the card). Against JAX, at f32: the
losses within 1e-5 and, after one optimizer update, the parameters within
1e-6 where the averaged gradient is at least 1e-6 and within 2.1 x lr
everywhere (the limits of tests/test_torch_port_train.py: Adam's first
step is ~lr * sign(g), and a tiny g's sign may flip on summation order),
and within twice that after the second update."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.train.trainer import Trainer as JTrainer
from sie_tpu_torch.compat.from_jax import load_jax_params, port_layout
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.train.trainer import Trainer

KW = dict(model="InterpGN", dnn_type="Transformer", seq_len=24, enc_in=3,
          num_class=3, num_shapelet=2, d_model=16, d_ff=32, n_heads=2,
          e_layers=1, dropout=0.0, amp=False, use_pallas=False,
          fused_attention_min_len=0, lr=5e-3, seed=0)
ROWS, B, STEPS = 20, 4, 4


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    return type("Rows", (), dict(
        x=rng.normal(size=(ROWS, KW["seq_len"], KW["enc_in"])).astype(
            np.float32),
        y=rng.integers(0, KW["num_class"], ROWS).astype(np.int32),
        padding_mask=np.ones((ROWS, KW["seq_len"]), np.float32)))()


def _schedule(seed=1):
    rng = np.random.default_rng(seed)
    w = np.ones(B, np.float32)
    w[-1] = 0.0   # a padded row, as the Batcher's last batch has
    return [(rng.permutation(ROWS)[:B], w) for _ in range(STEPS)]


def _trainers(n, **kw):
    cfg = Config(**dict(KW, **kw))
    ds = _rows()
    out = []
    for _ in range(n):
        t = Trainer(cfg, STEPS, device="cpu",
                    generator=torch.Generator().manual_seed(3))
        out.append((t, t.device_data("train", ds)))
    return out


def _same_params(a, b):
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n


OPT = {"plain": dict(), "accum2": dict(gradient_accumulation_steps=2),
       "accum2_clip_decay_dropout": dict(
           gradient_accumulation_steps=2, gradient_clip=0.5, lr_decay=True,
           lr_warmup_epochs=1.0, train_epochs=3, dropout=0.2)}


@pytest.mark.parametrize("opt", sorted(OPT))
def test_train_step_staged_equals_indexed(opt):
    (a, da), (b, db) = _trainers(2, **OPT[opt])
    sched = _schedule()
    staged = b.stage_steps(sched, 0.5)
    for _epoch in range(2):
        for k, (idx, w) in enumerate(sched):
            la, ga = a.train_step_indexed(da, idx, w, 0.5)
            lb, gb = b.train_step_staged(db, staged, k)
            assert torch.equal(la, lb) and torch.equal(ga, gb)
    _same_params(a, b)
    assert (a.step, a.optimizer.count, a.optimizer.mini_step) == \
        (b.step, b.optimizer.count, b.optimizer.mini_step)


@pytest.mark.parametrize("opt", sorted(OPT))
def test_train_epoch_staged_equals_the_loop(opt):
    (a, da), (b, db) = _trainers(2, **OPT[opt])
    sched = _schedule()
    sa, sb = a.stage_steps(sched, 1.0), b.stage_steps(sched, 1.0)
    for _epoch in range(2):
        want = torch.stack([a.train_step_staged(da, sa, k)[0]
                            for k in range(STEPS)])
        got = b.train_epoch_staged(db, sb)
        assert got.shape == (STEPS,) and torch.equal(got, want)
    _same_params(a, b)


@pytest.mark.parametrize("gating,collect", [(None, False), (0.5, True)])
def test_eval_epoch_staged_scan_equals_per_batch(gating, collect):
    (t, dev), = _trainers(1)
    sched = _schedule()
    staged = t.stage_steps(sched)
    logits, ce, mloss, info = t.eval_epoch_staged_scan(dev, staged, gating,
                                                       collect)
    assert logits.shape == (STEPS, B, KW["num_class"]) and \
        ce.shape == (STEPS, B) and mloss.shape == (STEPS,)
    assert (info is None) == (not collect)
    for k, (idx, _w) in enumerate(sched):
        want, want_info = t.eval_step_staged(dev, staged, k, gating)
        assert torch.equal(logits[k], want)
        by_idx, _ = t.eval_step_indexed(dev, idx, gating)
        assert torch.equal(by_idx, want)
        want_ce = torch.nn.functional.cross_entropy(
            want, dev[1][torch.as_tensor(idx)], reduction="none")
        assert torch.allclose(ce[k], want_ce, atol=1e-6)
        assert torch.equal(mloss[k], want_info.loss.mean())
        if collect:
            for f in ("d", "p", "eta", "shapelet_preds", "dnn_preds"):
                assert torch.equal(getattr(info, f)[k],
                                   getattr(want_info, f)), f
    assert t.model.training and not logits.requires_grad


def test_staged_steps_match_the_jax_package_under_accumulation():
    """Four micro-batches in groups of two (two optimizer updates) through
    both packages' train_step_staged, from the same flax weights."""
    kw = dict(KW, gradient_accumulation_steps=2)
    ds, sched = _rows(), _schedule()
    jt = JTrainer(JConfig(**kw), steps_per_epoch=STEPS)
    idx0 = sched[0][0]
    state = jt.init_state((ds.x[idx0], ds.y[idx0], ds.padding_mask[idx0],
                           sched[0][1]), seed=0)
    params = jax.tree.map(np.asarray, state.params)
    model = load_jax_params(build_model(Config(**kw), "cpu"), params)
    t = Trainer(Config(**kw), STEPS, model=model, device="cpu")
    dev = t.device_data("train", ds)
    staged = t.stage_steps(sched, 1.0)
    jdev = jt.device_data("train", ds)
    jstaged = jt.stage_steps(sched, 1.0)
    # the first group's averaged gradient, for the entries whose update
    # direction is certain
    grad_fn = jax.jit(jax.grad(lambda p, b: jt.loss_fn(
        p, state.batch_stats, b, jnp.float32(1.0), True,
        jax.random.key(0))[0]))
    grads = [grad_fn(state.params, tuple(jnp.asarray(a) for a in (
        ds.x[i], ds.y[i], ds.padding_mask[i], w))) for i, w in sched[:2]]
    mean_g = port_layout(model, jax.tree.map(
        lambda a, b: (np.asarray(a) + np.asarray(b)) / 2, *grads))
    for k in range(STEPS):
        loss, _ = t.train_step_staged(dev, staged, k)
        state, jloss, _ = jt.train_step_staged(state, jdev, jstaged, k)
        assert float(loss) == pytest.approx(float(jloss), abs=1e-5), k
        if k == 1:   # after the first update
            want = port_layout(model, jax.tree.map(np.asarray, state.params))
            for name, p in t.model.named_parameters():
                got = p.detach().numpy()
                sure = np.abs(mean_g[name]) >= 1e-6
                assert np.abs(got - want[name])[sure].max(initial=0) <= 1e-6, name
                assert np.abs(got - want[name]).max() <= 2.1 * KW["lr"], name
    want = port_layout(model, jax.tree.map(np.asarray, state.params))
    for name, p in t.model.named_parameters():
        assert np.abs(p.detach().numpy() - want[name]).max() <= \
            2 * 2.1 * KW["lr"], name
    assert t.optimizer.count == 2 and t.optimizer.mini_step == 0


def test_graph_keys_hold_shapes_and_a_load_drops_the_graphs():
    """A graph's key tells apart two tensors at one address with other
    shapes, and keeps the tensors it reads; loading a state drops the
    graphs, which read the optimizer state that the load replaces."""
    a = torch.zeros(6)
    key, reads = Trainer._key("train_step", (a,), 0)
    assert key != Trainer._key("train_step", (a[:3],), 0)[0]
    assert reads[0] is a
    (t, _dev), = _trainers(1)
    t._graphs[key] = (None, None, reads)
    t._warm.add(key)
    t.load_state_tree(t.state_tree())
    assert not t._graphs and not t._warm
