"""The Switch-MoE FFN of the port (sie_tpu_torch/models/moe.py) against
sie_tpu/models/moe.py, on the CPU, at the same flax weights and inputs.

- Routing: the dispatch and combine tensors the JAX module feeds its two
  einsums (read by wrapping the module's `jnp.einsum`) against the port's
  `MoEFFN.routing`: dispatch equal element for element, combine within
  1e-6 (the gates are softmax probabilities), at top-1, 2 and 3, at
  capacities that drop tokens and that do not, and with every router
  logit tied (argmax takes the lowest expert in both).
- The layer: outputs within 1e-5 in f32 and 5e-2 under amp (bf16 experts),
  the load-balance loss (+ the z-loss) equal within 1e-7 in training,
  nothing added in eval.
- One InterpGN + Transformer step with a MoE encoder against
  `sie_tpu.train.trainer.Trainer`'s loss function at the same weights
  (the port's draw as a flax tree): the loss (with the aux term) within
  1e-5 in f32 (5e-3 under amp), gradients within 1e-4 of each leaf's
  largest in f32; dropping the aux weight moves the loss by the aux
  term exactly.
- Bundles of that model (f32, and int8 with the stacked expert weights
  quantised) saved by either package serve in the other at 1e-4.
- The port's own initial draw of the layer has the JAX init's
  distributions leaf for leaf."""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.models import moe as jmoe
from sie_tpu.serve import Predictor as JPredictor
from sie_tpu.train.trainer import Trainer as JTrainer
from sie_tpu_torch.compat.from_jax import (_flatten, _target,
                                           load_jax_params, to_jax_params)
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.moe import MoEFFN, capacity
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.serve import Predictor
from sie_tpu_torch.train.trainer import Trainer

B, T, D, FF, E = 3, 20, 8, 12, 4


def _x(seed=0, shape=(B, T, D)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _variables(top_k, cf, zloss=0.0, tied=False):
    m = jmoe.MoEFFN(D, FF, E, cf, top_k, zloss_weight=zloss)
    v = jax.tree.map(np.asarray, m.init(jax.random.key(3),
                                        jnp.asarray(_x()), train=False))
    if tied:
        v["params"]["router"] = jax.tree.map(np.zeros_like,
                                             v["params"]["router"])
    return m, v


def _port(top_k, cf, dtype=torch.float32, zloss=0.0, tied=False):
    _, v = _variables(top_k, cf, zloss, tied)
    p = MoEFFN(D, FF, E, dtype, torch.Generator().manual_seed(0), cf,
               top_k, zloss_weight=zloss)
    return load_jax_params(p, v["params"]).eval()


def _jax_routing(m, v, x, monkeypatch):
    """(dispatch, combine) as the JAX module builds them."""
    seen = {}
    real = jnp.einsum

    def spy(spec, *ops, **kw):
        if spec == "btec,btd->ebcd":
            seen["dispatch"] = np.asarray(ops[0])
        elif spec == "btec,ebcd->btd":
            seen["combine"] = np.asarray(ops[0])
        return real(spec, *ops, **kw)

    class _Jnp:
        def __getattr__(self, name):
            return spy if name == "einsum" else getattr(jnp, name)

    monkeypatch.setattr(jmoe, "jnp", _Jnp())
    m.apply(v, jnp.asarray(x), train=False)
    return seen["dispatch"], seen["combine"]


ROUTES = [(1, 1.25, False), (1, 0.5, False), (2, 1.25, False),
          (2, 0.3, False), (3, 2.0, False), (1, 1.0, True), (2, 1.0, True)]


@pytest.mark.parametrize("top_k,cf,tied", ROUTES, ids=str)
def test_dispatch_and_combine_equal_jax(top_k, cf, tied, monkeypatch):
    m, v = _variables(top_k, cf, tied=tied)
    x = _x(1)
    want_d, want_c = _jax_routing(m, v, x, monkeypatch)
    with torch.no_grad():
        _, _, got_d, got_c = _port(top_k, cf, tied=tied).routing(
            torch.from_numpy(x))
    cap = min(T * top_k, max(1, math.ceil(cf * T * top_k / E)))
    assert capacity(T, E, top_k, cf) == cap
    assert got_d.shape == want_d.shape == (B, T, E, cap)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_allclose(got_c.numpy(), want_c, atol=1e-6, rtol=0)
    if tied:    # every token's first choice is expert 0
        assert (got_d[..., 0, :].sum(-1) > 0).any()
    if cf < 1.0:    # tokens past capacity are dropped
        assert float(got_d.sum()) < B * T * top_k


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
@pytest.mark.parametrize("top_k,zloss", [(1, 0.0), (2, 1e-3)])
def test_layer_and_aux_loss_match_jax(amp, top_k, zloss):
    m, v = _variables(top_k, 1.25, zloss)
    dt = jnp.bfloat16 if amp else jnp.float32
    m = jmoe.MoEFFN(D, FF, E, 1.25, top_k, zloss_weight=zloss, dtype=dt)
    x = _x(2)
    want, sown = m.apply(v, jnp.asarray(x), train=True, mutable=["losses"])
    port = _port(top_k, 1.25, torch.bfloat16 if amp else torch.float32,
                 zloss).train()
    aux = []
    got = port(torch.from_numpy(x), None, aux)
    assert got.dtype == (torch.bfloat16 if amp else torch.float32)
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32),
                               atol=5e-2 if amp else 1e-5, rtol=0)
    (want_aux,) = jax.tree.leaves(sown["losses"])
    assert len(aux) == 1
    np.testing.assert_allclose(float(aux[0]), float(want_aux), atol=1e-7,
                               rtol=1e-6)
    eval_aux = []
    port.eval()(torch.from_numpy(x), None, eval_aux)
    _, sown_eval = m.apply(v, jnp.asarray(x), train=False,
                           mutable=["losses"])
    assert eval_aux == [] and not jax.tree.leaves(sown_eval)



@pytest.mark.parametrize("e,d,ff", [(8, 32, 64), (4, 64, 16)], ids=str)
def test_the_port_draws_the_expert_weights_as_the_jax_package(e, d, ff):
    """The port's own initial draw of a MoE layer has, leaf for leaf, the
    shapes and distributions of `MoEFFN.init` in the JAX package (zero
    leaves equal; leaves of 1000 or more values with stds within 10 % and
    means within 5 standard errors). flax's lecun_normal counts the expert
    axis of (E, in, out) into the fan-in."""
    m = jmoe.MoEFFN(d, ff, e)
    theirs = jax.tree.map(np.asarray, m.init(
        jax.random.key(5), jnp.zeros((1, 4, d)), train=False)["params"])
    mine = to_jax_params(MoEFFN(d, ff, e, torch.float32,
                                torch.Generator().manual_seed(5)))
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    compared = 0
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(mine),
                            jax.tree.leaves(theirs)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, path
        if b.std() == 0:
            np.testing.assert_array_equal(a, b)
        elif b.size >= 1000:
            assert a.std() == pytest.approx(b.std(), rel=0.1), path
            assert abs(a.mean() - b.mean()) < 5 * b.std() / np.sqrt(b.size)
            compared += 1
    assert compared == 2        # expert_wi and expert_wo

KW = dict(model="InterpGN", dnn_type="Transformer", seq_len=T, enc_in=3,
          num_class=3, num_shapelet=2, d_model=16, d_ff=32, n_heads=2,
          e_layers=2, dropout=0.0, use_pallas=False,
          fused_attention_min_len=0, lr=5e-3, seed=0, moe_experts=4,
          moe_top_k=1, moe_capacity_factor=1.25, moe_aux_weight=0.01)


def _batch(seed=0, b=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, T, 3)).astype(np.float32),
            rng.integers(0, 3, b).astype(np.int32),
            np.ones((b, T), np.float32), np.ones((b,), np.float32))


@functools.lru_cache(maxsize=None)
def _step_pair(amp, top_k=1):
    """One train step of the port from its initial draw, and the JAX
    Trainer's loss function and gradients at the same weights (the
    port's draw as a flax tree)."""
    kw = dict(KW, amp=amp, moe_top_k=top_k)
    batch = _batch()
    model = build_model(Config(**kw), "cpu")
    params = to_jax_params(model)
    jt = JTrainer(JConfig(**kw), steps_per_epoch=1)
    grad_fn = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True),
                      static_argnums=(4,))
    (jloss, _), jgrads = grad_fn(params, {}, tuple(map(jnp.asarray, batch)),
                                 jnp.float32(1.0), True, jax.random.key(0))
    trainer = Trainer(Config(**kw), steps_per_epoch=1, model=model,
                      device="cpu")
    loss, _ = trainer.train_step(batch, 1.0)
    grads = dict(_target(model, p, np.asarray(g))
                 for p, g in _flatten(jax.device_get(jgrads)).items())
    return float(loss), float(jloss), model, grads


@pytest.mark.parametrize("amp,top_k", [(False, 1), (False, 2), (True, 1)],
                         ids=["f32-top1", "f32-top2", "amp-top1"])
def test_interpgn_moe_step_matches_the_jax_trainer(amp, top_k):
    loss, jloss, model, grads = _step_pair(amp, top_k)
    assert loss == pytest.approx(jloss, abs=5e-3 if amp else 1e-5)
    if amp:
        return
    params = dict(model.named_parameters())
    assert set(params) == set(grads)
    assert any("moe_ffn.expert_wi" in n for n in params)
    top = max(float(np.abs(g).max()) for g in grads.values())
    for name, want in grads.items():
        got = params[name].grad.numpy()
        tol = 1e-4 * max(float(np.abs(want).max()), 1e-3 * top)
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=name)


def test_the_aux_loss_reaches_the_objective():
    """Dropping the aux weight to 0 moves the port's loss by exactly the
    sown term (the MoE layers' sum on `ModelInfo.aux_loss`); eval gives
    none."""
    batch = _batch(1)
    got = []
    for w in (0.01, 0.0):
        kw = dict(KW, moe_aux_weight=w)
        model = build_model(Config(**kw), "cpu")
        tr = Trainer(Config(**kw), steps_per_epoch=1, model=model,
                     device="cpu")
        _, info = tr.model(torch.from_numpy(batch[0]),
                           torch.from_numpy(batch[2]),
                           generator=tr.generator)
        got.append((float(tr.train_step(batch, 1.0)[0]), info.aux_loss))
    assert got[1][1] is not None and float(got[1][1]) == 0.0
    assert float(got[0][1]) > 0.0
    assert got[0][0] - got[1][0] == pytest.approx(float(got[0][1]),
                                                  abs=1e-6)
    tr.model.eval()
    assert tr.model(torch.from_numpy(batch[0]))[1].aux_loss is None


BUNDLE = dict(KW, e_layers=1, amp=False)


@functools.lru_cache(maxsize=None)
def _flax_variables():
    model = build_model(Config(**BUNDLE), "cpu")
    return JConfig(**BUNDLE), {"params": to_jax_params(model)}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_moe_bundles_cross_both_ways(writer, quantize, tmp_path):
    jcfg, variables = _flax_variables()
    d = str(tmp_path / "bundle")
    if writer == "jax":
        JPredictor(jcfg, variables).save_bundle(d, quantize=quantize,
                                                min_size=64)
    else:
        Predictor(Config(**BUNDLE), variables, device="cpu"
                  ).save_bundle(d, quantize=quantize, min_size=64)
    assert ("weights_q.npz" in os.listdir(d)) is quantize
    tp = Predictor.load_bundle(d, device="cpu", max_batch=4)
    jp = JPredictor.load_bundle(d, max_batch=4)
    if quantize:
        moe = tp.model.deep_model.encoder.layers[0].moe_ffn
        assert torch.nn.utils.parametrize.is_parametrized(moe, "expert_wi")
    x = _batch(5, b=6)[0]
    got, want = tp.predict(x), jp.predict(x)
    np.testing.assert_allclose(got.logits, want.logits, atol=1e-4)
    np.testing.assert_array_equal(got.classes, want.classes)
