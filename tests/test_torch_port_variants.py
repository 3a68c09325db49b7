"""The attention variants of the port (sie_tpu_torch/models/extra/
attention_variants.py: DS, ProbSparse, LSH, two-stage), ProbAttention's
`prob_mask` and the LSH rotations' draw (utils/threefry.py) against the
JAX package, on the CPU, at the same flax weights and inputs.

- threefry: `jax.random.bits`/`uniform` equal bit for bit, and
  `jax.random.normal` within 1e-6, at several seeds and shapes; the LSH
  buckets the port computes from those rotations equal the JAX ones.
- Each layer: forward within 1e-5 in f32 (causal and not), 5e-2 under amp
  (bf16 projections), f32 gradients within 1e-4 of each leaf's largest,
  floored at 1e-2 of the layer's largest (the key bias has a zero
  gradient up to rounding).
- ProbAttention's strided key sample equal to the JAX one.
- The Transformer encoder with each variant: one InterpGN train step
  against `sie_tpu.train.trainer.Trainer`'s loss function from the same
  weights (loss 1e-5 in f32, gradients as above), then the eval logits of
  the moved weights against the JAX model's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.models.extra import attention_variants as jav
from sie_tpu.train.trainer import Trainer as JTrainer
from sie_tpu.utils import masking as jmasking
from sie_tpu_torch.compat.from_jax import (_flatten, _target,
                                           load_jax_params, to_jax_params)
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.extra import attention_variants as pav
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.train.trainer import Trainer
from sie_tpu_torch.utils import masking as pmasking
from sie_tpu_torch.utils import threefry

FWD, AMP, GRAD = 1e-5, 5e-2, 1e-4
G = lambda: torch.Generator().manual_seed(0)


def _np(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ threefry
@pytest.mark.parametrize("seed,shape", [(0, (16, 4, 6)), (0, (64, 4, 106)),
                                        (1, (7,)), (12345, (3, 5, 2)),
                                        (2 ** 31 - 1, (8, 3))], ids=str)
def test_threefry_draws_equal_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(threefry.random_bits(seed, shape),
                                  np.asarray(jax.random.bits(key, shape,
                                                             jnp.uint32)))
    np.testing.assert_array_equal(threefry.uniform(seed, shape),
                                  np.asarray(jax.random.uniform(key, shape)))
    np.testing.assert_allclose(threefry.normal(seed, shape).numpy(),
                               np.asarray(jax.random.normal(key, shape)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("n,seed", [(32, 0), (848, 0), (24, 3)])
def test_lsh_buckets_equal_jax(n, seed):
    """The buckets of unit keys under the JAX package's rotations
    (jax.random.normal(PRNGKey(hash_seed), (dk, r, n_buckets/2)))."""
    dk, r, bs = 8, 4, 4
    keys = _np(seed + 1, 6, n, dk)
    keys /= np.linalg.norm(keys, axis=-1, keepdims=True)
    layer = pav.LSHAttentionLayer(16, 2, torch.float32, G(), bs, r,
                                  hash_seed=seed)
    got = layer.buckets(torch.from_numpy(keys), n).numpy()
    n_buckets = max(n // bs, 2)
    n_buckets += n_buckets % 2
    rot = jax.random.normal(jax.random.PRNGKey(seed),
                            (dk, r, n_buckets // 2), jnp.float32)
    rotated = jnp.einsum("zle,ero->zlro", jnp.asarray(keys), rot)
    want = jnp.argmax(jnp.concatenate([rotated, -rotated], -1),
                      -1).transpose(0, 2, 1)
    np.testing.assert_array_equal(got, np.asarray(want))


# ------------------------------------------------------------ helpers
def _layer_pair(jmod, port, args, atol, jkw=None, pkw=None, grads=True):
    jkw, pkw = jkw or {}, pkw or {}
    jargs = tuple(map(jnp.asarray, args))
    v = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jmod.init, **jkw))(jax.random.key(4), *jargs))
    load_jax_params(port, v["params"]).eval()
    fwd = lambda p: jmod.apply({"params": p}, *jargs, **jkw).astype(
        jnp.float32)
    w = _np(9, *jax.eval_shape(fwd, v["params"]).shape)
    (_, want), jg = jax.jit(jax.value_and_grad(
        lambda p: (jnp.sum(fwd(p) * w), fwd(p)), has_aux=True))(v["params"])
    got = port(*map(torch.from_numpy, args), **pkw)
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want), atol=atol, rtol=0)
    if grads:
        (got.float() * torch.from_numpy(w)).sum().backward()
        mine = dict(_target(port, p, g) for p, g in _flatten(
            jax.tree.map(np.asarray, jg)).items())
        top = max(float(np.abs(g).max()) for g in mine.values())
        for name, p in port.named_parameters():
            want_g = mine[name]
            tol = GRAD * max(float(np.abs(want_g).max()), 1e-2 * top)
            np.testing.assert_allclose(p.grad.numpy(), want_g, atol=tol,
                                       rtol=0, err_msg=name)
    return v


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("causal", [False, True])
def test_ds_attention(causal):
    q, k = _np(1, 2, 12, 16), _np(2, 2, 10, 16)
    tau, delta = np.abs(_np(3, 2)) + 0.5, _np(4, 2, 10)
    _layer_pair(jav.DSAttentionLayer(16, 2, causal=causal),
                pav.DSAttentionLayer(16, 2, torch.float32, G(),
                                     causal=causal),
                (q, k, k), FWD)
    jm = jav.DSAttentionLayer(16, 2)
    pm = pav.DSAttentionLayer(16, 2, torch.float32, G())
    _layer_pair(jm, pm, (q, k, k), FWD,
                jkw=dict(tau=jnp.asarray(tau), delta=jnp.asarray(delta)),
                pkw=dict(tau=torch.from_numpy(tau),
                         delta=torch.from_numpy(delta)), grads=False)


def test_sample_index_equals_jax():
    for lq, lk in ((845, 845), (96, 48), (33, 70)):
        sample_k = min(5 * int(np.ceil(np.log(lk))), lk)
        if sample_k == lk:
            continue
        stride = lk / sample_k
        base = jnp.floor(jnp.arange(sample_k) * stride).astype(jnp.int32)
        off = (jnp.arange(lq, dtype=jnp.int32) * 7919) % max(int(stride), 1)
        want = (base[None, :] + off[:, None]) % lk
        np.testing.assert_array_equal(pav.sample_index(lq, lk, sample_k),
                                      np.asarray(want))


@pytest.mark.parametrize("l,causal", [(40, False), (40, True), (12, False)])
def test_prob_attention(l, causal):
    """At L 40 the sparsity measure reads 20 sampled keys and 20 of 40
    queries attend; at L 12 every key is read and every query attends."""
    x = _np(5, 2, l, 16)
    _layer_pair(jav.ProbAttentionLayer(16, 2, causal=causal),
                pav.ProbAttentionLayer(16, 2, torch.float32, G(),
                                       causal=causal), (x, x, x), FWD)


def test_prob_mask_equals_jax():
    index = np.random.default_rng(0).integers(0, 12, (2, 3, 5))
    scores = np.zeros((2, 3, 5, 12), np.float32)
    want = jmasking.prob_mask(2, 3, 12, jnp.asarray(index),
                              jnp.asarray(scores))
    got = pmasking.prob_mask(2, 3, 12, torch.from_numpy(index),
                             torch.from_numpy(scores))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("l,causal", [(16, False), (21, False), (16, True)])
def test_lsh_attention(l, causal):
    """L 21 is padded to 24 (a multiple of 2 x bucket_size) and cut back."""
    x = _np(6, 2, l, 16)
    _layer_pair(jav.LSHAttentionLayer(16, 2, causal=causal),
                pav.LSHAttentionLayer(16, 2, torch.float32, G(),
                                      causal=causal), (x,), FWD)


@pytest.mark.parametrize("l", [16, 21])
def test_lsh_buckets_of_the_layer_input_equal_jax(l, monkeypatch):
    """`buckets_of(x)` gives the buckets the JAX layer sorts x's positions
    by (its sort key // n), at the same weights."""
    x = _np(6, 2, l, 16)
    jmod = jav.LSHAttentionLayer(16, 2)
    v = jax.tree.map(np.asarray, jmod.init(jax.random.key(4),
                                           jnp.asarray(x)))
    port = load_jax_params(pav.LSHAttentionLayer(16, 2, torch.float32, G()),
                           v["params"])
    keys = []

    class _Jnp:
        def __getattr__(self, name):
            if name != "argsort":
                return getattr(jnp, name)
            return lambda a, **kw: (keys.append(np.asarray(a)),
                                    jnp.argsort(a, **kw))[1]

    monkeypatch.setattr(jav, "jnp", _Jnp())
    jmod.apply(v, jnp.asarray(x))
    n = -(-l // 8) * 8
    with torch.no_grad():
        got = port.buckets_of(torch.from_numpy(x)).numpy()
    assert got.shape == keys[0].shape == (2 * 2, 4, n)
    np.testing.assert_array_equal(got, keys[0] // n)

@pytest.mark.parametrize("variant", ["ds", "prob", "lsh"])
def test_variants_under_amp(variant):
    cls = {"ds": (jav.DSAttentionLayer, pav.DSAttentionLayer),
           "prob": (jav.ProbAttentionLayer, pav.ProbAttentionLayer),
           "lsh": (jav.LSHAttentionLayer, pav.LSHAttentionLayer)}[variant]
    x = _np(7, 2, 40, 16)
    args = (x,) if variant == "lsh" else (x, x, x)
    _layer_pair(cls[0](16, 2, dtype=jnp.bfloat16),
                cls[1](16, 2, torch.bfloat16, G()), args, AMP, grads=False)


def test_two_stage_attention():
    x = _np(8, 2, 3, 5, 16)
    _layer_pair(jav.TwoStageAttentionLayer(5, 2, 16, 2, 32, dropout=0.0),
                pav.TwoStageAttentionLayer(5, 2, 16, 2, G(), 32, 0.0),
                (x,), FWD)


# ------------------------------------------------------------ encoder
KW = dict(model="InterpGN", dnn_type="Transformer", seq_len=40, enc_in=3,
          num_class=3, num_shapelet=2, d_model=16, d_ff=32, n_heads=2,
          e_layers=2, dropout=0.0, use_pallas=False, lr=5e-3, seed=0,
          amp=False)


def _batch(seed=0, b=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 40, 3)).astype(np.float32),
            rng.integers(0, 3, b).astype(np.int32),
            np.ones((b, 40), np.float32), np.ones((b,), np.float32))


@pytest.mark.parametrize("variant", ["ds", "prob", "lsh"])
def test_encoder_variant_step_matches_the_jax_trainer(variant):
    """The flagship encoder with the variant, at the port's initial draw
    (its flax tree has the leaves of the JAX init, under the variant's
    flax scope): one InterpGN train step's loss and gradients against the
    JAX Trainer's loss function (1e-5; 1e-4 of each leaf's largest), and
    the eval logits after the step against the JAX model's at the moved
    weights (1e-4)."""
    kw = dict(KW, attention_variant=variant)
    batch = _batch()
    model = build_model(Config(**kw), "cpu")
    params = to_jax_params(model)
    jt = JTrainer(JConfig(**kw), steps_per_epoch=1)
    jargs = (jnp.zeros((2, 40, 3)), jnp.ones((2, 40)))
    want = jax.eval_shape(lambda: jt.model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        *jargs, train=False))["params"]
    assert jax.tree.structure(want) == jax.tree.structure(params)
    scope = dict(ds="DS", prob="Prob", lsh="LSH")[variant]
    assert f"{scope}AttentionLayer_0" in \
        params["deep_model"]["encoder"]["layer_0"]
    grad_fn = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True),
                      static_argnums=(4,))
    (jloss, _), jgrads = grad_fn(params, {}, tuple(map(jnp.asarray, batch)),
                                 jnp.float32(1.0), True, jax.random.key(0))
    trainer = Trainer(Config(**kw), steps_per_epoch=1, model=model,
                      device="cpu")
    loss, _ = trainer.train_step(batch, 1.0)
    assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
    grads = dict(_target(model, p, np.asarray(g))
                 for p, g in _flatten(jax.device_get(jgrads)).items())
    top = max(float(np.abs(g).max()) for g in grads.values())
    for name, p in model.named_parameters():
        tol = GRAD * max(float(np.abs(grads[name]).max()), 1e-2 * top)
        np.testing.assert_allclose(p.grad.numpy(), grads[name], atol=tol,
                                   rtol=0, err_msg=name)
    x, _, mask, _ = _batch(1)
    jlogits, _ = jax.jit(lambda p: jt.model.apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(mask), train=False))(
            to_jax_params(model))
    got, _ = trainer.eval_step(_batch(1))
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), atol=1e-4)
