"""The port's PatchTST (sie_tpu_torch/models/patchtst.py) against the JAX
package's (sie_tpu/models/patchtst.py), on the CPU, at the same flax
weights carried over by `load_jax_params`; the same inputs from a numpy
seed go through both.

Tolerance 1e-4 abs (f32, amp off) for logits and gradients, from f32
summation order. The encoder's chunking: one chunk, and three chunks of 7
series over 20 (one zero-padded row), through the same parameters. Under
`patch_remat` the chunks are recomputed in the backward pass with the
same dropout masks (`ReplayDropout` replays the forward's draws):
gradients with and without recompute are equal bit for bit at dropout
0.1. Bundles as in test_torch_port_timesnet.py."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.models import build_model as jax_build
from sie_tpu.serve import Predictor as JPredictor
from sie_tpu_torch.compat.from_jax import load_jax_params, to_jax_tree
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.layers import ReplayDropout
from sie_tpu_torch.models.patchtst import chunking, patches
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.serve import Predictor

TOL = 1e-4
T, C, B = 37, 5, 4
KW = dict(seq_len=T, enc_in=C, num_class=3, num_shapelet=2, d_model=16,
          n_heads=2, d_ff=32, e_layers=2, dropout=0.0, amp=False,
          use_pallas=False, dnn_type="PatchTST", seed=0)
CHUNKS = {"one_chunk": 0, "three_padded_chunks": 7}


def _x(b=B, seed=0):
    return np.random.default_rng(seed).normal(size=(b, T, C)).astype(
        np.float32)


def test_patches_and_padding():
    """Replication pad by the stride at the end, windows of 16 every 8:
    patch_num = (T + 8 - 16) // 8 + 1 (105 at T = 845)."""
    x = _x()
    got = patches(torch.from_numpy(x)).numpy()
    padded = np.concatenate([x, np.repeat(x[:, -1:], 8, axis=1)], axis=1)
    n = (T + 8 - 16) // 8 + 1
    want = np.stack([padded[:, 8 * i:8 * i + 16] for i in range(n)], axis=1)
    want = want.transpose(0, 3, 1, 2).reshape(B * C, n, 16)
    np.testing.assert_array_equal(got, want)
    assert patches(torch.zeros(1, 845, 1)).shape[1] == 105


def test_chunking_is_the_jax_packages():
    assert chunking(20, 7) == (3, 7)
    assert chunking(64 * 122, 0) == (4, 1952)
    assert chunking(12, 0) == (1, 12)


@functools.lru_cache(maxsize=None)
def _model(model: str, chunk_rows: int):
    kw = dict(KW, model=model, patch_chunk_rows=chunk_rows)
    jm = jax_build(JConfig(**kw))
    v = jm.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                jnp.zeros((2, T, C)), jnp.ones((2, T)), train=False)
    params = jax.tree.map(np.asarray, jax.device_get(v["params"]))
    return kw, jm, params


@pytest.mark.parametrize("chunks", sorted(CHUNKS))
def test_logits_and_gradients_match_jax(chunks):
    kw, jm, params = _model("DNN", CHUNKS[chunks])
    x, mask = _x(), np.ones((B, T), np.float32)
    r = np.random.default_rng(9).normal(size=(B, 3)).astype(np.float32)

    def loss(p):
        logits, _ = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask),
                             train=True, rngs={"dropout": jax.random.key(2)})
        return jnp.sum(logits * r), logits

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    port = load_jax_params(build_model(Config(**kw), "cpu"), params).train()
    got, _ = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)
    (got * torch.from_numpy(r)).sum().backward()
    mine = to_jax_tree(port, {n: p.grad for n, p in port.named_parameters()})
    flat = lambda t: {"/".join(str(k.key) for k in path): np.asarray(g)
                      for path, g in jax.tree_util.tree_leaves_with_path(t)}
    mine, theirs = flat(mine), flat(grads)
    assert sorted(mine) == sorted(theirs)
    assert "backbone/enc_scan/encoder/layer_1/conv1/kernel" in theirs
    for k in theirs:
        np.testing.assert_allclose(mine[k], theirs[k], atol=TOL, rtol=0,
                                   err_msg=k)


def test_one_chunk_and_three_chunks_share_parameters():
    _, _, one = _model("DNN", 0)
    _, _, three = _model("DNN", 7)
    assert jax.tree.structure(one) == jax.tree.structure(three)
    kw = dict(KW, model="DNN")
    a = load_jax_params(build_model(Config(**kw), "cpu"), one)
    b = load_jax_params(build_model(Config(**dict(kw, patch_chunk_rows=7)),
                                    "cpu"), one)
    x = torch.from_numpy(_x(seed=4))
    with torch.inference_mode():
        np.testing.assert_allclose(a(x)[0].numpy(), b(x)[0].numpy(),
                                   atol=1e-6)


def _grads(model, x, mask, seed):
    g = torch.Generator().manual_seed(seed)
    logits, _ = model(x, mask, generator=g)
    logits.square().sum().backward()
    out = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return logits.detach(), out


@pytest.mark.parametrize("model", ["DNN", "InterpGN"])
def test_remat_gives_the_gradients_of_no_remat_bit_for_bit(model):
    """At dropout 0.1 over three chunks: the recompute draws the forward's
    masks (a checkpoint of dropout from the generator would not)."""
    kw = dict(KW, model=model, dropout=0.1, patch_chunk_rows=7)
    remat = build_model(Config(**kw), "cpu", torch.Generator().manual_seed(3))
    plain = build_model(Config(**dict(kw, patch_remat=False)), "cpu",
                        torch.Generator().manual_seed(3))
    remat.train(), plain.train()
    x, mask = torch.from_numpy(_x(seed=5)), torch.ones(B, T)
    la, ga = _grads(remat, x, mask, 11)
    lb, gb = _grads(plain, x, mask, 11)
    assert torch.equal(la, lb)
    assert sorted(ga) == sorted(gb)
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k
    # dropout did act: another seed gives other logits
    lc, _ = _grads(remat, x, mask, 12)
    assert not torch.equal(la, lc)


def test_replay_dropout_draws_then_replays():
    """The first pass draws what `dropout` and `dropout_seed` draw from the
    generator; a rewound pass replays the same masks and seed; a shape
    that differs on the replay raises."""
    from sie_tpu_torch.models.layers import dropout, dropout_seed
    x = torch.ones(40, 50)
    a, b = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    stream = ReplayDropout(a)
    first = (dropout(x, 0.1, stream, True), dropout_seed(stream))
    want = (dropout(x, 0.1, b, True), dropout_seed(b))
    assert torch.equal(first[0], want[0]) and torch.equal(first[1], want[1])
    stream.rewind()
    again = (dropout(x, 0.1, stream, True), dropout_seed(stream))
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    assert abs(float((first[0] > 0).float().mean()) - 0.9) < 0.03
    stream.rewind()
    with pytest.raises(RuntimeError, match="shape"):
        dropout(torch.ones(3, 3), 0.1, stream, True)


def test_interpgn_patchtst_logits_match_jax():
    kw, jm, params = _model("InterpGN", 7)
    x, mask = _x(seed=2), np.ones((B, T), np.float32)
    want, jinfo = jm.apply({"params": params}, jnp.asarray(x),
                           jnp.asarray(mask), train=False)
    port = load_jax_params(build_model(Config(**kw), "cpu"), params)
    with torch.inference_mode():
        got, info = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(info.eta.numpy(), np.asarray(jinfo.eta),
                               atol=TOL)


@pytest.mark.parametrize("quantize", [False, True])
def test_bundle_bytes_and_logits_equal_the_jax_package(quantize, tmp_path):
    kw, _jm, params = _model("InterpGN", 7)
    variables = {"params": params, "batch_stats": {}}
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    Predictor(Config(**kw), variables, device="cpu").save_bundle(
        mine, quantize=quantize, min_size=64)
    JPredictor(JConfig(**kw), variables).save_bundle(
        theirs, quantize=quantize, min_size=64)
    if quantize:
        a, b = (np.load(os.path.join(d, "weights_q.npz"))
                for d in (mine, theirs))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    else:
        with open(os.path.join(mine, "checkpoint.msgpack"), "rb") as f, \
                open(os.path.join(theirs, "checkpoint.msgpack"), "rb") as g:
            assert f.read() == g.read()
    x = _x(5, seed=6)
    got = Predictor.load_bundle(theirs, device="cpu", max_batch=8).predict(x)
    want = JPredictor.load_bundle(mine, max_batch=8).predict(x)
    assert Predictor.load_bundle(mine, device="cpu").quantized is quantize
    np.testing.assert_allclose(got.logits, want.logits, atol=TOL)
    np.testing.assert_array_equal(got.classes, want.classes)
