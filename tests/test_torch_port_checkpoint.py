"""The port's checkpoints against flax's, on the CPU.

`compat/flax_msgpack.py` writes and reads flax's msgpack format with the
standard library: a tree that flax wrote reads exactly in the port, the
port's bytes read exactly in flax (and equal flax's own bytes), over
hypothesis-drawn trees of f32, bf16 and i32 arrays, scalars and empty
arrays. `to_jax_params` undoes `load_jax_params`. The port's best-model
checkpoint loads with `sie_tpu.train.checkpoint.load_checkpoint`, and its
full-state snapshot resumes a run exactly (bit for bit)."""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from sie_tpu.config import Config as JConfig
from sie_tpu.train import checkpoint as jckpt
from sie_tpu.train.trainer import Trainer as JTrainer
from sie_tpu_torch.compat import flax_msgpack
from sie_tpu_torch.compat.from_jax import load_jax_params, to_jax_params
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.train import checkpoint as pckpt
from sie_tpu_torch.train.trainer import Trainer

KW = dict(model="InterpGN", dnn_type="Transformer", seq_len=24, enc_in=3,
          num_class=3, num_shapelet=2, d_model=16, d_ff=32, n_heads=2,
          e_layers=2, dropout=0.0, use_pallas=False,
          fused_attention_min_len=0, lr=5e-3, seed=0)


def _flax_params(**kw):
    cfg = JConfig(**dict(KW, **kw))
    x = np.zeros((2, cfg.seq_len, cfg.enc_in), np.float32)
    state = JTrainer(cfg, 1).init_state(
        (x, np.zeros(2, np.int32), np.ones((2, cfg.seq_len), np.float32),
         np.ones(2, np.float32)), seed=0)
    return jax.tree.map(np.asarray, jax.device_get(dict(state.params)))


def _equal_trees(a, b):
    """Same keys at every level, leaves equal in dtype, shape and bits."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
        return
    if torch.is_tensor(b):   # the port reads bfloat16 as a torch tensor
        b = b.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b


def test_flax_checkpoint_reads_exactly_in_the_port():
    params = _flax_params()
    data = serialization.to_bytes({"params": params, "batch_stats": {}})
    back = flax_msgpack.from_bytes(data)
    _equal_trees({"params": params, "batch_stats": {}}, back)
    assert flax_msgpack.to_bytes(back) == data


def test_port_checkpoint_reads_exactly_in_flax(tmp_path):
    model = build_model(Config(**KW), "cpu", torch.Generator().manual_seed(3))
    params = to_jax_params(model)
    pckpt.save_checkpoint(str(tmp_path), params, meta={"epoch_stop": 1})
    template = {"params": jax.tree.map(np.zeros_like, params),
                "batch_stats": {}}
    restored = jckpt.load_checkpoint(str(tmp_path), template)
    _equal_trees({"params": params, "batch_stats": {}},
                 jax.tree.map(np.asarray, restored))
    assert jckpt.load_meta(str(tmp_path)) == {"epoch_stop": 1}


@pytest.mark.parametrize("kw", [dict(), dict(model="SBM", sbm_cls="attention"),
                                dict(model="LTS", sbm_cls="bilinear"),
                                dict(model="DNN")],
                         ids=["interpgn", "sbm_attention", "lts_bilinear",
                              "dnn"])
def test_to_jax_params_inverts_load_jax_params(kw):
    params = _flax_params(**kw)
    model = load_jax_params(build_model(Config(**dict(KW, **kw)), "cpu"),
                            params)
    _equal_trees(params, to_jax_params(model))


_shapes = st.lists(st.integers(0, 4), min_size=0, max_size=3)


@st.composite
def _leaves(draw):
    kind = draw(st.sampled_from(["f32", "bf16", "i32", "int", "float", "bool",
                                 "npscalar", "str"]))
    if kind in ("f32", "bf16", "i32"):
        shape = tuple(draw(_shapes))
        n = int(np.prod(shape))
        vals = draw(st.lists(st.floats(-1e4, 1e4, width=32), min_size=n,
                             max_size=n))
        a = np.asarray(vals, np.float32).reshape(shape)
        if kind == "i32":
            return a.astype(np.int32), a.astype(np.int32)
        if kind == "bf16":
            t = torch.from_numpy(a).to(torch.bfloat16)
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16), t
        return a, a
    v = {"int": st.integers(-2 ** 40, 2 ** 40), "float": st.floats(
        allow_nan=False), "bool": st.booleans(), "str": st.text(max_size=40),
         "npscalar": st.floats(-1e4, 1e4, width=32).map(np.float32)}[kind]
    v = draw(v)
    return v, v


@st.composite
def _trees(draw, depth=2):
    keys = draw(st.lists(st.text(min_size=1, max_size=8), max_size=4,
                         unique=True))
    flax_tree, port_tree = {}, {}
    for k in keys:
        if depth and draw(st.booleans()):
            flax_tree[k], port_tree[k] = draw(_trees(depth - 1))
        else:
            flax_tree[k], port_tree[k] = draw(_leaves())
    return flax_tree, port_tree


@settings(max_examples=40, deadline=None)
@given(_trees())
def test_codec_matches_flax_on_random_trees(trees):
    flax_tree, port_tree = trees
    data = serialization.to_bytes(flax_tree)
    assert flax_msgpack.to_bytes(port_tree) == data
    _equal_trees(flax_tree, flax_msgpack.from_bytes(data))
    _equal_trees(flax_tree, serialization.msgpack_restore(
        flax_msgpack.to_bytes(port_tree)))


def _rows(n=12, seed=0):
    rng = np.random.default_rng(seed)
    return type("Rows", (), dict(
        x=rng.normal(size=(n, KW["seq_len"], KW["enc_in"])).astype(np.float32),
        y=rng.integers(0, 3, n).astype(np.int32),
        padding_mask=np.ones((n, KW["seq_len"]), np.float32)))()


@pytest.mark.parametrize("accum", [1, 2])
def test_train_state_snapshot_resumes_exactly(tmp_path, accum):
    """Three staged steps, a snapshot, three more; a new trainer restored
    from the snapshot takes the same three steps bit for bit (dropout on,
    so the generator's state counts; with accumulation the snapshot falls
    inside a group)."""
    cfg = Config(**dict(KW, dropout=0.2, gradient_accumulation_steps=accum,
                        lr_decay=True, train_epochs=4))
    ds = _rows()
    rng = np.random.default_rng(1)
    sched = [(rng.permutation(12)[:4], np.ones(4, np.float32))
             for _ in range(3)]
    mk = lambda seed: Trainer(cfg, 3, device="cpu",
                              generator=torch.Generator().manual_seed(seed))
    a = mk(0)
    dev = a.device_data("train", ds)
    staged = a.stage_steps(sched, 0.5)
    for k in range(3):
        a.train_step_staged(dev, staged, k)
    pckpt.save_train_state(str(tmp_path), a, 1, {"best_score": -0.5,
                                                 "counter": 1,
                                                 "has_best": True})
    want = [a.train_step_staged(dev, staged, k)[0] for k in range(3)]
    b = mk(1)   # other initial weights: all must come from the snapshot
    epoch, early = pckpt.load_train_state(str(tmp_path), b)
    assert epoch == 1 and early["counter"] == 1 and early["has_best"]
    dev_b = b.device_data("train", ds)
    staged_b = b.stage_steps(sched, 0.5)
    got = [b.train_step_staged(dev_b, staged_b, k)[0] for k in range(3)]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    assert (b.step, b.optimizer.count, b.optimizer.mini_step) == \
        (a.step, a.optimizer.count, a.optimizer.mini_step)


def test_background_save_lands_before_load(tmp_path):
    params = {"w": np.arange(3, dtype=np.float32)}
    for i in range(3):
        params = {"w": params["w"] + i}
        pckpt.save_checkpoint(str(tmp_path), params, meta={"epoch_stop": i},
                              background=True)
    assert pckpt.has_checkpoint(str(tmp_path))
    got = pckpt.load_checkpoint(str(tmp_path))
    assert np.array_equal(got["params"]["w"], params["w"])
    assert got["batch_stats"] == {} and \
        pckpt.load_meta(str(tmp_path)) == {"epoch_stop": 2}
    assert pckpt.load_checkpoint(str(tmp_path / "none")) is None
