"""sie_tpu_torch.quant against sie_tpu.quant, and the port's int8 Predictor
against the JAX one, on the CPU: quantize_tensor bit for bit (an all-zero
channel included), the size and exclude gates, weights_q.npz written by
either package read by the other with the same keys and arrays, a
quantised Predictor at the f32 limits of the JAX one on the same file, and
int8 held in the module with no f32 copy of a quantised leaf."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu import quant as jquant
from sie_tpu.config import Config as JConfig
from sie_tpu.models import build_model as jax_build
from sie_tpu.serve import Predictor as JPredictor
from sie_tpu_torch import quant
from sie_tpu_torch.compat.from_jax import Dequantize
from sie_tpu_torch.config import Config
from sie_tpu_torch.serve import Predictor

# tests/test_serve_http.py's small config (FCN has batch_stats), and one
# InterpGN + Transformer under amp whose attention takes K5's op
BASE = dict(model="InterpGN", seq_len=24, enc_in=3, num_class=4,
            num_shapelet=2, d_model=16, d_ff=32, n_heads=2, e_layers=1,
            dropout=0.0, use_pallas=False, seed=0)
CONFIGS = {"fcn": dict(BASE, dnn_type="FCN", amp=False),
           "transformer_amp": dict(BASE, dnn_type="Transformer", amp=True,
                                   fused_attention_min_len=0)}
TOL = {"fcn": 1e-4, "transformer_amp": 5e-2}   # f32 / bf16 logits
MIN_SIZE = 64   # quantise the small model's matrices and banks


@functools.lru_cache(maxsize=None)
def _init(name):
    return jax_variables(CONFIGS[name])


def jax_variables(kw):
    cfg = JConfig(**kw)
    v = jax_build(cfg).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((2, 24, 3)), jnp.ones((2, 24)), train=False)
    v = jax.device_get(v)
    out = {"params": v["params"]}
    if v.get("batch_stats"):
        # moved running statistics, so that BatchNorm is not the identity
        rng = np.random.default_rng(5)
        out["batch_stats"] = jax.tree.map(
            lambda a: (np.abs(rng.normal(size=a.shape)) + 0.5).astype(
                np.float32), v["batch_stats"])
    return cfg, out


def _x(b, seed=0):
    return np.random.default_rng(seed).normal(size=(b, 24, 3)).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(64, 96), (3, 7, 5), (10, 122, 43)])
def test_quantize_tensor_bit_equal(shape):
    rng = np.random.default_rng(len(shape))
    w = (rng.normal(size=shape) * rng.uniform(0.01, 10, size=shape[-1])
         ).astype(np.float32)
    w[..., 1] = 0.0                      # an all-zero channel
    got, want = quant.quantize_tensor(w), jquant.quantize_tensor(w)
    assert got.q.dtype == np.int8 and got.scale.dtype == np.float32
    np.testing.assert_array_equal(got.q, np.asarray(want.q))
    np.testing.assert_array_equal(got.scale, np.asarray(want.scale))
    np.testing.assert_array_equal(
        quant.dequantize_tensor(got),
        np.asarray(jquant.dequantize_tensor(want)))
    assert (quant.dequantize_tensor(got)[..., 1] == 0.0).all()


def test_size_and_exclude_gates_match():
    params = {"big": np.ones((64, 64), np.float32),
              "small": np.ones((4, 4), np.float32),
              "bias": np.ones((4096,), np.float32),
              "ints": np.ones((64, 64), np.int32),
              "keep": {"kernel": np.ones((64, 64), np.float32)},
              "enc": {"q": {"kernel": np.full((32, 64), 2.0, np.float32)}}}
    got = quant.quantize_params(params, min_size=1024, exclude=("keep",))
    want = jquant.quantize_params(params, min_size=1024, exclude=("keep",))
    flat_got = quant._flatten(got)
    flat_want = jquant._flatten(want)
    assert sorted(flat_got) == sorted(flat_want)
    assert {k for k in flat_got if k.endswith(".q")} == \
        {"big.q", "enc/q/kernel.q"}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_reads_in_the_other_package(writer, tmp_path):
    _, variables = _init("fcn")
    path = str(tmp_path / "weights_q.npz")
    save = quant.save_quantized if writer == "port" else \
        jquant.save_quantized
    save(path, variables, min_size=MIN_SIZE)
    with np.load(path) as z:
        raw = {k: z[k] for k in z.files}
    # the JAX package writes the same keys and arrays from the same tree
    other = str(tmp_path / "other.npz")
    (jquant.save_quantized if writer == "port" else quant.save_quantized)(
        other, variables, min_size=MIN_SIZE)
    with np.load(other) as z:
        assert sorted(z.files) == sorted(raw)
        for k in z.files:
            np.testing.assert_array_equal(z[k], raw[k], err_msg=k)
    assert any(k.endswith(".q") for k in raw)
    assert any(k.startswith("batch_stats/") for k in raw)
    got = quant._flatten(quant.load_quantized(path))
    want = jquant._flatten(jquant.load_quantized(path))
    assert sorted(got) == sorted(want) == sorted(raw)
    for k in raw:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_quantised_predictor_matches_jax(name, tmp_path):
    jcfg, variables = _init(name)
    path = str(tmp_path / "weights_q.npz")
    jquant.save_quantized(path, variables, min_size=MIN_SIZE)
    restored_j = jquant.load_quantized(path)
    restored_t = quant.load_quantized(path)
    jv = {"params": restored_j["params"]}
    tv = {"params": restored_t["params"]}
    if restored_j.get("batch_stats"):
        jv["batch_stats"] = restored_j["batch_stats"]
        tv["batch_stats"] = restored_t["batch_stats"]
    jp = JPredictor(jcfg, jv, max_batch=4)
    tp = Predictor(Config(**CONFIGS[name]), tv, device="cpu", max_batch=4)
    assert tp.quantized
    x = _x(6, seed=2)
    got, want = tp.predict(x), jp.predict(x)
    np.testing.assert_allclose(got.logits, want.logits, atol=TOL[name])
    np.testing.assert_array_equal(got.classes, want.classes)
    np.testing.assert_allclose(got.p, want.p, atol=TOL[name])


def test_module_holds_int8_and_no_f32_copy():
    _, variables = _init("fcn")
    qv = dict(variables, params=quant.quantize_params(
        variables["params"], min_size=MIN_SIZE))
    tp = Predictor(Config(**CONFIGS["fcn"]), qv, device="cpu")
    state = tp.model.state_dict()
    n_q = len([k for k in quant._flatten(qv["params"]) if k.endswith(".q")])
    int8 = [k for k, v in state.items() if v.dtype == torch.int8]
    assert len(int8) == n_q > 3
    deq = [m for m in tp.model.modules() if isinstance(m, Dequantize)]
    assert len(deq) == n_q
    # every quantised weight is held only as q (int8) and scale (f32)
    for k in int8:
        base = k[: -len(".original0")]
        assert set(s for s in state if s.startswith(base)) == \
            {base + ".original0", base + ".original1"}
    f32_bytes = sum(4 * state[k].numel() for k in int8)
    held = sum(state[k].numel() + 4 * state[k[:-1] + "1"].numel()
               for k in int8)
    assert held <= 0.3 * f32_bytes
    # the weight a forward reads is the JAX package's dequantize_tensor
    bank = tp.model.sbm.shapelets_5
    want = jquant.quantize_tensor(variables["params"]["sbm"]["shapelets_5"])
    np.testing.assert_array_equal(
        bank.numpy(), np.asarray(jquant.dequantize_tensor(want)))
    with pytest.raises(RuntimeError, match="cannot be assigned"):
        tp.model.sbm.shapelets_5 = torch.zeros_like(bank)


def test_quantised_bundle_file_is_smaller(tmp_path):
    _, variables = _init("transformer_amp")
    tp = Predictor(Config(**CONFIGS["transformer_amp"]), variables,
                   device="cpu")
    tp.save_bundle(str(tmp_path / "f"))
    tp.save_bundle(str(tmp_path / "q"), quantize=True, min_size=MIN_SIZE)
    assert os.path.getsize(tmp_path / "q" / "weights_q.npz") < \
        os.path.getsize(tmp_path / "f" / "checkpoint.msgpack")
