"""The port's FCN and ResNet backbones against the JAX package's, as `DNN`
and as InterpGN's expert, at the same flax weights and batch_stats
(carried over by `load_jax_variables`), on the CPU.

Eval mode: logits from the running statistics. Train mode (JAX
`mutable=["batch_stats"]`): logits from the batch statistics and the
moved running statistics. Cases: FCN's seq_len <= 10 kernels, ResNet at
an even and an odd length (the stride-2 stem's window alignment), and
InterpGN under `fuse_short_banks`. Limits are those of
tests/test_torch_port_models.py: f32 logits 1e-4 abs, bf16 5e-2 abs with
the same argmax; running statistics 1e-5 abs + 1e-5 relative (f32 in both
packages, from activations that differ by f32 or bf16 rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.config import Config as JConfig
from sie_tpu.models import build_model as jax_build
from sie_tpu_torch.compat.from_jax import (ParamLoadError, batch_stats_buffers,
                                           load_jax_variables,
                                           to_jax_variables)
from sie_tpu_torch.config import Config
from sie_tpu_torch.models.registry import build_model

F32_TOL, BF16_TOL = 1e-4, 5e-2

BASE = dict(seq_len=40, enc_in=3, num_class=3, num_shapelet=2, dropout=0.0,
            use_pallas=False, seed=0)
CASES = {
    "fcn": dict(model="DNN", dnn_type="FCN"),
    "fcn_short": dict(model="DNN", dnn_type="FCN", seq_len=8),
    "resnet_even": dict(model="DNN", dnn_type="ResNet"),
    "resnet_odd": dict(model="DNN", dnn_type="ResNet", seq_len=37),
    "interpgn_fcn": dict(model="InterpGN", dnn_type="FCN"),
    "interpgn_resnet": dict(model="InterpGN", dnn_type="ResNet", seq_len=33),
    "interpgn_fcn_fused": dict(model="InterpGN", dnn_type="FCN",
                               fuse_short_banks=True),
}


def _x(kw, seed=1, b=4):
    return (1.5 + np.random.default_rng(seed).normal(
        size=(b, kw["seq_len"], kw["enc_in"]))).astype(np.float32)


def _stats_like(stats, rng):
    """batch_stats of the same tree with non-trivial values."""
    return {k: (_stats_like(v, rng) if isinstance(v, dict) else
                (rng.normal(size=v.shape) if k == "mean" else
                 rng.uniform(0.5, 2.0, v.shape)).astype(np.float32))
            for k, v in stats.items()}


def _setup(kw):
    """(JAX model, flax variables with non-trivial batch_stats, the port
    model holding them)."""
    jmodel = jax_build(JConfig(**kw))
    x = jnp.zeros((2, kw["seq_len"], kw["enc_in"]), jnp.float32)
    mask = jnp.ones((2, kw["seq_len"]), jnp.float32)
    init = jax.jit(jmodel.init, static_argnames=("train",))
    variables = jax.tree.map(np.asarray, init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, x,
        mask, train=False))
    variables = {"params": variables["params"],
                 "batch_stats": _stats_like(variables["batch_stats"],
                                            np.random.default_rng(2))}
    port = load_jax_variables(build_model(Config(**kw), "cpu"), variables)
    return jmodel, variables, port


def _assert_logits(got, want, amp):
    tol = BF16_TOL if amp else F32_TOL
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    top2 = np.sort(want, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def _assert_stats(got, want, amp=False):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_stats(got[k], want[k], amp)
        return
    if amp:
        np.testing.assert_allclose(got, want, atol=0.1 * BF16_TOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_and_train_match_jax(case, amp):
    kw = dict(BASE, amp=amp, **CASES[case])
    jmodel, variables, port = _setup(kw)
    x = _x(kw)
    mask = np.ones(x.shape[:2], np.float32)
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)

    apply = jax.jit(jmodel.apply, static_argnames=("train", "mutable"))
    want, _ = apply(variables, xj, mj, train=False)
    with torch.inference_mode():
        got, _ = port.eval()(xt, mt)
    _assert_logits(got.numpy(), np.asarray(want), amp)

    (want, jinfo), new = apply(
        variables, xj, mj, train=True, rngs={"dropout": jax.random.key(3)},
        mutable=("batch_stats",))
    got, info = port.train()(xt, mt)
    _assert_logits(got.detach().numpy(), np.asarray(want), amp)
    _assert_stats(to_jax_variables(port)["batch_stats"],
                  jax.tree.map(np.asarray, new["batch_stats"]), amp)
    if kw["model"] == "InterpGN":
        np.testing.assert_allclose(info.eta.detach().numpy(),
                                   np.asarray(jinfo.eta),
                                   atol=BF16_TOL if amp else 1e-5)


def test_variables_round_trip_and_refuse_missing_stats():
    kw = dict(BASE, amp=False, **CASES["interpgn_resnet"])
    _, variables, port = _setup(kw)
    back = to_jax_variables(port)
    _assert_stats(back, variables)      # params and batch_stats, exactly
    assert set(batch_stats_buffers(port)) == {
        n for n, _ in port.named_buffers()}
    with pytest.raises(ParamLoadError, match="batch_stats buffer"):
        load_jax_variables(build_model(Config(**kw), "cpu"),
                           {"params": variables["params"]})
    stats = dict(variables["batch_stats"])
    stats["deep_model"] = dict(stats["deep_model"], extra={"mean": np.zeros(
        3, np.float32)})
    with pytest.raises(ParamLoadError, match="extra"):
        load_jax_variables(build_model(Config(**kw), "cpu"),
                           {"params": variables["params"],
                            "batch_stats": stats})


def test_eval_moves_no_statistics_and_train_moves_them():
    kw = dict(BASE, amp=False, **CASES["fcn"])
    _, _, port = _setup(kw)
    before = {k: v.clone() for k, v in batch_stats_buffers(port).items()}
    x = torch.from_numpy(_x(kw, seed=5))
    with torch.no_grad():
        port.eval()(x)
    assert all(torch.equal(before[k], v)
               for k, v in batch_stats_buffers(port).items())
    port.train()(x)
    assert all(not torch.equal(before[k], v)
               for k, v in batch_stats_buffers(port).items())
