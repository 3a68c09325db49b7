"""The port's BatchNorm against the JAX package's (flax `nn.BatchNorm`,
momentum 0.9, epsilon 1e-5), on the CPU.

Train mode: outputs and the running `mean`/`var` after three updates, f32
and bf16, 2-D (rows, features) and 4-D inputs (flax NHWC, the port NCHW);
eval mode: the running statistics, moved by nothing. Tolerances: f32 1e-5
abs on outputs (f32 sums in another order, scaled by rsqrt(var)) and 1e-6
on the statistics; bf16 outputs one bf16 rounding (2^-8 relative) of an
O(1) value, 5e-2 abs as for bf16 logits. The statistics stay float32 in
both packages. With 4 rows of 1 step, flax's biased batch variance and
torch's unbiased one differ by 4/3: the case fails on a port that moves
`var` as torch.nn.BatchNorm does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.models.layers import BatchNorm as JBatchNorm
from sie_tpu_torch.compat.from_jax import load_jax_variables
from sie_tpu_torch.models.layers import BatchNorm

F = 6
SHAPES = {"2d": (4, F), "4d": (3, 2, 5, F)}   # flax layout, features last


def _to_port(a):
    """flax (..., F) layout -> the port's (B, F, ...)."""
    return np.moveaxis(a, -1, 1) if a.ndim > 2 else a


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    # a mean far from 0 and a spread far from 1, so the updates show
    return [(3.0 + 2.0 * rng.normal(size=shape)).astype(np.float32)
            for _ in range(3)]


def _port(dtype, variables):
    bn = BatchNorm(F, dtype)
    return load_jax_variables(bn, variables)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_train_mode_matches_flax(shape, amp):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if amp else (jnp.float32,
                                                            torch.float32)
    xs = _inputs(SHAPES[shape], 0)
    jbn = JBatchNorm(use_running_average=False, dtype=jdt)
    variables = jax.tree.map(np.asarray, jbn.init(jax.random.key(0),
                                                  jnp.asarray(xs[0])))
    # a non-trivial scale and bias
    rng = np.random.default_rng(1)
    variables["params"] = {"scale": rng.uniform(0.5, 2, F).astype(np.float32),
                           "bias": rng.normal(size=F).astype(np.float32)}
    port = _port(tdt, variables).train()
    tol = 5e-2 if amp else 1e-5
    for x in xs:
        want, new = jbn.apply(variables, jnp.asarray(x),
                              mutable=["batch_stats"])
        variables = dict(variables, batch_stats=jax.tree.map(
            np.asarray, new["batch_stats"]))
        got = port(torch.from_numpy(_to_port(x)))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   _to_port(np.asarray(want, np.float32)),
                                   atol=tol, rtol=0)
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(getattr(port, leaf).numpy(),
                                   variables["batch_stats"][leaf], atol=1e-6,
                                   rtol=1e-6, err_msg=leaf)
    assert not port.mean.requires_grad and not port.var.requires_grad


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_eval_mode_reads_the_running_statistics(shape):
    x = _inputs(SHAPES[shape], 2)[0]
    rng = np.random.default_rng(3)
    variables = {"params": {"scale": rng.uniform(0.5, 2, F).astype(np.float32),
                            "bias": rng.normal(size=F).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(size=F).astype(np.float32),
                                 "var": rng.uniform(0.5, 3, F).astype(
                                     np.float32)}}
    jbn = JBatchNorm(use_running_average=True, dtype=jnp.float32)
    want = np.asarray(jbn.apply(variables, jnp.asarray(x)))
    port = _port(torch.float32, variables).eval()
    got = port(torch.from_numpy(_to_port(x)))
    np.testing.assert_allclose(got.detach().numpy(), _to_port(want),
                               atol=1e-5, rtol=0)
    for leaf in ("mean", "var"):
        np.testing.assert_array_equal(getattr(port, leaf).numpy(),
                                      variables["batch_stats"][leaf])


def test_running_variance_is_the_biased_one():
    """4 rows x 1 step: flax moves `var` by the biased batch variance; a
    port on torch's running update (unbiased, x 4/3) would miss by far
    more than the limit."""
    x = _inputs((4, F), 4)[0]
    jbn = JBatchNorm(use_running_average=False)
    variables = jax.tree.map(np.asarray, jbn.init(jax.random.key(0),
                                                  jnp.asarray(x)))
    _, new = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    want = np.asarray(new["batch_stats"]["var"])
    port = _port(torch.float32, variables).train()
    port(torch.from_numpy(x))
    np.testing.assert_allclose(port.var.numpy(), want, atol=1e-6, rtol=1e-6)
    # the trap the port avoids: torch's BatchNorm1d moves var unbiased
    torch_bn = torch.nn.BatchNorm1d(F, momentum=0.1, eps=1e-5).train()
    torch_bn(torch.from_numpy(x))
    assert np.abs(torch_bn.running_var.numpy() - want).max() > 1e-2
