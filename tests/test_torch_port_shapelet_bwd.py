"""sie_tpu_torch shapelet-distance backward (K2's plain version and the
autograd wrapper around K1/K2) vs the JAX package, on the CPU: the Pallas
kernel's custom VJP in interpret mode, and the scan rule for stride 2.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_port_kernels.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.ops import shapelet as jsh
from sie_tpu.ops.pallas.shapelet_pallas import l1_sliding_distance as pallas_l1
from sie_tpu_torch.ops import shapelet as tsh
from sie_tpu_torch.ops.shapelet_l1 import (l1_sliding_distance,
                                           l1_sliding_distance_bwd,
                                           l1_sliding_distance_bwd_plain)

# f32 sums of B * W terms in another order; relative to the largest entry
TOL = 1e-5


def _inputs(seed, b, c, t, n, l):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, c, t)).astype(np.float32)
    s = rng.normal(size=(n, c, l)).astype(np.float32)
    g = rng.normal(size=(b, n, c, t - l + 1)).astype(np.float32)
    return x, s, g


def _pallas_grad_s(x, s, g, metric, stride=1):
    _, vjp = jax.vjp(lambda a: pallas_l1(jnp.asarray(x), a, stride, True,
                                         metric), jnp.asarray(s))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _close(got, want):
    tol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
@pytest.mark.parametrize("b,c,t,n,l", [(2, 3, 30, 2, 7),     # W = 24
                                       (3, 5, 41, 3, 12),    # W = 30
                                       (1, 2, 20, 5, 3),     # W = 18
                                       (2, 4, 33, 1, 33)])   # W = 1
def test_plain_backward_matches_pallas_vjp(metric, b, c, t, n, l):
    x, s, g = _inputs(b * 100 + l, b, c, t, n, l)
    got = l1_sliding_distance_bwd_plain(torch.from_numpy(x),
                                        torch.from_numpy(s),
                                        torch.from_numpy(g), metric)
    assert got.shape == s.shape and got.dtype == torch.float32
    _close(got.numpy(), _pallas_grad_s(x, s, g, metric))


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
def test_autograd_gives_s_the_plain_gradient_and_x_none(metric):
    x, s, g = _inputs(4, 2, 3, 25, 4, 6)
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    d = l1_sliding_distance(tx, ts, metric)
    d.backward(torch.from_numpy(g))
    assert tx.grad is None
    want = l1_sliding_distance_bwd(torch.from_numpy(x), torch.from_numpy(s),
                                   torch.from_numpy(g), metric)
    assert torch.equal(ts.grad, want)
    _close(ts.grad.numpy(), _pallas_grad_s(x, s, g, metric))


def test_exact_ties_give_minus_g_like_the_pallas_kernel():
    """x = s = 0 everywhere: every tap is a tie. The Pallas select gives -g
    per tap (so -W/L with g = 1); the scan rule's sign would give 0."""
    x = np.zeros((1, 1, 8), np.float32)
    s = np.zeros((1, 1, 3), np.float32)
    g = np.ones((1, 1, 1, 6), np.float32)
    want = _pallas_grad_s(x, s, g, "euclidean")
    np.testing.assert_array_equal(want, np.full((1, 1, 3), -2.0, np.float32))
    got = l1_sliding_distance_bwd_plain(torch.from_numpy(x),
                                        torch.from_numpy(s),
                                        torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), want)
    # small integers: ties mixed with strict orders, both signs of g
    rng = np.random.default_rng(3)
    x = rng.integers(-2, 3, size=(2, 2, 12)).astype(np.float32)
    s = rng.integers(-2, 3, size=(3, 2, 4)).astype(np.float32)
    g = rng.integers(-3, 4, size=(2, 3, 2, 9)).astype(np.float32)
    got = l1_sliding_distance_bwd_plain(torch.from_numpy(x),
                                        torch.from_numpy(s),
                                        torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(),
                                  _pallas_grad_s(x, s, g, "euclidean"))


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
def test_stride_two_gradient_matches_the_scan_rule(metric):
    """Stride k goes through k stride-1 calls over the polyphase
    components; autograd adds their K2 gradients back into the bank."""
    x, s, _ = _inputs(9, 2, 3, 41, 3, 9)
    w = (41 - 9) // 2 + 1
    g = np.random.default_rng(10).normal(size=(2, 3, 3, w)).astype(np.float32)
    ts = torch.from_numpy(s).requires_grad_()
    d = tsh.sliding_distance(torch.from_numpy(x), ts, 2, metric)
    assert d.shape == (2, 3, 3, w)
    d.backward(torch.from_numpy(g))
    if metric == "euclidean":
        fn = lambda a: jsh._l1_distance(jnp.asarray(x), a, 2)
    else:
        fn = lambda a: jsh.sliding_distance(jnp.asarray(x), a, 2, metric,
                                            use_pallas=False)
    _, vjp = jax.vjp(fn, jnp.asarray(s))
    _close(ts.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def test_backward_wrapper_rejects_bad_g():
    x, s, g = _inputs(1, 2, 3, 20, 2, 5)
    tx, ts = torch.from_numpy(x), torch.from_numpy(s)
    with pytest.raises(ValueError):
        l1_sliding_distance_bwd(tx, ts, torch.from_numpy(g[:, :, :, 1:]))
    with pytest.raises(ValueError):
        l1_sliding_distance_bwd(tx, ts, torch.from_numpy(g), "cosine")
    before = l1_sliding_distance_bwd.launches
    l1_sliding_distance_bwd(tx, ts, torch.from_numpy(g))
    assert l1_sliding_distance_bwd.launches == before   # the CPU: no kernel
