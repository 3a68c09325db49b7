"""sie_tpu_torch shapelet ops (K1's plain version and the other metrics) vs
the JAX package, on the CPU. Inputs come from numpy; tolerances are float32
summation-order ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.ops import shapelet as jsh
from sie_tpu.ops.pallas.shapelet_pallas import l1_sliding_distance as pallas_l1
from sie_tpu_torch.ops import shapelet as tsh
from sie_tpu_torch.ops.shapelet_l1 import (l1_sliding_distance,
                                           l1_sliding_distance_plain)

ATOL = 1e-5   # f32, different summation order


def _inputs(seed, b=3, c=4, t=48, n=2, l=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, c, t)).astype(np.float32)
    s = rng.normal(size=(n, c, l)).astype(np.float32)
    return x, s


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
@pytest.mark.parametrize("stride", [1, 2])
def test_l1_matches_pallas_interpret_and_scan(metric, stride):
    x, s = _inputs(10 + stride)
    got = tsh.sliding_distance(torch.from_numpy(x), torch.from_numpy(s),
                               stride, metric).numpy()
    want_pallas = np.asarray(pallas_l1(jnp.asarray(x), jnp.asarray(s), stride,
                                       True, metric))
    want_ref = np.asarray(jsh.sliding_distance(jnp.asarray(x), jnp.asarray(s),
                                               stride, metric,
                                               use_pallas=False))
    assert got.shape == want_ref.shape
    np.testing.assert_allclose(got, want_pallas, atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=1e-5)


def test_l1_plain_matches_scan():
    x, s = _inputs(3, l=11)
    got = l1_sliding_distance_plain(torch.from_numpy(x), torch.from_numpy(s))
    want = jsh._l1_distance(jnp.asarray(x), jnp.asarray(s), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "pearson"])
@pytest.mark.parametrize("stride", [1, 3])
def test_conv_metrics_match(metric, stride):
    x, s = _inputs(20 + stride)
    got = tsh.sliding_distance(torch.from_numpy(x), torch.from_numpy(s),
                               stride, metric).numpy()
    want = np.asarray(jsh.sliding_distance(jnp.asarray(x), jnp.asarray(s),
                                           stride, metric, use_pallas=False))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_pointwise_ops_match():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 30)).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(
        tsh.instance_norm(torch.from_numpy(x)).numpy(),
        np.asarray(jsh.instance_norm(jnp.asarray(x))), atol=1e-5, rtol=1e-5)
    p = rng.random(size=(2, 3, 4, 9)).astype(np.float32)
    for fn_t, fn_j in ((tsh.ste_max, jsh.ste_max), (tsh.ste_min, jsh.ste_min)):
        np.testing.assert_allclose(fn_t(torch.from_numpy(p), dim=-1).numpy(),
                                   np.asarray(fn_j(jnp.asarray(p), axis=-1)),
                                   atol=1e-6)
    np.testing.assert_allclose(tsh.rbf(torch.from_numpy(p), 0.7).numpy(),
                               np.asarray(jsh.rbf(jnp.asarray(p), 0.7)),
                               atol=1e-6)
    bank = rng.normal(size=(3, 2, 8)).astype(np.float32)
    np.testing.assert_allclose(
        float(tsh.diversity_loss(torch.from_numpy(bank))),
        float(jsh.diversity_loss(jnp.asarray(bank))), atol=1e-6, rtol=1e-5)
    for t, l in ((845, 43), (5000, 250), (3000, 10)):
        assert tsh.shapelet_stride(t, l) == jsh.shapelet_stride(t, l)


def test_ste_max_gradient_is_one_hot_plus_softmax_jacobian():
    import jax
    rng = np.random.default_rng(6)
    p = rng.random(size=(2, 5)).astype(np.float32)
    w = rng.normal(size=(2,)).astype(np.float32)
    pt = torch.from_numpy(p).requires_grad_()
    (tsh.ste_max(pt, dim=-1) * torch.from_numpy(w)).sum().backward()
    gj = jax.grad(lambda a: jnp.sum(jsh.ste_max(a, axis=-1) * w))(
        jnp.asarray(p))
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gj), atol=1e-6)


def test_wrapper_rejects_bad_input():
    x, s = _inputs(7)
    with pytest.raises(ValueError):
        l1_sliding_distance(torch.from_numpy(x), torch.from_numpy(s),
                            metric="cosine")
    with pytest.raises(ValueError):
        l1_sliding_distance(torch.from_numpy(x), torch.from_numpy(s[:, :2]))
    with pytest.raises(ValueError):
        tsh.sliding_distance(torch.from_numpy(x), torch.from_numpy(s),
                             metric="manhattan")


def test_cpu_path_launches_no_kernel():
    before = l1_sliding_distance.launches
    x, s = _inputs(8)
    l1_sliding_distance(torch.from_numpy(x), torch.from_numpy(s))
    assert l1_sliding_distance.launches == before

