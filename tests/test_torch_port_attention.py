"""sie_tpu_torch fused attention (the plain versions of K5 and K6, the
dropout hash and the autograd wrapper) vs the JAX package's Pallas kernels
run in interpret mode, on the CPU. The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_port_kernels.py
and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.ops.pallas.attention_pallas import _dropout_mask
from sie_tpu.ops.pallas.attention_pallas import fused_attention as jax_fused
from sie_tpu_torch.ops.attention import (attention_bwd, attention_plain,
                                         dropout_keep, fused_attention)

# f32: summation order only. bf16: one bf16 ulp of an O(1) output (2^-8),
# twice, from the output rounding
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _qkv(seed, bh, t, dk):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bh, t, dk)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,dk", [(40, 16), (130, 64), (130, 16), (40, 64)])
def test_matches_pallas_interpret(dtype, t, dk):
    q, k, v = _qkv(t + dk, 3, t, dk)
    scale = 1.0 / np.sqrt(dk)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    got = fused_attention(tq, tk, tv, scale)
    assert got.dtype == dtype and got.shape == (3, t, dk)
    jq, jk, jv = (jnp.asarray(a, JNP[dtype]) for a in (q, k, v))
    want = jax_fused(jq, jk, jv, jnp.zeros((1,), jnp.int32), scale, 0.0, True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.9, 1 - 2 ** -33])
def test_dropout_keep_is_the_pallas_mask_bit_for_bit(rate):
    """The hash at global (row, col) offsets, several programs and seeds,
    including negative int32 seeds (reinterpreted as uint32 by both)."""
    for seed, bh, row0, col0 in ((0, 0, 0, 0), (12345, 3, 64, 0),
                                 (-7, 511, 832, 768), (2 ** 31 - 2, 17, 5, 9)):
        want = np.asarray(_dropout_mask(
            (24, 40), rate, jnp.int32(seed), jnp.int32(bh), row0, col0))
        rows = torch.arange(row0, row0 + 24)[:, None]
        cols = torch.arange(col0, col0 + 40)[None, :]
        got = dropout_keep(seed, bh, rows, cols, rate)
        np.testing.assert_array_equal(got.numpy(), want)
        got_t = dropout_keep(torch.tensor([seed], dtype=torch.int32),
                             torch.tensor(bh), rows, cols, rate)
        np.testing.assert_array_equal(got_t.numpy(), want)
    keep = dropout_keep(3, torch.arange(4)[:, None, None],
                        torch.arange(200)[:, None], torch.arange(200)[None],
                        rate).float().mean()
    assert abs(float(keep) - (1 - rate)) < 0.01


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_forward_matches_pallas_interpret(dtype):
    q, k, v = _qkv(11, 3, 40, 16)
    scale, rate, seed = 0.25, 0.25, 987654
    got = fused_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
                          scale, rate, seed)
    got_plain = attention_plain(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), scale, rate,
        torch.tensor([seed], dtype=torch.int32))
    jq, jk, jv = (jnp.asarray(a, JNP[dtype]) for a in (q, k, v))
    want = np.asarray(jax_fused(jq, jk, jv, jnp.asarray([seed], jnp.int32),
                                scale, rate, True).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=0)
    assert torch.equal(got, got_plain)
    # a different seed is a different mask
    other = fused_attention(*(torch.from_numpy(a).to(dtype)
                              for a in (q, k, v)), scale, rate, seed + 1)
    assert float((other.float() - got.float()).abs().max()) > 0.1


# f32: summation order; bf16: one bf16 ulp of the largest gradient entries
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,dk", [(40, 16), (130, 64), (130, 16), (40, 64)])
def test_gradients_match_pallas_vjp(t, dk, dtype, rate):
    q, k, v = _qkv(t * dk + int(rate * 8), 2, t, dk)
    do = np.random.default_rng(t).normal(size=q.shape).astype(np.float32)
    scale, seed = 1.0 / np.sqrt(dk), 4242
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    out = fused_attention(tq, tk, tv, scale, rate, seed)
    out.backward(torch.from_numpy(do).to(dtype))
    jseed = jnp.asarray([seed], jnp.int32)
    _, vjp = jax.vjp(lambda a, b, c: jax_fused(a, b, c, jseed, scale, rate,
                                               True),
                     *(jnp.asarray(a, JNP[dtype]) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, JNP[dtype]))
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == dtype, name
        w = np.asarray(w.astype(jnp.float32))
        tol = GRAD_TOL[dtype] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got.float().numpy(), w, atol=tol, rtol=0,
                                   err_msg=f"d{name}")


def test_backward_wrapper_on_the_cpu_ignores_o_and_lse():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 2, 24, 8))
    do = torch.ones_like(q)
    a = attention_bwd(q, k, v, None, do, None, 0.3, 0.25, 7)
    b = attention_bwd(q, k, v, torch.zeros_like(q), do,
                      torch.zeros(2, 24), 0.3, 0.25, 7)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_wrapper_rejects_bad_input():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 4))
    with pytest.raises(ValueError):
        fused_attention(q, k[:, :4], v, 0.5)
    with pytest.raises(ValueError):
        fused_attention(q, k.to(torch.bfloat16), v, 0.5)
    with pytest.raises(ValueError):
        fused_attention(q.double(), k.double(), v.double(), 0.5)
    with pytest.raises(ValueError, match="rate"):
        fused_attention(q, k, v, 0.5, rate=1.0)


def test_cpu_path_launches_no_kernel():
    before = fused_attention.launches, attention_bwd.launches
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(2, 2, 8, 4))
    fused_attention(q, k, v, 0.5, 0.1, 3).sum().backward()
    assert q.grad is not None
    assert (fused_attention.launches, attention_bwd.launches) == before


def test_wrapper_refuses_non_contiguous_on_every_device():
    q = torch.zeros((1, 8, 2, 4)).transpose(1, 2).reshape(2, 8, 4)
    assert not q.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(q, q, q, 0.5)
