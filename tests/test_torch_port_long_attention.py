"""sie_tpu_torch's fused attention against the JAX package's kv-blocked
kernels (K7 `_fwd_kv_kernel`, K8a `_dq_kv_kernel`, K8b `_dkv_kv_kernel`),
which it takes above T = 4096 or for any T with `block_kv`, on the CPU: the
port's plain versions and autograd wrapper against those kernels in
interpret mode at the shapes of tests/test_attention_kernel.py's blocked
cases; the chunked plain versions that the card checks use at long T; the
dropout hash at rows and columns past 2^16; and the layer's gate with
`fused_attention_max_len=0` just above 4096. The CUDA kernels K5 and K6,
the port's counterparts of K7, K8a and K8b, are held against the chunked
plain versions on the card by tests/test_torch_port_kernels.py (T=5000)
and chip_smoke.py (T=17984)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.models.layers import FullAttentionLayer as JLayer
from sie_tpu.ops.pallas.attention_pallas import _dropout_mask
from sie_tpu.ops.pallas.attention_pallas import fused_attention as jax_fused
import sie_tpu_torch.models.layers as layers_mod
from sie_tpu_torch.compat.from_jax import load_jax_params
from sie_tpu_torch.models.layers import FullAttentionLayer
from sie_tpu_torch.ops.attention import (attention_bwd_plain,
                                         attention_bwd_plain_chunked,
                                         attention_plain,
                                         attention_plain_chunked,
                                         dropout_keep, fused_attention)

# f32: summation order only; bf16: the blocked kernel's online softmax
# rounds unnormalised probabilities to bf16, and the outputs and gradients
# are bf16 (one ulp of an O(1) value is 2^-8), as the full-row tests
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}   # x max|want|
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("t,dk,blk", [(64, 16, 64), (150, 32, 64),
                                      (129, 16, 32)])
def test_matches_the_blocked_pallas_kernels(t, dk, blk, rate, dtype):
    """Forward (K7) and the gradients (K8a: dQ, K8b: dK, dV) of the JAX
    package's kv-blocked variant, forced by block_kv, in interpret mode."""
    q, k, v, do = _arrays(t + dk + blk, *[(3, t, dk)] * 4)
    scale, seed = 1.0 / np.sqrt(dk), 2024
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    out = fused_attention(tq, tk, tv, scale, rate, seed)
    out.backward(torch.from_numpy(do).to(dtype))
    jseed = jnp.asarray([seed], jnp.int32)
    want, vjp = jax.vjp(lambda a, b, c: jax_fused(a, b, c, jseed, scale, rate,
                                                  True, blk),
                        *(jnp.asarray(a, JNP[dtype]) for a in (q, k, v)))
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad),
                            vjp(jnp.asarray(do, JNP[dtype]))):
        assert got.dtype == dtype, name
        w = np.asarray(w.astype(jnp.float32))
        tol = GRAD_TOL[dtype] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got.float().numpy(), w, atol=tol, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_chunked_plain_versions_equal_the_plain_ones(rate, dtype):
    """Query-row chunks give the plain versions' values; a slice of heads
    with its offset bh0 gives those heads of the full call (the dropout
    hash keys on the global (batch, head) row)."""
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _arrays(5, *[(5, 75, 16)] * 4))
    scale, seed, bh0 = 0.25, 31, 2
    full = attention_plain(q, k, v, scale, rate, seed)
    part = attention_plain_chunked(q[bh0:], k[bh0:], v[bh0:], scale, rate,
                                   seed, bh0=bh0, chunk=16)
    np.testing.assert_allclose(part.float().numpy(),
                               full[bh0:].float().numpy(), atol=TOL[dtype],
                               rtol=0)
    assert torch.equal(attention_plain_chunked(q, k, v, scale, rate, seed,
                                               chunk=75), full)
    grads = attention_bwd_plain(q, k, v, do, scale, rate, seed)
    parts = attention_bwd_plain_chunked(q[bh0:], k[bh0:], v[bh0:], do[bh0:],
                                        scale, rate, seed, bh0=bh0, chunk=16)
    for name, g, p in zip("qkv", grads, parts):
        w = g[bh0:].float().numpy()
        tol = GRAD_TOL[dtype] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(p.float().numpy(), w, atol=tol, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_past_2_16_is_the_pallas_mask(rate):
    """At T = 17984 a row times 0x27D4EB2F wraps uint32 from row 7 on; rows
    and columns past 2^16 and a large (batch, head) index, bit for bit."""
    for seed, bh, row0, col0 in ((5, 63, 17960, 17900), (-3, 40000, 70000,
                                                         131000),
                                 (2 ** 31 - 1, 7, 65530, 65500)):
        want = np.asarray(_dropout_mask((24, 40), rate, jnp.int32(seed),
                                        jnp.int32(bh), row0, col0))
        got = dropout_keep(seed, bh, torch.arange(row0, row0 + 24)[:, None],
                           torch.arange(col0, col0 + 40)[None, :], rate)
        np.testing.assert_array_equal(got.numpy(), want)


def test_layer_gate_above_4096_takes_the_fused_path(monkeypatch):
    """fused_attention_max_len=0 at T = 4100: the JAX layer runs its
    kv-blocked kernels (interpret mode), the port's layer its fused branch
    (on the card K5; here its plain version); the default 4096 sends both to
    plain attention."""
    t, d, h = 4100, 16, 2
    (x,) = _arrays(41, (1, t, d))
    jl = JLayer(d, h, use_fused=True, fused_max_len=0)
    params = jax.tree.map(np.asarray, jl.init(jax.random.key(0),
                                              *[jnp.asarray(x)] * 3)["params"])
    want = np.asarray(jl.apply({"params": params}, *[jnp.asarray(x)] * 3))
    port = FullAttentionLayer(d, h, torch.float32, torch.Generator(),
                              use_fused=True, fused_max_len=0)
    load_jax_params(port, params)
    assert port.uses_kernel(t, t, d // h)
    calls = []
    monkeypatch.setattr(layers_mod, "fused_attention",
                        lambda *a: calls.append(1) or fused_attention(*a))
    with torch.inference_mode():
        got = port(*[torch.from_numpy(x)] * 3).numpy()
    assert calls == [1]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    gated = FullAttentionLayer(d, h, torch.float32, torch.Generator(),
                               use_fused=True)
    assert not gated.uses_kernel(t, t, d // h)
    assert gated.uses_kernel(4096, 4096, d // h)
