"""sie_tpu_torch fused attention (K5's plain version and wrapper) vs the JAX
package's Pallas kernel run in interpret mode, on the CPU. The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_port_kernels.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sie_tpu.ops.pallas.attention_pallas import fused_attention as jax_fused
from sie_tpu_torch.ops.attention import attention_plain, fused_attention

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


def test_dropout_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 2, 8, 4))
    with pytest.raises(ValueError, match="dropout"):
        fused_attention(q, k, v, 0.5, rate=0.1)
    with pytest.raises(ValueError, match="dropout"):
        attention_plain(q, k, v, 0.5, rate=0.1)


def test_wrapper_rejects_bad_input():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 4))
    with pytest.raises(ValueError):
        fused_attention(q, k[:, :4], v, 0.5)
    with pytest.raises(ValueError):
        fused_attention(q, k.to(torch.bfloat16), v, 0.5)
    with pytest.raises(ValueError):
        fused_attention(q.double(), k.double(), v.double(), 0.5)


def test_cpu_path_launches_no_kernel():
    before = fused_attention.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 8, 4))
    fused_attention(q, k, v, 0.5)
    assert fused_attention.launches == before


def test_wrapper_refuses_non_contiguous_on_every_device():
    q = torch.zeros((1, 8, 2, 4)).transpose(1, 2).reshape(2, 8, 4)
    assert not q.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(q, q, q, 0.5)
