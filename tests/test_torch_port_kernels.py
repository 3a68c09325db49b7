"""The CUDA kernels of sie_tpu_torch against their plain versions, on the
card. Every test here is marked `cuda` and skips without a card (a CUDA
kernel has no CPU mode); this file imports no JAX, so it also runs where
only PyTorch is installed:

    python -m pytest tests/test_torch_port_kernels.py -q
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from sie_tpu_torch.ops.attention import (attention_bwd, attention_bwd_plain,
                                         attention_bwd_plain_chunked,
                                         attention_fwd, attention_plain,
                                         attention_plain_chunked,
                                         fused_attention)
from sie_tpu_torch.ops.shapelet_l1 import (l1_sliding_distance,
                                           l1_sliding_distance_bwd,
                                           l1_sliding_distance_bwd_plain,
                                           l1_sliding_distance_grouped,
                                           l1_sliding_distance_grouped_bwd,
                                           l1_sliding_distance_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def time_limit():
    """Ends the run if one test passes 300 s: a kernel that hangs blocks
    inside the driver, where no exception or pytest hook reaches it."""
    def expire():
        print("test ran past 300 s: a kernel hangs", file=sys.stderr,
              flush=True)
        os._exit(1)
    timer = threading.Timer(300.0, expire)
    timer.daemon = True
    timer.start()
    yield
    timer.cancel()


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in shapes]


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
# T=600, then the tiling's edges (shapelet_common.cuh): W at 2048 windows
# (WT_MAX, where a row splits into segments) and one either side, and at
# 1024 (a block's 128 items of 8 windows on one row) and one either side;
# the flagship's shortest and longest banks, an EigenWorms-shaped
# polyphase component, and 21 rows (two chunks)
@pytest.mark.parametrize("n,l,t", [(2, 7, 600), (10, 300, 600), (21, 5, 600),
                                   (3, 600, 600), (3, 5, 2051), (3, 5, 2052),
                                   (3, 5, 2053), (2, 9, 1031), (2, 9, 1032),
                                   (2, 9, 1033), (10, 43, 845),
                                   (10, 676, 845), (10, 1598, 1998),
                                   (21, 43, 845)])
def test_k1_matches_plain(card, metric, n, l, t):
    x, s = (a.to(card) for a in _normal(9, (2, 5, t), (n, 5, l)))
    before = l1_sliding_distance.launches
    got = l1_sliding_distance(x, s, metric)
    torch.cuda.synchronize()
    assert l1_sliding_distance.launches == before + 1
    want = l1_sliding_distance_plain(x, s, metric)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4   # f32 summation order


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,dk", [(40, 16), (130, 64), (300, 8), (70, 128)])
def test_k5_matches_plain(card, dtype, t, dk):
    q, k, v = (a.to(card, dtype) for a in _normal(3, *[(4, t, dk)] * 3))
    scale = 1.0 / np.sqrt(dk)
    before = fused_attention.launches
    got = fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    want = attention_plain(q, k, v, scale)
    # bf16: output rounding and the online softmax's rounding order
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
# T=600, then the tiling's edges (shapelet_common.cuh): W at 1024 windows
# (QMAX quads, where a row splits into passes) and one either side, L at a
# multiple of TPT taps and one either side; the flagship's shortest and
# longest banks, an EigenWorms-shaped polyphase component, and 21 rows
@pytest.mark.parametrize("b,n,l,t", [(2, 2, 7, 600), (5, 10, 300, 600),
                                     (3, 21, 5, 600), (64, 3, 600, 600),
                                     (3, 4, 7, 1029), (3, 4, 7, 1030),
                                     (3, 4, 7, 1031), (2, 3, 99, 400),
                                     (2, 3, 100, 400), (2, 3, 101, 400),
                                     (4, 10, 43, 845), (4, 10, 676, 845),
                                     (2, 10, 1598, 1998), (3, 21, 43, 845)])
def test_k2_matches_plain(card, metric, b, n, l, t):
    x, s, g = (a.to(card) for a in _normal(8, (b, 5, t), (n, 5, l),
                                           (b, n, 5, t + 1 - l)))
    before = l1_sliding_distance_bwd.launches
    got = l1_sliding_distance_bwd(x, s, g, metric)
    torch.cuda.synchronize()
    assert l1_sliding_distance_bwd.launches == before + 1
    want = l1_sliding_distance_bwd_plain(x, s, g, metric)
    # f32 sums of up to b * W terms in another order
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    again = l1_sliding_distance_bwd(x, s, g, metric)
    assert torch.equal(got, again)   # deterministic: no atomics


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# ragged key and query tiles at every padded width: dk 48 is zero-filled to
# 64 by TMA (bf16) or cp.async (f32), dk 30 is staged element by element
@pytest.mark.parametrize("t,dk", [(40, 16), (130, 64), (300, 8), (70, 128),
                                  (70, 32), (200, 32), (200, 128), (70, 30),
                                  (200, 48)])
def test_k5_with_dropout_and_k6_match_plain(card, dtype, t, dk, rate):
    q, k, v, do = (a.to(card, dtype) for a in _normal(4, *[(4, t, dk)] * 4))
    scale, seed = 1.0 / np.sqrt(dk), 77
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    qg, kg, vg = (z.clone().requires_grad_() for z in (q, k, v))
    before = fused_attention.launches, attention_bwd.launches
    out = fused_attention(qg, kg, vg, scale, rate, seed)
    want = attention_plain(q, k, v, scale, rate, seed)
    assert float((out.float() - want.float()).abs().max()) <= tol
    out.backward(do)
    torch.cuda.synchronize()
    assert (fused_attention.launches, attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for got, w in zip((qg.grad, kg.grad, vg.grad),
                      attention_bwd_plain(q, k, v, do, scale, rate, seed)):
        assert got.dtype == dtype
        lim = tol * max(1.0, float(w.float().abs().max()))
        assert float((got.float() - w.float()).abs().max()) <= lim


# the bf16 kernels' wgmma tiling: T a whole number of 64-row tiles, T below
# one tile, the 8 (batch, head) rows of a 1-row flagship request, dk 30
# (no TMA: staged element by element into the swizzled layout), dk 8 and
# 48 (zero-filled to 64 by TMA), dk 128 (two 64-column panels), and dk 64
# in tensors 2 bytes off 16-byte alignment (no TMA)
WGMMA_CASES = {"t128": (4, 128, 64), "t256": (2, 256, 64), "t1": (4, 1, 64),
               "t17": (4, 17, 64), "bh8_t845": (8, 845, 64),
               "dk30": (4, 130, 30), "dk8": (4, 100, 8), "dk48": (4, 200, 48),
               "dk128": (4, 130, 128), "dk64_unaligned": (4, 130, 64)}


def _unaligned(x):
    """x in a contiguous tensor that starts 2 bytes past a 16-byte
    boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return flat[1:].view(x.shape).copy_(x)


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
def test_bf16_wgmma_tiling_matches_plain(card, case, rate):
    bh, t, dk = WGMMA_CASES[case]
    q, k, v, do = (a.to(card, torch.bfloat16)
                   for a in _normal(21, *[(bh, t, dk)] * 4))
    if case.endswith("unaligned"):
        q, k, v, do = (_unaligned(z) for z in (q, k, v, do))
        assert q.is_contiguous() and q.data_ptr() % 16 == 2
    scale, seed, tol = 1.0 / np.sqrt(dk), 31, 2e-2
    before = fused_attention.launches, attention_bwd.launches
    out, lse = attention_fwd(q, k, v, scale, rate, seed, want_lse=True)
    want = attention_plain(q, k, v, scale, rate, seed)
    assert float((out.float() - want.float()).abs().max()) <= tol
    got = attention_bwd(q, k, v, out, do, lse, scale, rate, seed)
    again = attention_bwd(q, k, v, out, do, lse, scale, rate, seed)
    torch.cuda.synchronize()
    assert (fused_attention.launches, attention_bwd.launches) == \
        (before[0] + 1, before[1] + 2)
    for a, w in zip(got, attention_bwd_plain(q, k, v, do, scale, rate, seed)):
        lim = tol * max(1.0, float(w.float().abs().max()))
        assert float((a.float() - w.float()).abs().max()) <= lim
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_k5_and_k6_f32_dropout_hash_through_the_outputs(card):
    """Rate 0.1 at T = 130: the f32 kernels read each 8-key step in a
    permuted order, and the hash must still see the true key column; a
    mismatched keep bit moves an output by ~|p v| / 0.9, far above 1e-4.
    The backward is deterministic: a second call equals the first."""
    t, dk, rate, seed = 130, 64, 0.1, 2024
    q, k, v, do = (a.to(card) for a in _normal(16, *[(4, t, dk)] * 4))
    scale = 1.0 / np.sqrt(dk)
    out, lse = attention_fwd(q, k, v, scale, rate, seed, want_lse=True)
    want = attention_plain(q, k, v, scale, rate, seed)
    assert float((out - want).abs().max()) <= 1e-4
    assert float((out - attention_plain(q, k, v, scale, rate, seed + 1))
                 .abs().max()) > 1e-2   # the hash is live
    got = attention_bwd(q, k, v, out, do, lse, scale, rate, seed)
    for a, w in zip(got, attention_bwd_plain(q, k, v, do, scale, rate, seed)):
        lim = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((a - w).abs().max()) <= lim
    again = attention_bwd(q, k, v, out, do, lse, scale, rate, seed)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


GROUPED_CASES = {   # (B, C, T, ((n, L) of each bank, ascending L))
    "jax_test": (3, 7, 60, ((4, 5), (3, 11), (2, 23))),
    "flagship_like": (5, 3, 300, ((10, 15), (10, 30), (10, 60), (10, 90),
                                  (10, 150), (10, 240))),
    "equal_lengths_and_17_rows": (2, 4, 80, ((17, 9), (3, 9), (1, 70))),
    "flagship_lengths": (3, 4, 845, ((10, 43), (10, 85), (10, 169),
                                     (10, 254), (10, 423), (10, 676))),
}


@pytest.mark.parametrize("case", sorted(GROUPED_CASES))
def test_k3_and_k4_equal_k1_and_k2_bit_for_bit(card, case):
    """The grouped kernels run K1's and K2's per-block code over one grid,
    with K2's batch chunk per bank: the same values, bit for bit."""
    b, c, t, spec = GROUPED_CASES[case]
    x, *banks = _normal(12, (b, c, t), *[(n, c, l) for n, l in spec])
    gs = _normal(13, *[(b, n, c, t - l + 1) for n, l in spec])
    x, banks, gs = x.to(card), [s.to(card) for s in banks], \
        [g.to(card) for g in gs]
    before = (l1_sliding_distance_grouped.launches,
              l1_sliding_distance_grouped_bwd.launches)
    outs = l1_sliding_distance_grouped(x, banks)
    grads = l1_sliding_distance_grouped_bwd(x, banks, gs)
    torch.cuda.synchronize()
    assert (l1_sliding_distance_grouped.launches,
            l1_sliding_distance_grouped_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for s, g, d, gr in zip(banks, gs, outs, grads):
        assert torch.equal(d, l1_sliding_distance(x, s))
        assert torch.equal(gr, l1_sliding_distance_bwd(x, s, g))
    again = l1_sliding_distance_grouped_bwd(x, banks, gs)
    assert all(torch.equal(a, z) for a, z in zip(grads, again))


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_and_k6_past_4096_match_the_chunked_plain_versions(card, dtype,
                                                              rate):
    """T = 5000: the length at which the JAX package switches to its
    kv-blocked kernels (K7, K8a, K8b); rows and columns past 2^12 in the
    dropout hash."""
    t, dk = 5000, 64
    q, k, v, do = (a.to(card, dtype) for a in _normal(14, *[(2, t, dk)] * 4))
    scale, seed = 1.0 / np.sqrt(dk), 99
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    out, lse = attention_fwd(q, k, v, scale, rate, seed, want_lse=True)
    want = attention_plain_chunked(q, k, v, scale, rate, seed)
    # x max|want|: over 5000 keys a typical |o| is ~0.02, about the absolute
    # limit of the short tests; in bf16 this is 2.5 or more rounding steps
    # of the largest output
    lim = tol * float(want.float().abs().max())
    assert float((out.float() - want.float()).abs().max()) <= lim
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if dtype == torch.bfloat16:
        s = s.to(torch.bfloat16).float()
    assert float((lse - torch.logsumexp(s * scale, dim=-1)).abs().max()) \
        <= 1e-3
    got = attention_bwd(q, k, v, out, do, lse, scale, rate, seed)
    want = attention_bwd_plain_chunked(q, k, v, do, scale, rate, seed)
    for a, w in zip(got, want):
        lim = tol * float(w.float().abs().max())   # as chip_smoke.py's
        assert float((a.float() - w.float()).abs().max()) <= lim


def test_gradients_exist_on_the_card_and_equal_the_plain_path(card):
    """The serving slice filled kernel outputs through ctypes, so autograd
    saw no graph; the bank and the attention inputs now get gradients."""
    x, s = (a.to(card) for a in _normal(5, (3, 4, 90), (2, 4, 11)))
    s.requires_grad_()
    l1_sliding_distance(x, s).square().sum().backward()
    s_cpu = s.detach().cpu().requires_grad_()
    l1_sliding_distance(x.cpu(), s_cpu).square().sum().backward()
    assert s.grad is not None
    assert float((s.grad.cpu() - s_cpu.grad).abs().max()) <= 1e-4
    q = _normal(6, (2, 50, 16))[0]
    qc, qd = q.clone().requires_grad_(), q.to(card).requires_grad_()
    fused_attention(qd, qd, qd, 0.25).square().sum().backward()
    fused_attention(qc, qc, qc, 0.25).square().sum().backward()
    assert qd.grad is not None
    assert float((qd.grad.cpu() - qc.grad).abs().max()) <= 1e-4


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x, s = (a.to(card) for a in _normal(1, (2, 3, 40), (2, 3, 5)))
    with pytest.raises(ValueError):
        l1_sliding_distance(x.double(), s.double())
    with pytest.raises(ValueError):
        l1_sliding_distance(x.transpose(1, 2).contiguous().transpose(1, 2), s)
    q = torch.zeros((2, 8, 256), device=card)
    with pytest.raises(ValueError):
        fused_attention(q, q, q, 1.0)            # dk > 128
    with pytest.raises(ValueError):
        fused_attention(q.cpu(), q, q, 1.0)      # mixed devices
