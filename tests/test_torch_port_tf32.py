"""The numerics the f32 attention kernels rest on, emulated on the CPU.

K5's and K6's f32 paths take every product on the tensor cores as three
TF32 products of split operands (3xTF32: big = x rounded to TF32, small = x
- big cut to TF32; a b ~ big_a big_b + big_a small_b + small_a big_b,
summed in f32), as `split_tf32` in csrc/attention_common.cuh computes them:
round to nearest, ties away from zero (PTX `cvt.rna.tf32.f32`), and
truncation, on 10 mantissa bits. Both are emulated here in torch, and
`torch.matmul` is replaced by the split product while the plain versions
`attention_plain` and `attention_bwd_plain` run, so that their own
arithmetic is what is measured.
The results must meet the kernels' f32 limits against float64 (K5 1e-4
absolute, K6 1e-4 x max|want|). A single TF32 product at the same shapes is
printed beside them. The fragment layouts of `mma.m16n8k8` and the permuted
key order that makes a score accumulator the next product's A operand are
emulated too.
"""

import numpy as np
import pytest
import torch

from sie_tpu_torch.ops import attention as attn

F32_TOL = 1e-4   # K5 absolute; K6 x max|want| (chip_smoke.py K5_TOL, K6_TOL)
_matmul = torch.matmul   # the f32 product, before a test replaces it


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as `cvt.rna.tf32.f32` does: the 13 low mantissa
    bits dropped, rounding half away from zero (on the magnitude bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """x truncated to TF32: the 13 low mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """(big, small) of `split_tf32`."""
    big = tf32(x)
    return big, tf32_cut(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 products summed in f32, small ones first."""
    (ab, sa), (bb, sb) = split(a), split(b)
    return _matmul(sa, bb) + _matmul(ab, sb) + _matmul(ab, bb)


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _matmul(tf32(a), tf32(b))


def _inputs(seed, bh=2, t=70, dk=32, n=4):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(bh, t, dk)).astype(np.float32))
            for _ in range(n)]


def _reference(q, k, v, do, scale, rate, seed):
    """Forward output and (dQ, dK, dV) in float64, dropout mask from the
    port's hash."""
    q, k, v, do = (z.double() for z in (q, k, v, do))
    a = torch.softmax(_matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    ad, da = a, _matmul(do, v.transpose(-1, -2))
    if rate > 0.0:
        keep = attn._keep(seed, q.shape[0], q.shape[1], rate, q.device)
        ad = torch.where(keep, a / (1.0 - rate), 0.0)
        da = torch.where(keep, da / (1.0 - rate), 0.0)
    ds = a * (da - (da * a).sum(-1, keepdim=True)) * scale
    return (_matmul(ad, v), (_matmul(ds, k), _matmul(ds.transpose(-1, -2), q),
                             _matmul(ad.transpose(-1, -2), do)))


def _errors(monkeypatch, mm, q, k, v, do, scale, rate, seed):
    """(forward max abs error, backward max errors x max|want|) of the plain
    versions with torch.matmul replaced by mm."""
    want_o, want_g = _reference(q, k, v, do, scale, rate, seed)
    with monkeypatch.context() as m:
        m.setattr(torch, "matmul", mm)
        out = attn.attention_plain(q, k, v, scale, rate, seed)
        grads = attn.attention_bwd_plain(q, k, v, do, scale, rate, seed)
    e_fwd = float((out.double() - want_o).abs().max())
    e_bwd = max(float((g.double() - w).abs().max() / w.abs().max())
                for g, w in zip(grads, want_g))
    return e_fwd, e_bwd


def test_tf32_rounding_keeps_ten_mantissa_bits_ties_away_from_zero():
    one = 1.0
    ulp = 2.0 ** -10                 # a TF32 step at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0,
                         -0.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    big = tf32(r)
    assert torch.equal(big.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(big, dtype=torch.int32))
    assert float(((r - big) / r).abs().max()) <= 2.0 ** -11
    # the split: x - big is exact, and the cut small leaves under 2^-21 of
    # |x|
    big, small = split(r)
    assert torch.equal(small.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(small, dtype=torch.int32))
    assert float(((r - big - small) / r).abs().max()) <= 2.0 ** -21


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t,dk", [(70, 32), (130, 64)])
def test_3xtf32_meets_the_f32_limits_and_1xtf32_does_not(monkeypatch, t, dk,
                                                          rate):
    q, k, v, do = _inputs(21, t=t, dk=dk)
    # scores of several units, as trained projections give: the
    # exponentials then amplify a score error the most
    q, k = q * 2.0, k * 2.0
    scale, seed = 1.0 / np.sqrt(dk), 5
    args = (q, k, v, do, scale, rate, seed)
    f32 = _errors(monkeypatch, _matmul, *args)
    three = _errors(monkeypatch, mm_3xtf32, *args)
    one = _errors(monkeypatch, mm_1xtf32, *args)
    print(f"T={t} dk={dk} rate {rate}: forward max abs err / backward max "
          f"err x max|want| against float64: f32 {f32[0]:.2e} / "
          f"{f32[1]:.2e}, 3xTF32 {three[0]:.2e} / {three[1]:.2e}, one TF32 "
          f"product {one[0]:.2e} / {one[1]:.2e}")
    assert three[0] <= F32_TOL and three[1] <= F32_TOL
    # the split stays within a few times plain f32's own rounding
    assert three[0] <= 10 * f32[0] + 1e-6 and three[1] <= 10 * f32[1] + 1e-6
    # one TF32 product misses the limits by an order of magnitude here
    assert one[0] > 10 * F32_TOL or one[1] > 10 * F32_TOL


def _mma_m16n8k8(c, a, b):
    """One warp's mma.m16n8k8 (tf32 operands as floats) on per-lane
    fragments, by the PTX ISA layouts: lane = 4 g + i; A holds (g, i),
    (g+8, i), (g, i+4), (g+8, i+4); B (row i, col g), (row i+4, col g); C
    (g, 2i), (g, 2i+1), (g+8, 2i), (g+8, 2i+1)."""
    A, B, C = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    for lane in range(32):
        g, i = divmod(lane, 4)
        A[g, i], A[g + 8, i], A[g, i + 4], A[g + 8, i + 4] = a[lane]
        B[i, g], B[i + 4, g] = b[lane]
        C[g, 2 * i], C[g, 2 * i + 1], C[g + 8, 2 * i], C[g + 8, 2 * i + 1] = \
            c[lane]
    D = C + A @ B
    return [(D[g, 2 * i], D[g, 2 * i + 1], D[g + 8, 2 * i],
             D[g + 8, 2 * i + 1]) for g, i in (divmod(lane, 4)
                                               for lane in range(32))]


@pytest.mark.parametrize("dkp", [16, 32, 64, 128])
def test_permuted_key_order_makes_the_score_tile_the_next_a_operand(dkp):
    """The f32 kernels' fragment reads, as attention_common.cuh writes them,
    on one warp's 16 query rows and one 64-key tile staged with row stride
    dkp + 4: S = Q K^T from `load_a_f32` / `mma_bt_f32`, then O = S V with
    `acc_a_f32` (accumulator (c0, c1, c2, c3) read as A (c0, c2, c1, c3)) and
    `mma_b_f32` (V rows 2i and 2i + 1 of each 8-key step). Both reads hit 32
    distinct shared-memory banks."""
    ld = dkp + 4
    rng = np.random.default_rng(dkp)
    q, k, v = (rng.normal(size=(r, dkp)) for r in (16, 64, 64))
    qs, ks, vs = (np.zeros(r * ld) for r in (16, 64, 64))
    for tile, m in ((qs, q), (ks, k), (vs, v)):
        for r in range(len(m)):
            tile[r * ld:r * ld + dkp] = m[r]
    lanes = [divmod(lane, 4) for lane in range(32)]
    s = [[(0.0,) * 4] * 32 for _ in range(8)]
    for kk in range(dkp // 8):
        a = [(qs[g * ld + kk * 8 + i], qs[(g + 8) * ld + kk * 8 + i],
              qs[g * ld + kk * 8 + i + 4], qs[(g + 8) * ld + kk * 8 + i + 4])
             for g, i in lanes]
        for nt in range(8):
            b = [(ks[(nt * 8 + g) * ld + kk * 8 + i],
                  ks[(nt * 8 + g) * ld + kk * 8 + i + 4]) for g, i in lanes]
            s[nt] = _mma_m16n8k8(s[nt], a, b)

    def full(tiles):
        out = np.zeros((16, 8 * len(tiles)))
        for nt, c in enumerate(tiles):
            for (g, i), e in zip(lanes, c):
                out[g, nt * 8 + 2 * i], out[g, nt * 8 + 2 * i + 1], \
                    out[g + 8, nt * 8 + 2 * i], \
                    out[g + 8, nt * 8 + 2 * i + 1] = e
        return out

    np.testing.assert_allclose(full(s), q @ k.T, rtol=0, atol=1e-12)
    o = [[(0.0,) * 4] * 32 for _ in range(dkp // 8)]
    for kk in range(8):
        a = [(c[0], c[2], c[1], c[3]) for c in s[kk]]
        for dn in range(dkp // 8):
            b = [(vs[(kk * 8 + 2 * i) * ld + dn * 8 + g],
                  vs[(kk * 8 + 2 * i + 1) * ld + dn * 8 + g])
                 for g, i in lanes]
            o[dn] = _mma_m16n8k8(o[dn], a, b)
    np.testing.assert_allclose(full(o), (q @ k.T) @ v, rtol=0, atol=1e-9)
    for addr in (lambda g, i: g * ld + i, lambda g, i: 2 * i * ld + g,
                 lambda g, i: (2 * i + 1) * ld + g):
        assert len({addr(g, i) % 32 for g, i in lanes}) == 32
