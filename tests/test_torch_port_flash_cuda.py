"""The flash kernels K9, K10b and K10a (sie_tpu_torch/ops/flash.py) against
their plain versions on the card, at small and edge shapes, and the launch
counts of the flagship with `use_flash_attention`. Every test here is
marked `cuda` and skips without a card (a CUDA kernel has no CPU mode);
this file imports no JAX:

    python -m pytest tests/test_torch_port_flash_cuda.py -q

Limits x max|want|: 2e-2, K6's bf16 limit (bf16 outputs, the online
softmax's rounding of unnormalised probabilities, di from the bf16
output), with max|want| at least 1e-4; the row log-sum-exp within
1e-3."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from sie_tpu_torch.ops import flash

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def time_limit():
    """Ends the run if one test passes 300 s: a kernel that hangs blocks
    inside the CUDA runtime, where no exception or pytest hook reaches it."""
    def expire():
        print("test ran past 300 s: a kernel hangs", file=sys.stderr,
              flush=True)
        os._exit(1)
    timer = threading.Timer(300.0, expire)
    timer.daemon = True
    timer.start()
    yield
    timer.cancel()


def _normal(seed, device, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(device=device, dtype=torch.bfloat16) for s in shapes]


def _close(got, want, what):
    # floor 1e-4: at T 1 dQ and dK are 0 in exact arithmetic (one key, p =
    # 1, dP = di) and only f32 rounding noise (~1e-7)
    scl = max(float(want.float().abs().max()), 1e-4)
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL * scl, (what, err, scl)


@pytest.mark.parametrize("dk", [64, 128, 256])
@pytest.mark.parametrize("t", [1, 64, 65, 96, 105, 127, 128, 129, 192, 193,
                               255, 256, 257, 2048, 2049, 4097])
def test_kernels_match_plain(card, t, dk):
    """K9's output and log-sum-exp, K10b's dK, dV and di, K10a's dQ, with
    T at the edges of the 64-row tiles and of the blocks of 64 rows or
    keys a consumer warpgroup (K9: 128; K10b 192 at dk 64, K10a 128 there
    up to T 2048 and 192 past it; both 128 at dk 128; T <= 64: a block's second consumer has no real rows or keys;
    129, 193, 257: the last block's last consumers have none), at K10b's
    dk 256 split (65, 96: the last query tile has no rows in the second
    consumer's 32 columns), where the rings wrap (129: K10b's two stages
    at dk 256; 257: its four, and K10a's eight slots), at K10a's switch at
    dk 64 (T <= 2048: two blocks an SM, 128 rows a block, key tiles in
    halves; 2049: three consumers), under them and past 4096; two
    backward runs equal bit for bit."""
    bh = 3
    q, k, v, do = _normal(t + dk, card, *[(bh, t, dk)] * 4)
    scale = 1.0 / dk ** 0.5
    o, lse = flash.flash_fwd(q, k, v, scale, want_lse=True)
    dkk, dv, delta = flash.flash_attention_bwd_dkv(q, k, v, o, do, lse, scale)
    dq = flash.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    _close(o, flash.flash_attention_plain(q, k, v, scale), "out")
    assert float((lse - flash.flash_lse_plain(q, k, scale)).abs().max()) \
        <= 1e-3
    want_d = flash.flash_delta_plain(o, do)
    _close(delta, want_d, "di")
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dkk, dv),
                               flash.flash_attention_bwd_plain(
                                   q, k, v, do, want_d, scale)):
        _close(got, want, name)
    again = flash.flash_attention_bwd_dkv(q, k, v, o, do, lse, scale)
    assert all(torch.equal(a, b) for a, b in zip((dkk, dv, delta), again))
    assert torch.equal(dq, flash.flash_attention_bwd_dq(q, k, v, do, lse,
                                                        delta, scale))


@pytest.mark.parametrize("dk", [64, 128, 256])
def test_forward_odd_heads_and_twice(card, dk):
    """K9 at BH 13 (a prime: no block count of the grid's fold divides it)
    and T 300 (three 128-row blocks, the last with 44 rows): output and
    log-sum-exp against the plain versions, and two runs bit-equal."""
    q, k, v = _normal(dk, card, *[(13, 300, dk)] * 3)
    scale = 1.0 / dk ** 0.5
    o, lse = flash.flash_fwd(q, k, v, scale, want_lse=True)
    o2, lse2 = flash.flash_fwd(q, k, v, scale, want_lse=True)
    torch.cuda.synchronize()
    _close(o, flash.flash_attention_plain(q, k, v, scale), "out")
    assert float((lse - flash.flash_lse_plain(q, k, scale)).abs().max()) \
        <= 1e-3
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(flash.flash_fwd(q, k, v, scale)[0], o)


def test_autograd_launches_k9_then_k10b_and_k10a(card):
    """`flash_attention` forward launches K9, its backward K10b then K10a,
    and the gradients are the wrappers' own; an unaligned view is copied
    for TMA and gives the same output."""
    q, k, v, do = _normal(7, card, *[(4, 300, 64)] * 4)
    q, k, v = (z.requires_grad_() for z in (q, k, v))
    before = (flash.flash_attention.launches,
              flash.flash_attention_bwd_dkv.launches,
              flash.flash_attention_bwd_dq.launches)
    out = flash.flash_attention(q, k, v, 0.125)
    out.backward(do)
    after = (flash.flash_attention.launches,
             flash.flash_attention_bwd_dkv.launches,
             flash.flash_attention_bwd_dq.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    o, lse = flash.flash_fwd(q.detach(), k.detach(), v.detach(), 0.125, True)
    assert torch.equal(out, o)
    dkk, dv, delta = flash.flash_attention_bwd_dkv(
        q.detach(), k.detach(), v.detach(), o, do, lse, 0.125)
    assert torch.equal(k.grad, dkk) and torch.equal(v.grad, dv)
    buf = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=card)
    shifted = buf[1:].view(q.shape)   # 2 bytes past an aligned address
    shifted.copy_(q.detach())
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(flash.flash_attention(shifted, k.detach(), v.detach(),
                                             0.125), o)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    z = lambda *s, dt=torch.bfloat16: torch.zeros(s, dtype=dt, device=card)
    for bad in ((z(2, 8, 32),) * 3, (z(2, 8, 64, dt=torch.float32),) * 3,
                (z(2, 8, 64), z(2, 8, 64).cpu(), z(2, 8, 64))):
        with pytest.raises(ValueError):
            flash.flash_attention(*bad, 0.125)


def test_flash_flagship_step_launches(card):
    """One training step of the flagship (InterpGN + Transformer, T 845,
    d_model 512, 8 heads, 2 layers, amp) with the flag, B 8: K1 6, K2 6,
    K9 2, K10b 2, K10a 2, and no K5 or K6; in eval K9 2 and no K10."""
    from sie_tpu_torch.config import Config
    from sie_tpu_torch.ops.attention import attention_bwd, fused_attention
    from sie_tpu_torch.ops.shapelet_l1 import (l1_sliding_distance,
                                               l1_sliding_distance_bwd)
    from sie_tpu_torch.train.trainer import Trainer
    cfg = Config(model="InterpGN", dnn_type="Transformer", seq_len=845,
                 enc_in=122, num_class=3, num_shapelet=10, d_model=512,
                 d_ff=2048, n_heads=8, e_layers=2, dropout=0.0, amp=True,
                 seed=0, batch_size=8, use_flash_attention=True)
    fns = {"K1": l1_sliding_distance, "K2": l1_sliding_distance_bwd,
           "K5": fused_attention, "K6": attention_bwd,
           "K9": flash.flash_attention,
           "K10a": flash.flash_attention_bwd_dq,
           "K10b": flash.flash_attention_bwd_dkv}
    read = lambda: {n: f.launches for n, f in fns.items()}
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(8, 845, 122)).astype(np.float32),
             rng.integers(0, 3, 8).astype(np.int32),
             np.ones((8, 845), np.float32), np.ones(8, np.float32))
    trainer = Trainer(cfg, 1, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    c0 = read()
    loss, _ = trainer.train_step(batch, 1.0)
    got = {n: v - c0[n] for n, v in read().items()}
    assert got == {"K1": 6, "K2": 6, "K5": 0, "K6": 0, "K9": 2, "K10a": 2,
                   "K10b": 2}, got
    assert np.isfinite(float(loss))
    c0 = read()
    trainer.eval_step(batch)
    got = {n: v - c0[n] for n, v in read().items()}
    assert got == {"K1": 6, "K2": 0, "K5": 0, "K6": 0, "K9": 2, "K10a": 0,
                   "K10b": 0}, got
