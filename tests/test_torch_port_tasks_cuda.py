"""The card's side of `--stream_from_disk` and the forecast tasks: the
pinned prefetcher gives the batches a plain copy gives; K5 and K6 at the
Transformer forecaster's encoder shape at seq_len 336 (BH 256 = 32 rows
x 8 heads, T 336, dk 64, bf16, rates 0 and 0.1) against their plain
versions (2e-2, the limits of test_torch_port_kernels.py); and one
forecaster step at seq_len 336 that launches K5 once and K6 once a
layer. Every test is marked `cuda` and skips without a card; this file
imports no JAX:

    python -m pytest --noconftest tests/test_torch_port_tasks_cuda.py -q
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from sie_tpu_torch.config import Config
from sie_tpu_torch.data.stream import prefetch_to_device
from sie_tpu_torch.ops.attention import (attention_bwd, attention_bwd_plain,
                                         attention_plain, fused_attention)

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
    in the CUDA runtime, where no exception or pytest hook reaches it."""
    def expire():
        print("test ran past 300 s: a kernel hangs", file=sys.stderr,
              flush=True)
        os._exit(1)
    timer = threading.Timer(300.0, expire)
    timer.daemon = True
    timer.start()
    yield
    timer.cancel()


def test_pinned_prefetch_equals_a_plain_copy(card):
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(16, 50, 7)).astype(np.float32),
                rng.integers(0, 3, 16).astype(np.int64)) for _ in range(12)]
    got = list(prefetch_to_device(iter(batches), depth=3, device=card))
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        for t, a in zip(g, b):
            assert t.device.type == "cuda" and t.dtype == \
                torch.from_numpy(a).dtype
            assert torch.equal(t, torch.from_numpy(a).to(card))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k5_and_k6_at_the_forecast_encoder_shape(card, rate):
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(256, 336, 64)).astype(
        np.float32)).to(card, torch.bfloat16) for _ in range(4))
    scale, seed = 1.0 / np.sqrt(64), 5
    qg, kg, vg = (z.clone().requires_grad_() for z in (q, k, v))
    before = fused_attention.launches, attention_bwd.launches
    out = fused_attention(qg, kg, vg, scale, rate, seed)
    want = attention_plain(q, k, v, scale, rate, seed)
    assert float((out.detach().float() - want.float()).abs().max()) <= TOL
    out.backward(do)
    torch.cuda.synchronize()
    assert (fused_attention.launches, attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for got, w in zip((qg.grad, kg.grad, vg.grad),
                      attention_bwd_plain(q, k, v, do, scale, rate, seed)):
        lim = TOL * max(1.0, float(w.float().abs().max()))
        assert float((got.float() - w.float()).abs().max()) <= lim


def test_forecaster_step_at_seq_len_336_launches_k5_and_k6(card):
    from sie_tpu_torch.train.tasks import build_task_model
    cfg = Config(seq_len=336, label_len=48, pred_len=96, enc_in=7, dec_in=7,
                 c_out=7, d_model=512, n_heads=8, e_layers=2, d_layers=1,
                 d_ff=2048, dropout=0.1, amp=True)
    model = build_task_model(cfg, "forecast", torch.Generator().manual_seed(0),
                             marks=4).to(card).train()
    rng = np.random.default_rng(2)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(card)
    x, xm, dec, dm = t(4, 336, 7), t(4, 336, 4), t(4, 144, 7), t(4, 144, 4)
    g = torch.Generator(device=card).manual_seed(3)
    before = fused_attention.launches, attention_bwd.launches
    out = model(x, xm, dec, dm, generator=g)
    assert out.shape == (4, 96, 7)
    out.square().mean().backward()
    torch.cuda.synchronize()
    assert (fused_attention.launches - before[0],
            attention_bwd.launches - before[1]) == (2, 2)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)
