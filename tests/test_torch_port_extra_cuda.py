"""The card's side of the MoE FFN, the attention variants and the extra
families (Autoformer, FEDformer, ETSformer, Pyraformer, Crossformer) at
small widths: each module's forward and gradients on the card against
the same module on the CPU (the plain path; float32, TF32 off: 1e-4 of
each tensor's largest entry, a gradient's floored at 1e-2 of the model's
largest; the FFTs through cuFFT against pocketfft),
and the captured staged steps of InterpGN with a MoE encoder and with
each family as its expert against eager steps (losses within 1e-5
relative, every parameter bit-equal). Every test is marked `cuda`
and skips without a card; this file imports no JAX:

    python -m pytest --noconftest tests/test_torch_port_extra_cuda.py -q
"""

import copy
import os
import sys
import threading

import numpy as np
import pytest
import torch

from sie_tpu_torch.config import Config
from sie_tpu_torch.models.registry import build_model
from sie_tpu_torch.train.tasks import build_task_model
from sie_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda
TOL = 1e-4
FAMILIES = ["Autoformer", "FEDformer", "ETSformer", "Pyraformer",
            "Crossformer"]
BASE = dict(model="InterpGN", seq_len=48, enc_in=3, c_out=3, num_class=3,
            num_shapelet=2, d_model=16, d_ff=32, n_heads=2, e_layers=2,
            moving_avg=5, top_k=2, dropout=0.0, amp=False, seed=0,
            batch_size=8, lr=5e-3, fused_attention_min_len=0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def _rows(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return type("Rows", (), dict(
        x=rng.normal(size=(n, cfg.seq_len, cfg.enc_in)).astype(np.float32),
        y=rng.integers(0, cfg.num_class, n).astype(np.int32),
        padding_mask=np.ones((n, cfg.seq_len), np.float32)))()


def _close(got, want, what, floor=1e-6):
    """got within TOL of max(|want|'s largest entry, floor)."""
    scale = max(float(want.abs().max()), floor)
    err = float((got.detach().float().cpu() - want.detach().float()).abs()
                .max()) / scale
    assert err <= TOL, f"{what}: {err} x max(max|want|, {floor:.3e})"


def _card_against_cpu(model, args):
    """Forward and the gradients of sum(out^2) of `model` on the card
    against a CPU copy."""
    cpu = copy.deepcopy(model).cpu()
    card = model.cuda()
    outs = []
    for m, dev in ((card, "cuda"), (cpu, "cpu")):
        m.eval()
        out = m(*[None if a is None else torch.from_numpy(a).to(dev)
                  for a in args])
        out = out[0] if isinstance(out, tuple) else out
        out.float().square().sum().backward()
        outs.append(out)
    _close(outs[0], outs[1], "output")
    # a gradient that is zero in exact arithmetic (an attention key bias:
    # the softmax ignores a shift shared by every key; a layer whose
    # output nothing reads) holds rounding noise only: floored at 1e-2 of
    # the model's largest gradient, as the CPU tests against JAX do
    pc = {n: p for n, p in cpu.named_parameters() if p.grad is not None}
    top = max(float(p.grad.abs().max()) for p in pc.values())
    for name, p in card.named_parameters():
        if name in pc:
            _close(p.grad, pc[name].grad, name, 1e-2 * top)


@pytest.mark.parametrize("extra", [dict(moe_experts=4),
                                   dict(moe_experts=4, moe_top_k=2),
                                   dict(attention_variant="ds"),
                                   dict(attention_variant="prob"),
                                   dict(attention_variant="lsh")],
                         ids=["moe", "moe_top2", "ds", "prob", "lsh"])
def test_encoder_options_card_against_cpu(card, extra):
    cfg = Config(**dict(BASE, dnn_type="Transformer", **extra))
    model = build_model(cfg, "cpu")
    x = _rows(cfg, 4).x
    _card_against_cpu(model, (x, np.ones(x.shape[:2], np.float32)))


@pytest.mark.parametrize("family", FAMILIES)
def test_family_card_against_cpu(card, family):
    cfg = Config(**dict(BASE, dnn_type=family))
    x = _rows(cfg, 4).x
    _card_against_cpu(build_model(cfg, "cpu"),
                      (x, np.ones(x.shape[:2], np.float32)))
    rng = np.random.default_rng(1)
    fc = Config(**dict(BASE, dnn_type=family, model="DNN", label_len=8,
                       pred_len=8))
    dec = np.zeros((4, 16, 3), np.float32)
    _card_against_cpu(build_task_model(fc, "forecast", marks=4),
                      (x, rng.normal(size=(4, 48, 4)).astype(np.float32),
                       dec, rng.normal(size=(4, 16, 4)).astype(np.float32)))


def _graph_against_eager(cfg, steps=4):
    """Losses and final parameters of `steps` eager indexed steps and of
    the same staged steps (warm-up, capture, replays)."""
    rows = _rows(cfg, 4 * cfg.batch_size)
    rng = np.random.default_rng(3)
    sched = [(rng.permutation(len(rows.y))[:cfg.batch_size],
              np.ones(cfg.batch_size, np.float32)) for _ in range(steps)]
    mk = lambda: Trainer(cfg, steps_per_epoch=steps, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    eager, graph = mk(), mk()
    de, dg = eager.device_data("train", rows), graph.device_data("train",
                                                                 rows)
    staged = graph.stage_steps(sched, 1.0)
    le, lg = [], []
    for k, (idx, w) in enumerate(sched):
        le.append(float(eager.train_step_indexed(de, idx, w, 1.0)[0]))
        lg.append(float(graph.train_step_staged(dg, staged, k)[0]))
    assert len(graph.captures) == 1
    for a, b in zip(lg, le):
        assert abs(a - b) <= 1e-5 * abs(b)
    return all(torch.equal(p, q) for p, q in zip(
        eager.model.parameters(), graph.model.parameters()))


def test_moe_graph_steps_equal_eager_bit_for_bit(card):
    cfg = Config(**dict(BASE, dnn_type="Transformer", moe_experts=4,
                        dropout=0.1, amp=True))
    assert _graph_against_eager(cfg)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_graph_steps_equal_eager_bit_for_bit(card, family):
    """Replays bit-equal to eager steps: the gathers of auto-correlation's
    delays and ETSformer's top frequencies have distinct indices within a
    row, so their backward adds one value to each element; Pyraformer's
    refer-point gather repeats indices, and its backward (index_put with
    accumulate) sums them in sorted order."""
    cfg = Config(**dict(BASE, dnn_type=family, dropout=0.1, amp=True))
    assert _graph_against_eager(cfg)
