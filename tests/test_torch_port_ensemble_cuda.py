"""The multi-seed ensemble (train/ensemble.py) as one CUDA graph on the card,
against lone trainers. Every test here is marked `cuda` and skips without
a card; this file imports no JAX:

    python -m pytest --noconftest tests/test_torch_port_ensemble_cuda.py -q

The model is a narrow InterpGN + Transformer at T = 300 (kernels K1/K2 for
the banks, K5/K6 for attention, bf16 under amp) at dropout 0.1. Three
seeds' steps, replayed from one graph, equal three lone trainers' graph
replays bit for bit (losses, parameters, Adam's moments), and each step
of the graph's warm-up and capture launches three times a lone step's
kernels. A seed stopped through `alive` stays frozen without a new
capture while the others go on matching their lone replays.
"""

import numpy as np
import pytest
import torch

from sie_tpu_torch.config import Config
from sie_tpu_torch.ops.attention import attention_bwd, fused_attention
from sie_tpu_torch.ops.shapelet_l1 import (l1_sliding_distance,
                                           l1_sliding_distance_bwd)
from sie_tpu_torch.train.ensemble import EnsembleTrainer
from sie_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda

KW = dict(model="InterpGN", dnn_type="Transformer", seq_len=300, enc_in=8,
          num_class=3, num_shapelet=2, d_model=64, d_ff=128, n_heads=2,
          e_layers=1, amp=True, lr=5e-3, dropout=0.1, seed=0)
SEEDS = (0, 42, 7)
B, ROWS, STEPS = 16, 64, 5
KERNELS = {"K1": l1_sliding_distance, "K2": l1_sliding_distance_bwd,
           "K5": fused_attention, "K6": attention_bwd}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _rows():
    rng = np.random.default_rng(0)
    return type("Rows", (), dict(
        x=rng.normal(size=(ROWS, KW["seq_len"], KW["enc_in"])).astype(
            np.float32),
        y=rng.integers(0, KW["num_class"], ROWS).astype(np.int32),
        padding_mask=np.ones((ROWS, KW["seq_len"]), np.float32)))()


def _schedules():
    out = []
    for s in SEEDS:
        rng = np.random.default_rng(s + 100)
        out.append([(rng.permutation(ROWS)[:B], np.ones(B, np.float32))
                    for _ in range(STEPS)])
    return out


def _lone(cfg, seed, ds, sched):
    """Seed `seed`'s lone trainer: the losses of its staged graph steps."""
    t = Trainer(cfg.replace(seed=seed), STEPS, device="cuda",
                generator=torch.Generator().manual_seed(seed))
    dev = t.device_data("train", ds)
    staged = t.stage_steps(sched, 1.0)
    return t, [t.train_step_staged(dev, staged, k)[0]
               for k in range(STEPS)]


def _same(a: Trainer, b: Trainer) -> bool:
    pa, pb = a.optimizer.params, b.optimizer.params
    return (all(torch.equal(p, q) for p, q in zip(pa, pb))
            and all(torch.equal(a.optimizer.adam.state[p][k],
                                b.optimizer.adam.state[q][k])
                    for p, q in zip(pa, pb)
                    for k in ("exp_avg", "exp_avg_sq")))


def test_ensemble_graph_equals_lone_replays(card):
    cfg = Config(**KW)
    ds, scheds = _rows(), _schedules()
    et = EnsembleTrainer(cfg, STEPS, SEEDS, device=card)
    dev = et.device_data("train", ds)
    staged = et.stage_steps(scheds, 1.0)
    losses = []
    for k in range(STEPS):
        for fn in KERNELS.values():
            fn.launches = 0
        losses.append(et.train_step_staged(dev, staged, k)[0])
        got = {name: fn.launches for name, fn in KERNELS.items()}
        want = ({"K1": 18, "K2": 18, "K5": 3, "K6": 3} if k < 2
                else dict.fromkeys(KERNELS, 0))   # counted at capture
        assert got == want, k
    assert len(et.captures) == 1
    for i, s in enumerate(SEEDS):
        lone, lone_losses = _lone(cfg, s, ds, scheds[i])
        for k in range(STEPS):
            assert torch.equal(lone_losses[k], losses[k][i]), (s, k)
        assert _same(lone, et.trainers[i]), s


def test_stopped_seed_freezes_without_a_new_capture(card):
    cfg = Config(**KW)
    ds, scheds = _rows(), _schedules()
    et = EnsembleTrainer(cfg, STEPS, SEEDS, device=card)
    dev = et.device_data("train", ds)
    staged = et.stage_steps(scheds, 1.0)
    alive = np.ones(len(SEEDS), np.float32)
    for k in range(STEPS):
        if k == 3:
            alive[1] = 0.0
            frozen = [t.detach().clone()
                      for t in et.trainers[1].optimizer.params]
        et.train_step_staged(dev, staged, k, alive)
    assert len(et.captures) == 1
    assert all(torch.equal(a, b) for a, b in
               zip(frozen, et.trainers[1].optimizer.params))
    assert et.trainers[1].optimizer.count == 3
    for i in (0, 2):
        lone, _ = _lone(cfg, SEEDS[i], ds, scheds[i])
        assert _same(lone, et.trainers[i])
