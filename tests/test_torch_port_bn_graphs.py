"""BatchNorm state under the CUDA graphs of the staged steps, on the card,
against the eager steps from the same weights and generator state. Every
test here is marked `cuda` and skips without a card; this file imports no
JAX:

    python -m pytest --noconftest tests/test_torch_port_bn_graphs.py -q

Models: InterpGN + FCN at T = 300 (the shapelet banks through kernels
K1/K2) in f32, and a narrow EEGCNN in bf16 (amp), both at dropout 0. A
replay moves the BatchNorm buffers as the eager step does, so losses,
parameters and buffers are compared bit for bit (`torch.equal`); the eval
graphs leave the buffers as they were. `load_jax_variables` copies in
place, so the graphs captured before it replay on the loaded values."""

import numpy as np
import pytest
import torch

from sie_tpu_torch.compat.from_jax import (batch_stats_buffers,
                                           load_jax_variables,
                                           to_jax_variables)
from sie_tpu_torch.config import Config
from sie_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda

MODELS = {
    "interpgn_fcn": dict(model="InterpGN", dnn_type="FCN", seq_len=300,
                         enc_in=8, num_class=3, num_shapelet=2, amp=False),
    "eegcnn": dict(model="EEGCNN", seq_len=300, enc_in=8, num_class=3,
                   eegcnn_cnn_f1=4, eegcnn_cnn_f2=2, eegcnn_n_heads=2,
                   eegcnn_d_ff=32, d_model=32, eegcnn_dropout1=0.0,
                   eegcnn_dropout2=0.0, amp=True),
}
B, ROWS, STEPS = 16, 64, 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _cfg(name, **kw):
    return Config(**dict(MODELS[name], lr=5e-3, dropout=0.0, seed=0, **kw))


def _rows(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return type("Rows", (), dict(
        x=rng.normal(size=(ROWS, cfg.seq_len, cfg.enc_in)).astype(
            np.float32),
        y=rng.integers(0, cfg.num_class, ROWS).astype(np.int32),
        padding_mask=np.ones((ROWS, cfg.seq_len), np.float32)))()


def _schedule(seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.permutation(ROWS)[:B], np.ones(B, np.float32))
            for _ in range(STEPS)]


def _trainer(cfg, ds):
    t = Trainer(cfg, STEPS, device="cuda",
                generator=torch.Generator().manual_seed(0))
    return t, t.device_data("train", ds)


def _state(t):
    return ([p.detach().clone() for p in t.model.parameters()]
            + [b.clone() for b in batch_stats_buffers(t.model).values()])


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_graph_steps_move_the_buffers_as_eager_steps(card, name):
    cfg = _cfg(name)
    ds, sched = _rows(cfg), _schedule()
    eager, dev_e = _trainer(cfg, ds)
    graph, dev_g = _trainer(cfg, ds)
    staged = graph.stage_steps(sched, 1.0)
    start = batch_stats_buffers(eager.model)
    start = {k: v.clone() for k, v in start.items()}
    for i in range(2 * STEPS):
        idx, w = sched[i % STEPS]
        le, _ = eager.train_step_indexed(dev_e, idx, w, 1.0)
        lg, _ = graph.train_step_staged(dev_g, staged, i % STEPS)
        assert torch.equal(le, lg), i
        assert _equal(_state(eager), _state(graph)), i
    assert len(graph.captures) == 1
    moved = batch_stats_buffers(graph.model)
    assert start and all(not torch.equal(start[k], moved[k]) for k in start)
    # the eval graphs read the buffers and move nothing
    before = _state(graph)
    graph.eval_epoch_staged_scan(dev_g, staged)
    graph.eval_epoch_staged_scan(dev_g, staged)   # the captured pass
    graph.eval_step_indexed(dev_g, sched[0][0])
    graph.eval_step_indexed(dev_g, sched[0][0])
    assert _equal(before, _state(graph))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loading_variables_keeps_the_graphs_valid(card, name):
    """A graph captured on one set of variables replays on the values that
    `load_jax_variables` copies in afterwards, as an eager trainer given
    the same values steps."""
    cfg = _cfg(name)
    ds, sched = _rows(cfg), _schedule()
    graph, dev_g = _trainer(cfg, ds)
    staged = graph.stage_steps(sched, 1.0)
    for k in range(3):             # warm-up, capture, replay
        graph.train_step_staged(dev_g, staged, k)
    other, dev_o = _trainer(cfg, ds)
    other.train_step_indexed(dev_o, *sched[3], 1.0)   # moved statistics
    variables = to_jax_variables(other.model)
    load_jax_variables(graph.model, variables)
    eager, dev_e = _trainer(cfg, ds)
    load_jax_variables(eager.model, variables)
    st = graph.optimizer.state()
    eager.optimizer.load_state(st["count"], st["mini_step"], *(
        [t.cpu().clone() for t in st[k]] for k in ("mu", "nu", "acc")))
    eager.generator.set_state(graph.generator.get_state())
    n = len(graph.captures)
    for k in range(STEPS):
        le, _ = eager.train_step_indexed(dev_e, *sched[k], 1.0)
        lg, _ = graph.train_step_staged(dev_g, staged, k)
        assert torch.equal(le, lg), k
    assert len(graph.captures) == n
    assert _equal(_state(eager), _state(graph))
