"""The staged train and eval steps of sie_tpu_torch as CUDA graphs on the
card, against the eager steps from the same weights and generator state.
Every test here is marked `cuda` and skips without a card; this file
imports no JAX:

    python -m pytest --noconftest tests/test_torch_port_graphs.py -q

The model is a narrow InterpGN + Transformer at T = 300, where attention
runs kernels K5/K6 and the shapelet banks K1/K2, in bf16 (amp). Limits:
losses 1e-5 relative, parameters 2.1 x lr (the amp update limit of
tests/test_torch_port_train.py: one Adam step moves a weight by ~lr, and
a gradient's sign can flip on rounding); the eval logits 5e-2 abs (bf16).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from sie_tpu_torch.config import Config
from sie_tpu_torch.train.trainer import Optimizer, Trainer

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(model="InterpGN", dnn_type="Transformer", seq_len=300, enc_in=8,
          num_class=3, num_shapelet=2, d_model=64, d_ff=128, n_heads=2,
          e_layers=1, amp=True, lr=5e-3, seed=0)
B, ROWS, STEPS = 16, 64, 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    return type("Rows", (), dict(
        x=rng.normal(size=(ROWS, KW["seq_len"], KW["enc_in"])).astype(
            np.float32),
        y=rng.integers(0, KW["num_class"], ROWS).astype(np.int32),
        padding_mask=np.ones((ROWS, KW["seq_len"]), np.float32)))()


def _schedule(seed):
    rng = np.random.default_rng(seed)
    return [(rng.permutation(ROWS)[:B], rng.random(B).astype(np.float32))
            for _ in range(STEPS)]


def _trainer(cfg, ds):
    t = Trainer(cfg, STEPS, device="cuda",
                generator=torch.Generator().manual_seed(0))
    return t, t.device_data("train", ds)


def _close(eager, graph, losses_e, losses_g, lr):
    for a, e in zip(losses_g, losses_e):
        assert abs(a - e) <= 1e-5 * abs(e), (losses_g, losses_e)
    pe = dict(eager.model.named_parameters())
    for name, p in graph.model.named_parameters():
        assert float((p - pe[name]).abs().max()) <= 2.1 * lr, name


@pytest.mark.parametrize("dropout,accum", [(0.0, 1), (0.1, 1), (0.1, 2)])
def test_graph_steps_equal_eager_steps(card, dropout, accum):
    """train_step_staged (warm-up, capture, replays) and two scanned
    epochs against train_step_indexed over the same rows."""
    cfg = Config(**dict(KW, dropout=dropout,
                        gradient_accumulation_steps=accum))
    ds, sched = _rows(), _schedule(1)
    eager, dev_e = _trainer(cfg, ds)
    graph, dev_g = _trainer(cfg, ds)
    scan, dev_s = _trainer(cfg, ds)
    staged = graph.stage_steps(sched, 0.5)
    staged_s = scan.stage_steps(sched, 0.5)
    losses_e, losses_g = [], []
    for i in range(2 * STEPS):
        idx, w = sched[i % STEPS]
        losses_e.append(float(eager.train_step_indexed(dev_e, idx, w,
                                                       0.5)[0]))
        losses_g.append(float(graph.train_step_staged(dev_g, staged,
                                                      i % STEPS)[0]))
    losses_s = (scan.train_epoch_staged(dev_s, staged_s).tolist()
                + scan.train_epoch_staged(dev_s, staged_s).tolist())
    assert len(graph.captures) == accum and len(scan.captures) == 1
    assert graph.optimizer.count == eager.optimizer.count == scan.optimizer.count
    _close(eager, graph, losses_e, losses_g, cfg.lr)
    _close(eager, scan, losses_e, losses_s, cfg.lr)


def test_two_schedules_in_the_same_buffers(card):
    """A second schedule of the same shape, staged into the buffers the
    captured graph reads, replays as its own eager steps."""
    cfg = Config(**KW)
    ds = _rows()
    eager, dev_e = _trainer(cfg, ds)
    graph, dev_g = _trainer(cfg, ds)
    losses_e, losses_g = [], []
    for seed, beta in ((1, 1.0), (2, 0.25)):
        sched = _schedule(seed)
        staged = graph.stage_steps(sched, beta)
        for k, (idx, w) in enumerate(sched):
            losses_e.append(float(eager.train_step_indexed(dev_e, idx, w,
                                                           beta)[0]))
            losses_g.append(float(graph.train_step_staged(dev_g, staged,
                                                          k)[0]))
    assert len(graph.captures) == 1
    _close(eager, graph, losses_e, losses_g, cfg.lr)


def test_eval_graphs_equal_eager_eval(card):
    """eval_epoch_staged_scan, eval_step_staged and eval_step_indexed
    replays against the eager eval step, with hard gating and collect."""
    cfg = Config(**KW)
    ds = _rows()
    t, dev = _trainer(cfg, ds)
    sched = _schedule(3)
    staged = t.stage_steps(sched)
    for _ in range(3):   # warm-up, capture, replay
        logits, ce, mloss, info = t.eval_epoch_staged_scan(dev, staged, 0.5,
                                                           collect=True)
        per_step = [t.eval_step_staged(dev, staged, k, 0.5)
                    for k in range(STEPS)]
        per_idx = [t.eval_step_indexed(dev, idx, 0.5) for idx, _ in sched]
    assert len(t.captures) == 3   # one graph per path
    for k, (idx, w) in enumerate(sched):
        want, want_info = t.eval_step(
            (ds.x[idx], ds.y[idx], ds.padding_mask[idx], w), 0.5)
        for got in (logits[k], per_step[k][0], per_idx[k][0]):
            assert float((got - want).abs().max()) <= 5e-2
            assert torch.equal(got.argmax(-1), want.argmax(-1))
        assert float((info.eta[k] - want_info.eta).abs().max()) <= 5e-2
        assert ce.shape == (STEPS, B) and mloss.shape == (STEPS,)


# the cases of tests/test_torch_port_train.py::test_optimizer_matches_optax,
# which holds the CPU Optimizer against optax
OPT_CASES = {
    "clip_accum_cosine_warmup": dict(gradient_clip=0.5,
                                     gradient_accumulation_steps=2,
                                     lr_decay=True, lr_warmup_epochs=1.0,
                                     train_epochs=3),
    "plain_adam": dict(),
    "clip_cosine": dict(gradient_clip=0.8, lr_decay=True, train_epochs=2),
}


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_card_optimizer_equals_cpu_optimizer(card, case, captured):
    """The Optimizer on the card (capturable Adam, the learning rate
    computed on the card from its count), eagerly or as replays of one
    captured graph per place in an accumulation group, against the CPU
    Optimizer on the same gradients, within 1e-6 after every step."""
    kw = dict(lr=0.01, **OPT_CASES[case])
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * scale for s in shapes]
             for scale in (0.1, 1.0, 0.3, 0.05, 0.8, 0.2, 0.6, 0.1)]
    host = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    dev = [torch.nn.Parameter(torch.from_numpy(p.copy()).to(card))
           for p in p0]
    opt_h = Optimizer(Config(**kw), 3, host)
    opt_d = Optimizer(Config(**kw), 3, dev)
    static = [torch.zeros_like(p) for p in dev]   # the gradients read
    warm, graphs = set(), {}
    for i, g in enumerate(grads):
        for p, a in zip(host, g):
            p.grad = torch.from_numpy(a.copy())
        opt_h.device_step(opt_h.mini_step)
        opt_h.advance()
        pos = opt_d.mini_step
        for st, a in zip(static, g):
            st.copy_(torch.from_numpy(a))
        if captured and pos in warm:
            if pos not in graphs:
                graphs[pos] = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graphs[pos]):
                    for p, st in zip(dev, static):
                        p.grad = st
                    opt_d.device_step(pos)
            graphs[pos].replay()
        else:
            for p, st in zip(dev, static):
                p.grad = st
            opt_d.device_step(pos)
            warm.add(pos)
        opt_d.advance()
        for got, want in zip(dev, host):
            np.testing.assert_allclose(got.detach().cpu().numpy(),
                                       want.detach().numpy(), atol=1e-6,
                                       rtol=1e-6, err_msg=f"step {i}")
    assert len(graphs) == (opt_d.accum if captured else 0)
    assert opt_d.count == opt_h.count == float(opt_d.count_t)


def test_failing_capture_raises(card):
    """A step that cannot be captured (here it reads a value back to the
    host) raises at capture, leaves no graph, and raises again on the next
    call: nothing falls back to the eager step. Run in a child process, as
    a failed capture may leave its CUDA context unusable."""
    code = textwrap.dedent(f"""
        import numpy as np, torch
        from sie_tpu_torch.config import Config
        from sie_tpu_torch.train.trainer import Trainer
        cfg = Config(**{KW!r})
        t = Trainer(cfg, 2, device="cuda")
        rng = np.random.default_rng(0)
        ds = type("R", (), dict(
            x=rng.normal(size=(8, 300, 8)).astype(np.float32),
            y=np.zeros(8, np.int32), padding_mask=np.ones((8, 300),
                                                          np.float32)))()
        dev = t.device_data("train", ds)
        staged = t.stage_steps([(np.arange(4), np.ones(4, np.float32))] * 2)
        real = t.loss_fn
        def syncing(*a):
            loss, aux = real(*a)
            float(loss)   # a host read: not allowed while capturing
            return loss, aux
        t.loss_fn = syncing
        t.train_step_staged(dev, staged, 0)   # the eager warm-up runs
        for attempt in range(2):
            try:
                t.train_step_staged(dev, staged, 1)
            except RuntimeError:
                print("raised")
            else:
                print("no error")
        print("graphs", len(t.captures))
        """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.stdout.count("raised") == 2, out.stdout + out.stderr
    assert "no error" not in out.stdout and "graphs 0" in out.stdout, \
        out.stdout + out.stderr
