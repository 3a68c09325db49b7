"""What decides `correct`: the plain reference against the port's CPU path
at a tiny size, and runs with the timed path broken underneath, each of
which has to come out not correct."""

import json

import numpy as np
import pytest
import torch

from benchmark.reference import interpgn as ref
from benchmark.weights import make_rows, make_weights
from conftest import TINY, REPO, run_tiny, write_tiny


def _tiny_cfg(amp=False):
    with open(f"{REPO}/benchmark/configs/interpgn-chisco.json") as f:
        cfg = json.load(f)["config"]
    cfg.update(TINY, amp=amp)
    return cfg


def _port_model(cfg, weights):
    from sie_tpu_torch.config import Config
    from sie_tpu_torch.models.registry import build_model
    from benchmark.weights import load_into
    model = build_model(Config(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in cfg.items()}), "cpu")
    load_into(model, weights)
    return model


@pytest.mark.parametrize("expert", ["Transformer", "FCN"])
@pytest.mark.parametrize("seq_len", [40, 3100])
def test_reference_against_the_port(seq_len, expert):
    """Loss and every gradient in float32, at stride 1 and (past 3000
    steps) the strided banks, with either expert."""
    from sie_tpu_torch.config import Config
    from sie_tpu_torch.train.trainer import make_loss_fn
    cfg = _tiny_cfg()
    cfg.update(seq_len=seq_len, d_model=8, d_ff=16, dnn_type=expert)
    w = make_weights(cfg, 5, "cpu")
    x, y = make_rows(cfg, 3, 5, "cpu")
    mask = torch.ones(x.shape[:2])
    wt = torch.tensor([1.0, 1.0, 0.0])
    model = _port_model(cfg, w).train()
    loss_fn = make_loss_fn(Config(**{k: tuple(v) if isinstance(v, list)
                                     else v for k, v in cfg.items()}))
    got, _ = loss_fn(model, (x, y, mask, wt), 1.0, None)
    grads = dict(zip([n for n, _ in model.named_parameters()],
                     torch.autograd.grad(got, list(model.parameters()))))
    params = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    want = ref.loss(params, cfg, x, y, mask, wt, 1.0)
    names = list(params)
    wgrads = torch.autograd.grad(want, [params[n] for n in names])
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    norms = [float(g.norm()) for g in wgrads]
    floor = 1e-3 * float(np.median(norms))
    for n, g in zip(names, wgrads):
        if float(g.norm()) > floor:
            assert float((grads[n] - g).norm()) <= 1e-4 * float(g.norm()), n


def test_gradient_difference_sees_what_norms_do_not():
    """Two leaves whose program gradients have the reference's norms but
    another direction: every gap of norms reads 0, grad_diff_gap does
    not."""
    from benchmark import compare
    ref_g = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0, 0.0])}
    prog_g = {"a": torch.tensor([4.0, 3.0]), "b": torch.tensor([0.0, 1.0])}
    norms = lambda g: {n: float(t.norm()) for n, t in g.items()}
    side = lambda g: {"losses": [1.0, 1.0, 1.0], "grads": g,
                      "grad_norms": norms(g), "change": norms(g)}
    compared, _ = compare.training(side(prog_g), side(ref_g))
    assert compared["grad_gap"][0] == 0.0
    assert compared["change_gap"][0] == 0.0
    # |(1, -1)| / 5 and |(-1, 1)| / 3 (the median leaf's norm, 3): the
    # median of sqrt(2)/5 and sqrt(2)/3
    assert compared["grad_diff_gap"][0] == pytest.approx(
        (2 ** 0.5 / 5 + 2 ** 0.5 / 3) / 2)


def test_state_left_unchanged_is_not_correct(tiny, monkeypatch):
    from sie_tpu_torch.train import trainer
    monkeypatch.setattr(trainer.Optimizer, "device_step",
                        lambda self, position: True)
    line = run_tiny(tiny, "chisco-train")
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_is_not_correct(tiny, monkeypatch):
    """The loss's mean taken over the first half of the rows only."""
    from sie_tpu_torch.train import trainer
    make = trainer.make_loss_fn

    def half(cfg, loss_head=None):
        inner = make(cfg, loss_head)

        def loss_fn(model, batch, beta, generator):
            h = batch[0].shape[0] // 2
            return inner(model, tuple(t[:h] for t in batch), beta,
                         generator)
        return loss_fn
    monkeypatch.setattr(trainer, "make_loss_fn", half)
    line = run_tiny(tiny, "chisco-train")
    assert not line["correct"], line["checks"]


def test_exchange_left_out_is_not_correct(tmp_path):
    """Two CPU ranks over gloo on a 'data' mesh, each summing no
    gradient over the other: rank 0's result is not correct."""
    import subprocess
    import sys
    from sie_tpu_torch.parallel.multihost import free_port
    write_tiny(str(tmp_path))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dp2", "config": "tiny",
                               "traffic": "t4", "chips": 2, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "traffic" / "t4.json").write_text(json.dumps(
        {"loop": "train", "batch_rows": 4, "rows": 32}))
    (tmp_path / "cells" / "dp2.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-4, "grad_gap": 1e-4,
                    "change_gap": 1e-3}}))
    coord = f"localhost:{free_port()}"
    code = f"""
import sys, time
sys.path.insert(0, {REPO!r})
from sie_tpu_torch.parallel import comm
comm.sum_grads = lambda params, mesh: None
from benchmark import harness
run = harness.start(["--workload", "dp2", "--seed", "4", "--seconds",
                     "0.3", "--trace", "0", "--device", "cpu", "--bench",
                     {str(tmp_path)!r}, "--coordinator", {coord!r},
                     "--rank", sys.argv[1]], time.perf_counter())
sys.exit(harness.report(run))
"""
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-2000:]
    line = json.loads(outs[0][0].strip().splitlines()[-1])
    assert not line["correct"]
    assert line["checks"]["grad_gap"]["value"] > 0.1


TINY_AMP_LIMITS = {"loss_gap": 5e-3, "grad_gap": 1.5e-2, "change_gap": 3e-2}


@pytest.mark.parametrize("seed", [1, 3])
def test_control_is_not_correct(tmp_path, seed):
    """The tiny bf16 configuration: the port passes limits that the plain
    reference in fp8 (the control) fails (the tiny size's readings, CPU:
    program grad_gap <= 0.0097, control >= 0.025)."""
    root = str(tmp_path)
    write_tiny(root, amp=True, limits=TINY_AMP_LIMITS)
    assert run_tiny(root, "chisco-train", seed=seed)["correct"]
    line = run_tiny(root, "chisco-train", seed=seed, extra=("--control",))
    assert not line["correct"], line["checks"]
