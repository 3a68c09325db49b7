"""`--profile_dir` and `--debug_nans` in the port (sie_tpu_torch/utils/
profiling.py, the NaN checks of train/trainer.py) against the JAX
package's `trace`, `StepTimer` and `jax_debug_nans`, on the CPU.

The trace is a Chrome trace file under the directory, written on the
exception path too. Under `debug_nans` a train step on a batch with one
NaN in the valid region raises FloatingPointError naming the step and an
operation, as the JAX trainer under `jax_debug_nans` raises on the same
batch; a clean run gives the same losses and weights, bit for bit, as a
run without the flag; the eval passes are checked too; and both command
lines raise on a set with one infinite value, whose standardisation makes
NaNs."""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

import run as jax_run
from sie_tpu.config import Config as JConfig
from sie_tpu.train.trainer import Trainer as JTrainer
from sie_tpu.utils.profiling import StepTimer as JStepTimer
from sie_tpu_torch import run as port_run
from sie_tpu_torch.config import Config
from sie_tpu_torch.data.synthetic import write_synthetic_uea
from sie_tpu_torch.train.trainer import Trainer
from sie_tpu_torch.utils.profiling import (StepTimer, debug_nans,
                                           debug_nans_enabled, device_busy_ms,
                                           idle_share, trace)

B, T, C = 4, 40, 3
KW = dict(seq_len=T, enc_in=C, num_class=3, num_shapelet=2, d_model=16,
          n_heads=2, e_layers=1, d_ff=32, dropout=0.1, amp=False,
          use_pallas=False, model="InterpGN", seed=0)


def _batch(poison=False):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    if poison:
        x[1, 5, 2] = np.nan   # one value inside the valid region
    return (x, np.array([0, 1, 2, 0]), np.ones((B, T), np.float32),
            np.ones(B, np.float32))


def test_trace_writes_a_chrome_trace_also_on_an_exception(tmp_path):
    with trace(str(tmp_path / "ok")):
        torch.ones(8).add_(1)
    with pytest.raises(KeyError):
        with trace(str(tmp_path / "err")):
            torch.ones(8).mul_(2)
            raise KeyError("boom")
    for d in ("ok", "err"):
        [f] = glob.glob(str(tmp_path / d / "trace-*.json"))
        events = json.load(open(f))["traceEvents"]
        assert any("aten::" in e.get("name", "") for e in events)
    with trace(None):   # no-op
        pass


def test_step_timer_is_the_jax_one():
    mine, theirs = StepTimer(warmup=1), JStepTimer(warmup=1)
    for t in (mine, theirs):
        for _ in range(3):
            with t:
                pass
    assert (mine.count, mine.warmup) == (theirs.count, theirs.warmup) == (3, 1)
    assert mine.mean >= 0.0 and mine.total <= 1.0
    assert StepTimer().mean == JStepTimer().mean == 0.0


def test_switch_is_scoped():
    assert not debug_nans_enabled()
    with debug_nans():
        assert debug_nans_enabled()
        with debug_nans(False):
            assert not debug_nans_enabled()
        assert debug_nans_enabled()
    assert not debug_nans_enabled()


@pytest.mark.parametrize("dnn", ["Transformer", "PatchTST"])
def test_poisoned_step_raises_naming_the_step_and_an_op(dnn):
    cfg = Config(**dict(KW, dnn_type=dnn, patch_chunk_rows=5))
    with debug_nans():
        tr = Trainer(cfg, 10, device="cpu")
    assert tr.debug_nans
    tr.train_step(_batch(), 1.0)
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    with pytest.raises(FloatingPointError,
                       match=r"train step 1: the first non-finite value came "
                             r"from aten\.\w+"):
        tr.train_step(_batch(poison=True), 1.0)
    # the state of before the step was put back for the re-run
    for n, p in tr.model.named_parameters():
        assert torch.equal(p, before[n]), n


def test_jax_trainer_raises_on_the_same_batch():
    jt = JTrainer(JConfig(**dict(KW, dnn_type="Transformer")),
                  steps_per_epoch=10)
    state = jt.init_state(_batch(), seed=0)
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            jt.train_step(state, _batch(poison=True), 1.0)
    finally:
        jax.config.update("jax_debug_nans", False)


def test_clean_run_is_unchanged_by_the_checks():
    cfg = Config(**dict(KW, dnn_type="Transformer"))
    runs = []
    for flag in (True, False):
        with debug_nans(flag):
            tr = Trainer(cfg, 10, device="cpu",
                         generator=torch.Generator().manual_seed(2))
        dev = tr.device_data("train", type("D", (), dict(
            x=_batch()[0], y=_batch()[1], padding_mask=_batch()[2]))())
        staged = tr.stage_steps([(np.arange(B), np.ones(B, np.float32))] * 3,
                                beta=0.5)
        losses = [tr.train_step_staged(dev, staged, k)[0] for k in range(3)]
        losses.append(tr.train_epoch_staged(dev, staged))
        logits = tr.eval_epoch_staged_scan(dev, staged)[0]
        runs.append((torch.cat([l.reshape(-1) for l in losses]), logits,
                     [p.detach().clone() for p in tr.model.parameters()]))
    (la, ea, pa), (lb, eb, pb) = runs
    assert torch.equal(la, lb) and torch.equal(ea, eb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


def test_poisoned_eval_raises():
    cfg = Config(**dict(KW, dnn_type="Transformer"))
    with debug_nans():
        tr = Trainer(cfg, 10, device="cpu")
    with pytest.raises(FloatingPointError, match="eval step"):
        tr.eval_step(_batch(poison=True))
    x, y, mask, _ = _batch(poison=True)
    dev = tr.device_data("val", type("D", (), dict(x=x, y=y,
                                                   padding_mask=mask))())
    staged = tr.stage_steps([(np.arange(B), np.ones(B, np.float32))])
    with pytest.raises(FloatingPointError, match="eval pass"):
        tr.eval_epoch_staged_scan(dev, staged)


def _poisoned_uea(root):
    """A tiny UEA set with one train value of 1e400 (inf): missing values
    ('?') are interpolated by the reader, an infinity is not, and the
    set's standardisation turns it into NaNs."""
    write_synthetic_uea(root, "Toy", n_train=24, n_test=12, n_dims=3,
                        length=30, n_classes=2, seed=9)
    path = os.path.join(root, "Toy", "Toy_TRAIN.ts")
    lines = open(path).read().split("\n")
    i = lines.index("@data") + 3
    parts = lines[i].split(",")
    parts[4] = "1e400"
    lines[i] = ",".join(parts)
    open(path, "w").write("\n".join(lines))


def _cli(root, *extra):
    return ["--data", "UEA", "--data_root", root, "--dataset", "Toy",
            "--model", "InterpGN", "--dnn_type", "Transformer",
            "--num_shapelet", "2", "--d_model", "8", "--d_ff", "16",
            "--n_heads", "2", "--e_layers", "1", "--batch_size", "8",
            "--train_epochs", "1", "--log_interval", "1", "--seed", "0",
            "--result_dir", os.path.join(root, "result"),
            "--cache_dir", os.path.join(root, "cache")] + list(extra)


def test_both_command_lines_raise_under_debug_nans(tmp_path):
    root = str(tmp_path)
    _poisoned_uea(root)
    with pytest.raises(FloatingPointError, match="train step 0"):
        port_run.main(_cli(root, "--device", "cpu", "--debug_nans",
                           "--checkpoint_dir", os.path.join(root, "p")))
    assert not debug_nans_enabled()
    try:
        with pytest.raises(FloatingPointError):
            jax_run.main(_cli(root, "--debug_nans", "--checkpoint_dir",
                              os.path.join(root, "j")))
    finally:
        jax.config.update("jax_debug_nans", False)


def test_profile_dir_writes_a_trace_of_training(tmp_path, capsys):
    root = str(tmp_path)
    write_synthetic_uea(root, "Toy", n_train=24, n_test=12, n_dims=3,
                        length=30, n_classes=2, seed=9)
    prof = os.path.join(root, "prof")
    port_run.main(_cli(root, "--device", "cpu", "--profile_dir", prof,
                       "--checkpoint_dir", os.path.join(root, "ck")))
    [f] = glob.glob(os.path.join(prof, "trace-*.json"))
    names = {e.get("name", "") for e in json.load(open(f))["traceEvents"]}
    assert "aten::mm" in names or "aten::addmm" in names
    assert "Epoch 1/1" in capsys.readouterr().out


def test_flags_are_no_longer_refused():
    args = port_run.get_args(["--profile_dir", "p", "--debug_nans"])
    port_run.refuse_unported(args)
    assert set(port_run._UNPORTED) == {"mesh"}



class _Prof:
    """A finished profiler's `events()`: (device type, name, start us, end
    us) rows."""

    def __init__(self, rows):
        from types import SimpleNamespace as NS
        self.rows = [NS(device_type=d, name=n, time_range=NS(start=a, end=b))
                     for d, n, a, b in rows]

    def events(self):
        return self.rows


def test_device_busy_time_is_the_union_of_device_intervals():
    from torch.autograd import DeviceType
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    prof = _Prof([(cuda, "gemm", 0.0, 400.0),
                  (cuda, "Memcpy HtoD (Pinned -> Device)", 300.0, 700.0),
                  (cuda, "softmax", 100.0, 200.0),      # inside the gemm
                  (cuda, "Activity Buffer Request", 0.0, 5000.0),
                  (cpu, "aten::mm", 0.0, 9000.0),
                  (cuda, "gemm", 1000.0, 1500.0)])
    # [0, 700] once, though the copy overlaps the gemm on a side stream
    assert device_busy_ms(prof) == pytest.approx(1.2)
    assert idle_share(prof, 2.0) == pytest.approx(0.4)


@pytest.mark.parametrize("device, wall", [("CUDA", 0.5), ("CPU", 3.0)])
def test_idle_share_raises_on_an_unmeasured_window(device, wall):
    # more device time than wall time, and no device time at all
    from torch.autograd import DeviceType
    prof = _Prof([(getattr(DeviceType, device), "gemm", 0.0, 1000.0)])
    with pytest.raises(RuntimeError, match="no idle share"):
        idle_share(prof, wall)
