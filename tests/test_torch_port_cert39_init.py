"""The 39-class certification started from the JAX package's initial
weights: the JAX `Trainer.init_state` draws them on the CPU, the JAX
`save_checkpoint` writes them, and `scripts/port_cert39.py --init_from DIR`
starts every fold of the port's run from them. The cert trains without
dropout and both packages draw the batch order from the same numpy seed,
so with the weights the same a gap to the JAX run's accuracies is left to
the arithmetic of the devices.

    python tests/test_torch_port_cert39_init.py --out DIR [--tag TAG]

writes the initial variables for the docs/cert39.json row `--tag` at its
full width (a checkpoint directory, 103 MB for the default row). The test
writes them at a narrow width and checks that a fold's `Experiment` under
`folds_start_from` holds them leaf for leaf and gives the JAX model's eval
logits (1e-4, f32, the limit of tests/test_torch_port_models.py). A second
test trains fold 0 of the cert's protocol (39 classes, lr 1e-3 after a
2-epoch warm-up, patience 6, the constant beta, 6 epochs) at that width in
both packages from those weights. In f32 every epoch's losses agree within
1e-4 (tests/test_torch_port_experiment.py's limit), with the same
validation accuracies, stopping epoch and test accuracy; under amp within
5e-2 (the bf16 limit of tests/test_torch_port_models.py), the accuracies
within one row.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import run as jax_run  # noqa: E402
from port_cert39 import cli_flags, folds_start_from  # noqa: E402
from sie_tpu.data.eeg import load_eeg_dataset  # noqa: E402
from sie_tpu.train.checkpoint import save_checkpoint  # noqa: E402
from sie_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from sie_tpu_torch import run as port_run  # noqa: E402
from sie_tpu_torch.compat.from_jax import to_jax_variables  # noqa: E402
from sie_tpu_torch.train import experiment as port_experiment  # noqa: E402

F32_TOL = 1e-4


def write_jax_initial_variables(argv: list, out_dir: str) -> dict:
    """The variables the JAX package's experiment starts from under the
    command line `argv` (its `init_state` at seed max(cfg.seed, 0), on one
    zero row of the data's shape), written to `out_dir` as the JAX
    package's checkpoint; returns the JAX config."""
    args = jax_run.get_args(argv)
    cfg = jax_run.args_to_config(args, args.seed)
    # the data's shape, from a few synthetic trials of the same layout
    probe = load_eeg_dataset(cfg.replace(synthetic_trials=40), "train",
                             three_class=cfg.data == "EEG3", synthetic=True)
    cfg = cfg.replace(seq_len=probe.seq_len, enc_in=probe.enc_in,
                      num_class=probe.num_class, pred_len=0, label_len=0)
    trainer = JTrainer(cfg, steps_per_epoch=1)
    x = np.zeros((1, cfg.seq_len, cfg.enc_in), np.float32)
    mask = np.ones((1, cfg.seq_len), np.float32)
    state = trainer.init_state((x, np.zeros(1, np.int32), mask,
                                np.ones(1, np.float32)),
                               seed=max(cfg.seed, 0))
    save_checkpoint(out_dir, state.params, state.batch_stats)
    return cfg


NARROW = {"--synthetic_trials": "600", "--max_subjects": "3",
          "--target_channels": "8", "--target_timepoints": "128",
          "--d_model": "16", "--d_ff": "32", "--batch_size": "8",
          "--num_shapelet": "2"}


def _narrow(argv: list) -> list:
    out = list(argv)
    for i, a in enumerate(out[:-1]):
        if a in NARROW:
            out[i + 1] = NARROW[a]
    return out + ["--n_heads", "2", "--e_layers", "1", "--no-amp"]


def test_folds_start_from_the_jax_initial_variables(tmp_path):
    row = {"model": "InterpGN", "dnn_type": "Transformer", "lr": 1e-3,
           "lr_warmup_epochs": 2.0, "lr_decay": False, "epochs": 1,
           "patience": 6, "num_shapelet": 10, "beta_schedule": "constant"}
    argv = _narrow(cli_flags(row, str(tmp_path)))
    init = str(tmp_path / "init")
    jcfg = write_jax_initial_variables(argv, init)
    jtrainer = JTrainer(jcfg, steps_per_epoch=1)
    with open(os.path.join(init, "checkpoint.msgpack"), "rb") as f:
        from flax import serialization
        saved = serialization.msgpack_restore(f.read())

    args = port_run.get_args(argv + ["--device", "cpu"])
    cfg = port_run.args_to_config(args, args.seed)
    base = port_experiment.Experiment
    with folds_start_from(init):
        exp = port_experiment.Experiment(cfg, loso_test_subject=0,
                                         verbose=False, device="cpu")
    assert port_experiment.Experiment is base
    held = to_jax_variables(exp.trainer.model)
    mine = jax.tree_util.tree_leaves_with_path(held["params"])
    theirs = jax.tree_util.tree_leaves_with_path(saved["params"])
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (_, a), (_, b) in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)

    x, _y, mask = (np.asarray(t[:4]) for t in (
        exp.test_data.x, exp.test_data.y, exp.test_data.padding_mask))
    want = jtrainer.model.apply({"params": saved["params"]}, x, mask,
                                train=False)[0]
    model = exp.trainer.model.eval()
    with torch.no_grad():
        got = model(torch.as_tensor(x), torch.as_tensor(mask))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("amp", [False, True])
def test_a_cert_fold_trains_as_the_jax_fold(tmp_path, amp):
    from sie_tpu.train.experiment import Experiment as JExperiment
    row = {"model": "InterpGN", "dnn_type": "Transformer", "lr": 1e-3,
           "lr_warmup_epochs": 2.0, "lr_decay": False, "epochs": 6,
           "patience": 6, "num_shapelet": 10, "beta_schedule": "constant"}
    argv = [a for a in _narrow(cli_flags(row, str(tmp_path)))
            if a != "--no-amp" or not amp] + ["--no_pallas"]
    init = str(tmp_path / "init")
    write_jax_initial_variables(argv, init)
    jargs = jax_run.get_args(argv)
    jrec, prec = [], []
    jexp = JExperiment(jax_run.args_to_config(jargs, jargs.seed),
                       loso_test_subject=0, verbose=False,
                       metrics_hook=jrec.append)
    jexp._init_state()
    args = port_run.get_args(argv + ["--device", "cpu"])
    cfg = port_run.args_to_config(args, args.seed)
    with folds_start_from(init):
        pexp = port_experiment.Experiment(
            cfg.replace(checkpoint_dir=str(tmp_path / "pck")),
            loso_test_subject=0, verbose=False, metrics_hook=prec.append,
            device="cpu")
    jexp.train()
    pexp.train()
    # under amp: the bf16 limit of tests/test_torch_port_models.py on the
    # losses, and one row either way on the accuracies
    tol = 5e-2 if amp else 1e-4
    val_rows = 1 / len(pexp.val_data) if amp else 0.0
    test_rows = 100 / len(pexp.test_data) if amp else 1e-9
    assert len(jrec) == len(prec) == row["epochs"]
    for j, p in zip(jrec, prec):
        assert p["train_loss"] == pytest.approx(j["train_loss"], abs=tol)
        assert p["val_loss"] == pytest.approx(j["val_loss"], abs=tol)
        assert p["val_accuracy"] == pytest.approx(j["val_accuracy"],
                                                  abs=val_rows)
        assert p["beta"] == j["beta"]
    assert pexp.epoch_stop == jexp.epoch_stop
    assert np.array_equal(pexp.test_data.y, jexp.test_data.y)
    want = jexp.test(save_csv=False)[1]["accuracy"]
    assert want > 50.0     # the fold learns (chance is 100/39 %)
    assert pexp.test(save_csv=False)[1]["accuracy"] == pytest.approx(
        want, abs=test_rows)


def test_the_port_draws_its_initial_weights_as_the_jax_package(tmp_path):
    """Without `--init_from` the port starts from its own draw: leaf for
    leaf the same shapes and the same distributions as the JAX package's
    (constant leaves equal; leaves of 1000 or more values with stds within
    10 % and means within 5 standard errors), at d_model 64."""
    from sie_tpu_torch.models.registry import build_model
    row = {"model": "InterpGN", "dnn_type": "Transformer", "lr": 1e-3,
           "lr_warmup_epochs": 2.0, "lr_decay": False, "epochs": 1,
           "patience": 6, "num_shapelet": 10, "beta_schedule": "constant"}
    wider = {"--d_model": "64", "--d_ff": "128"}
    argv = [wider.get(prev, a) for prev, a in
            zip([""] + _narrow(cli_flags(row, str(tmp_path))),
                _narrow(cli_flags(row, str(tmp_path))))]
    jcfg = write_jax_initial_variables(argv, str(tmp_path / "init"))
    with open(os.path.join(str(tmp_path / "init"), "checkpoint.msgpack"),
              "rb") as f:
        from flax import serialization
        theirs = serialization.msgpack_restore(f.read())["params"]
    args = port_run.get_args(argv + ["--device", "cpu"])
    cfg = port_run.args_to_config(args, args.seed).replace(
        seq_len=jcfg.seq_len, enc_in=jcfg.enc_in, num_class=jcfg.num_class,
        pred_len=0, label_len=0)
    mine = to_jax_variables(build_model(
        cfg, "cpu", torch.Generator().manual_seed(cfg.seed)))["params"]
    pairs = list(zip(jax.tree_util.tree_leaves_with_path(mine),
                     jax.tree_util.tree_leaves_with_path(theirs)))
    assert len(pairs) == len(jax.tree_util.tree_leaves(theirs))
    compared = 0
    for (pa, a), (pb, b) in pairs:
        assert pa == pb and a.shape == b.shape
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if b.std() == 0:
            np.testing.assert_array_equal(a, b)
        elif b.size >= 1000:
            assert a.std() == pytest.approx(b.std(), rel=0.1), pa
            assert abs(a.mean() - b.mean()) < 5 * b.std() / np.sqrt(b.size)
            compared += 1
    assert compared >= 9      # the dense kernels and the longer banks


def main(argv=None) -> int:
    import json
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--tag", default="IGN+Trans lr1e-3 wu2")
    args = p.parse_args(argv)
    with open(os.path.join(ROOT, "docs", "cert39.json")) as f:
        [row] = [r for r in json.load(f) if r["tag"] == args.tag]
    cfg = write_jax_initial_variables(cli_flags(row, args.out), args.out)
    size = os.path.getsize(os.path.join(args.out, "checkpoint.msgpack"))
    print(f"JAX initial variables of {args.tag!r} (seed {cfg.seed}, "
          f"seq_len {cfg.seq_len}, enc_in {cfg.enc_in}, num_class "
          f"{cfg.num_class}): {size} bytes in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
