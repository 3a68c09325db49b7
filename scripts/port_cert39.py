"""The JAX package's 39-class certification through the port's command line,
on the card:

    python scripts/port_cert39.py [--tag "IGN+Trans lr1e-3 wu2"] [--seed 0]
        [--out DIR] [--init_from DIR] [--no-amp]

It builds the flags that scripts/onchip_cert.py `cert_39` builds for the
row `--tag` of docs/cert39.json (synthetic CHISCO at full width: 2000
trials over 5 subjects, 122 channels x 1651 samples, d_model 512, d_ff
2048, batch 64, seed 0, and the row's model, learning rate, warm-up,
epochs and patience; `--seed` another seed for the weights and batches,
the data staying seed 0's), runs `python -m sie_tpu_torch.run --data EEG --loso`
with them in this process (every subject held out once, one fold after
another), and prints each fold's test accuracy beside the row's, then one
JSON line with both. The row's accuracies come from the JAX package on a
TPU; accuracy is not a speed number, so they stand as the reference.

`--init_from DIR` starts every fold from the variables of the checkpoint
directory DIR in place of the port's own initial draw: with the JAX
package's initial weights (`python tests/test_torch_port_cert39_init.py
--out DIR` writes them), the two runs differ only in the devices'
arithmetic (the cert has no dropout, and both packages draw the batch
order from the same numpy seed). `--no-amp` trains in f32.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def cli_flags(row: dict, work: str, seed: int = 0) -> list:
    """onchip_cert.py cert_39's command line for a docs/cert39.json row
    (its scale defaults), with the port's directories under `work`."""
    argv = ["--data", "EEG", "--loso", "--synthetic_trials", "2000",
            "--max_subjects", "5", "--target_channels", "122",
            "--target_timepoints", "1651", "--d_model", "512", "--d_ff",
            "2048", "--batch_size", "64", "--seed", str(seed),
            "--model", row["model"], "--dnn_type", row["dnn_type"],
            "--lr", str(row["lr"]),
            "--lr_warmup_epochs", str(row["lr_warmup_epochs"]),
            "--train_epochs", str(row["epochs"]),
            "--patience", str(row["patience"]),
            "--num_shapelet", str(row["num_shapelet"]),
            "--lambda_reg", "0.1", "--lambda_div", "0.1",
            "--beta_schedule", row["beta_schedule"], "--top_k", "5",
            "--data_root", os.path.join(work, "no_chisco"),
            "--checkpoint_dir", os.path.join(work, "ck"),
            "--result_dir", os.path.join(work, "result"),
            "--cache_dir", os.path.join(work, "cache")]
    if row["lr_decay"]:
        argv.append("--lr_decay")
    return argv


@contextlib.contextmanager
def folds_start_from(ckpt_dir: str):
    """Inside it, every `Experiment` the port builds (one a LOSO fold)
    loads the variables of the checkpoint directory `ckpt_dir` into its
    model after drawing its own."""
    from sie_tpu_torch.compat.from_jax import load_jax_variables
    from sie_tpu_torch.train import checkpoint, experiment
    variables = checkpoint.load_checkpoint(ckpt_dir)
    if variables is None:
        raise FileNotFoundError(f"no checkpoint.msgpack in {ckpt_dir}")
    base = experiment.Experiment

    class FromInit(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            load_jax_variables(self.trainer.model, variables)

    experiment.Experiment = FromInit
    try:
        yield
    finally:
        experiment.Experiment = base


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tag", default="IGN+Trans lr1e-3 wu2")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="directory for the run's files (default: a "
                        "temporary one, removed after)")
    p.add_argument("--init_from", default=None,
                   help="checkpoint directory every fold starts from")
    p.add_argument("--amp", action=argparse.BooleanOptionalAction,
                   default=True)
    args = p.parse_args(argv)
    with open(os.path.join(ROOT, "docs", "cert39.json")) as f:
        [row] = [r for r in json.load(f) if r["tag"] == args.tag]
    from sie_tpu_torch.run import main as run_main
    work = args.out or tempfile.mkdtemp(prefix="port_cert39_")
    t0 = time.perf_counter()
    start = (folds_start_from(args.init_from) if args.init_from
             else contextlib.nullcontext())
    try:
        with start:
            [(_seed, _loss, metrics)] = run_main(
                cli_flags(row, work, args.seed)
                + ([] if args.amp else ["--no-amp"]))
    finally:
        if args.out is None:
            shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t0
    folds = [f["accuracy"] for f in metrics["per_fold"]]
    ref = row["per_fold"]
    for i, acc in enumerate(folds):
        want = f"{ref[i]:.2f}" if i < len(ref) else "not run"
        print(f"[cert39] fold {i + 1} (subject {i} held out): port "
              f"{acc:.2f}%, reference {want}")
    n = min(len(ref), len(folds))
    mean = sum(folds[:n]) / n
    print(f"[cert39] folds 1-{n}: port {mean:.2f}% against the reference "
          f"{row['accuracy_mean']:.2f}% ({wall:.0f} s for "
          f"{len(folds)} folds)")
    print(json.dumps({"tag": args.tag, "seed": args.seed,
                      "init_from": args.init_from, "amp": args.amp,
                      "port_per_fold": folds,
                      "reference_per_fold": ref, "port_mean_first": mean,
                      "reference_mean": row["accuracy_mean"],
                      "wall_s": round(wall, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
