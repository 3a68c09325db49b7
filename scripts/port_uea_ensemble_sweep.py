"""UEA sweep through the port: every seed of each dataset trains in one
program (sie_tpu_torch/train/ensemble_driver.py) instead of the
reference's sequential 5-seed loop (reference run_uea.sh + run.py:564-625).

    python scripts/port_uea_ensemble_sweep.py --data_root ./data/UEA \\
        --datasets BasicMotions Epilepsy --model InterpGN --dnn_type FCN \\
        --train_epochs 500 --patience 50

Any flag of `python -m sie_tpu_torch.run` is accepted (the parser is
shared), `--device` included (default cuda); `--datasets` replaces
`--dataset`. A missing archive is reported and skipped, as run_uea.sh
does. The summary is printed and returned.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    import numpy as np

    from sie_tpu_torch.config import DEFAULT_SEEDS
    from sie_tpu_torch.run import args_to_config, get_args
    from sie_tpu_torch.train.ensemble_driver import run_ensemble_experiment

    argv = list(sys.argv[1:] if argv is None else argv)
    datasets = []
    if "--datasets" in argv:
        i = argv.index("--datasets")
        j = i + 1
        while j < len(argv) and not argv[j].startswith("--"):
            datasets.append(argv[j])
            j += 1
        del argv[i:j]
    args = get_args(argv)
    if not datasets:
        datasets = [args.dataset]
    seeds = [args.seed] if args.seed >= 0 else list(DEFAULT_SEEDS)

    summary = {}
    for name in datasets:
        cfg = args_to_config(args, seed=seeds[0]).replace(
            data="UEA", dataset=name)
        try:
            results = run_ensemble_experiment(cfg, seeds=seeds,
                                              device=args.device)
        except FileNotFoundError as e:
            print(f"[{name}] SKIPPED: {e}", flush=True)
            continue
        accs = [r["accuracy"] for r in results]
        summary[name] = (float(np.mean(accs)), float(np.std(accs)))
        print(f"[{name}] accuracy {np.mean(accs):.2f} +/- {np.std(accs):.2f}"
              f"  (seeds {[r['seed'] for r in results]}, "
              f"stops {[r['epoch_stop'] for r in results]})", flush=True)

    if summary:
        print("\n=== sweep summary ===")
        for name, (m, s) in summary.items():
            print(f"{name}: {m:.2f} +/- {s:.2f}")
    return summary


if __name__ == "__main__":
    main()
