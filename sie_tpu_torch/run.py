"""The command line of the port (counterpart of the repo's run.py):

    python -m sie_tpu_torch.run --data EEG3 --model InterpGN ...

It takes run.py's flags, plus `--device` (default `cuda`; `--device cpu`
runs the plain PyTorch versions of the kernels). Per seed of {0, 42, 1234,
8237, 2023} (or `--seed`): the forecast, imputation and anomaly tasks
(`--task_name long_term_forecast | short_term_forecast | imputation |
anomaly_detection`, train/tasks.py, `--dnn_type Transformer | TimesNet |
PatchTST`) train, test, print their metrics and pickle them as
`{result_dir}/{model}/{task_name}_seed{seed}.pkl` (M4: also
`{seasonal_patterns}_forecast.csv`); otherwise build the experiment
(classification, or `--task_name regression` on `--data Monash` with the
CRPS head) -> with
`--import_torch_ckpt PATH` load a reference `checkpoint.pth` and skip
training, else skip training when its checkpoint exists, else train ->
reload the best -> test (CSV summary and `test_results.pkl`) ->
`--export_bundle DIR` (a serving bundle, int8 weights under
`--quantize_bundle`), `--export_stablehlo DIR` (`torch.export` programs for
`--stablehlo_batch_sizes`), in `seed-<n>` subdirectories when there are
several seeds, and `--export_torch_ckpt PATH` (a reference-layout
`checkpoint.pth`, `.seed<n>` appended when there are several seeds) ->
accuracy against the random baseline (classification). `--augment
noise,scale,chdrop,tshift` augments the train batches on the device.
`--loso` with EEG or EEG3 runs one fold per held-out subject (each over
the mesh under `--mesh`) and prints the folds' mean accuracy; under the
launch variables of parallel/multihost.py (SIE_TPU_COORDINATOR,
SIE_TPU_NUM_PROCESSES, SIE_TPU_PROCESS_ID) without `--mesh` each process
takes its contiguous slice of the folds (`run_loso_multihost`) and prints
`[multihost] process i/n took folds ...`. Serve a bundle with `python -m
sie_tpu_torch.serve_http --bundle DIR`. `--stream_from_disk` keeps the
classification and regression splits in memmap caches under
`--cache_dir` and feeds training from the host (data/stream.py).

`--profile_dir DIR` writes a torch.profiler trace of training there, and
`--debug_nans` raises FloatingPointError at the first non-finite value a
train step or eval pass makes, naming the step and the operation
(utils/profiling.py).

`--mesh 8` (or `4x2` over `--mesh_axes data,model`) trains, tests and
serves over a process mesh (parallel/mesh.py), one process a card: under
the launch variables this process is one rank; without them the command
starts the workers itself (`multihost.spawn_workers`: one a local card
over NCCL, or with `--device cpu` or an explicit `--device cuda:K` that
many processes over gloo) and returns the first failing exit code.
Classification and regression take the mesh; process 0 writes the
checkpoints, CSVs, pickles and exports, gathered to the full layout.
Every axis of the JAX CLI is taken: 'data', 'model', 'seq', 'expert'
and 'pipe' (replication in training, as in the JAX Trainer); an unknown
axis name, or fewer names than the mesh has dimensions, raises
ValueError before any process starts. Checkpoint converters the
reference lacks (the extra backbones) raise where they are called.
`--no_pallas`, `--multi_gpu` and `--num_workers` are accepted and change
nothing, as in run.py off a TPU.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from sie_tpu_torch.config import DEFAULT_SEEDS, Config
from sie_tpu_torch.data.augment import validate as validate_augment


def get_args(argv=None):
    p = argparse.ArgumentParser()
    # ===== EEG data params =====
    p.add_argument("--data", type=str, default="EEG3",
                   choices=["EEG", "EEG3", "UEA", "Monash",
                            "ETTh1", "ETTh2", "ETTm1", "ETTm2", "custom",
                            "m4", "PSM", "MSL", "SMAP", "SMD", "SWAT"],
                   help="every family is ported: EEG, EEG3 and UEA "
                        "(classification), Monash (regression), ETT*, "
                        "custom and m4 (forecasting), PSM, MSL, SMAP, SMD "
                        "and SWAT (anomaly detection)")
    p.add_argument("--data_root", type=str, default="./data")
    p.add_argument("--json_path", type=str, default="./data/textmaps.json")
    p.add_argument("--target_channels", type=int, default=122)
    p.add_argument("--target_timepoints", type=int, default=1651)
    p.add_argument("--max_files", type=int, default=1000)
    p.add_argument("--max_subjects", type=int, default=5)
    p.add_argument("--synthetic_trials", type=int, default=0,
                   help="synthetic-EEG fallback: generate exactly this many "
                        "trials (imbalanced classes, max_subjects subjects); "
                        "0 = min(max_files*10, 240)")
    p.add_argument("--subject_id", type=str, default="sub-01")
    p.add_argument("--subject_ids", type=str, nargs="+",
                   default=["sub-01,sub-02,sub-03"])
    p.add_argument("--task_type", type=str, default="imagine",
                   choices=["imagine", "read", "both"])
    p.add_argument("--normalizer", type=str, default="standardization",
                   choices=["standardization", "minmax", "per_sample_std",
                            "per_sample_minmax"],
                   help="UEA whole-set/per-sample normalization mode")
    # ===== EEGCNN =====
    p.add_argument("--eegcnn_layers", type=int, default=2)
    p.add_argument("--eegcnn_pooling", type=str, default="mean",
                   choices=["none", "mean", "sum", "top"])
    p.add_argument("--eegcnn_cnn_f1", type=int, default=8)
    p.add_argument("--eegcnn_cnn_f2", type=int, default=8)
    p.add_argument("--eegcnn_kernel1", type=int, default=125)
    p.add_argument("--eegcnn_kernel2", type=int, default=25)
    p.add_argument("--eegcnn_pool1", type=int, default=2)
    p.add_argument("--eegcnn_pool2", type=int, default=5)
    p.add_argument("--eegcnn_dropout1", type=float, default=0.1)
    p.add_argument("--eegcnn_dropout2", type=float, default=0.1)
    p.add_argument("--eegcnn_n_heads", type=int, default=8)
    p.add_argument("--eegcnn_d_ff", type=int, default=256)
    # ===== model / SBM hyperparams =====
    p.add_argument("--model", type=str, default="InterpGN",
                   choices=["SBM", "LTS", "InterpGN", "DNN", "EEGCNN"])
    p.add_argument("--dnn_type", type=str, default="Transformer",
                   choices=["FCN", "Transformer", "TimesNet", "PatchTST",
                            "ResNet", "Autoformer", "FEDformer", "ETSformer",
                            "Pyraformer", "Crossformer"],
                   help="deep backbone (InterpGN's expert, DNN, and the "
                        "forecast, imputation and anomaly branches)")
    p.add_argument("--dataset", type=str, default="BasicMotions")
    p.add_argument("--lambda_reg", type=float, default=0.1)
    p.add_argument("--lambda_div", type=float, default=0.1)
    p.add_argument("--epsilon", type=float, default=1.0)
    p.add_argument("--num_shapelet", type=int, default=10)
    p.add_argument("--gating_value", type=float, default=None)
    p.add_argument("--pos_weight", action="store_true")
    p.add_argument("--sbm_cls", type=str, default="linear")
    p.add_argument("--distance_func", type=str, default="euclidean")
    p.add_argument("--beta_schedule", type=str, default="constant")
    p.add_argument("--memory_efficient", action="store_true")
    # ===== experiment config =====
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--lr_decay", action="store_true")
    p.add_argument("--lr_warmup_epochs", type=float, default=0.0,
                   help="linear lr warmup over the first N epochs (0 = off)")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--gradient_clip", type=float, default=0)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--log_interval", type=int, default=20)
    p.add_argument("--min_epochs", type=int, default=0)
    p.add_argument("--train_epochs", type=int, default=500)
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--patience", type=int, default=50)
    p.add_argument("--multi_gpu", action="store_true",
                   help="accepted for compatibility; changes nothing")
    p.add_argument("--test_only", action="store_true")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--amp", action=argparse.BooleanOptionalAction, default=True)
    # ===== basic config =====
    p.add_argument("--task_name", type=str, default="classification",
                   choices=["classification", "regression",
                            "long_term_forecast", "short_term_forecast",
                            "imputation", "anomaly_detection"],
                   help="every task is ported; the Autoformer family "
                        "has no task branch yet (raises)")
    p.add_argument("--model_id", type=str, default="test")
    p.add_argument("--embed", type=str, default="timeF")
    p.add_argument("--freq", type=str, default="h")
    # ===== DNN configs =====
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--num_kernels", type=int, default=6)
    p.add_argument("--patch_chunk_rows", type=int, default=0)
    p.add_argument("--enc_in", type=int, default=7)
    p.add_argument("--dec_in", type=int, default=7)
    p.add_argument("--c_out", type=int, default=7)
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--n_heads", type=int, default=8)
    p.add_argument("--e_layers", type=int, default=2)
    p.add_argument("--d_layers", type=int, default=1)
    p.add_argument("--d_ff", type=int, default=2048)
    p.add_argument("--moving_avg", type=int, default=25)
    p.add_argument("--factor", type=int, default=1)
    p.add_argument("--distil", action="store_false", default=True)
    p.add_argument("--dropout", type=float, default=0)
    p.add_argument("--activation", type=str, default="gelu")
    p.add_argument("--output_attention", action="store_true")
    p.add_argument("--seq_len", type=int, default=96,
                   help="classification derives seq_len from the data")
    p.add_argument("--label_len", type=int, default=48)
    p.add_argument("--pred_len", type=int, default=96)
    p.add_argument("--seasonal_patterns", type=str, default="Monthly")
    p.add_argument("--inverse", action="store_true", default=False)
    p.add_argument("--features", type=str, default="M",
                   choices=["M", "S", "MS"])
    p.add_argument("--target", type=str, default="OT")
    p.add_argument("--mask_rate", type=float, default=0.25)
    p.add_argument("--anomaly_ratio", type=float, default=1.0)
    # ===== accelerator =====
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the card; raises without one) or 'cpu' "
                        "(the kernels' plain PyTorch versions)")
    p.add_argument("--mesh", type=str, default="",
                   help="device mesh, e.g. '8' (dp) or '4x2' (dp x mp): "
                        "one process a card (parallel/mesh.py); the "
                        "forecast, imputation and anomaly tasks train on "
                        "one device and ignore it, as in the JAX package")
    p.add_argument("--mesh_axes", type=str, default="data,model",
                   help="comma-separated mesh axis names matching --mesh, "
                        "from {data, seq, model, expert, pipe}: e.g. "
                        "'data,seq,model' with --mesh 2x2x2, 'data,expert' "
                        "with --mesh 2x4")
    p.add_argument("--moe_experts", type=int, default=0,
                   help="replace the Transformer encoder's FFN with a "
                        "Switch mixture of this many expert FFNs "
                        "(models/moe.py)")
    p.add_argument("--moe_capacity_factor", type=float, default=1.25)
    p.add_argument("--moe_top_k", type=int, default=1)
    p.add_argument("--moe_aux_weight", type=float, default=0.01)
    p.add_argument("--no_pallas", action="store_true",
                   help="accepted for compatibility; the port always runs "
                        "its CUDA kernels on the card")
    p.add_argument("--fused_attention_max_len", type=int, default=4096,
                   help="sequence length above which attention takes the "
                        "plain path (0 = every length through K5/K6)")
    p.add_argument("--scan_epoch", action="store_true",
                   help="run each training epoch as one replayed CUDA "
                        "graph (Trainer.train_epoch_staged)")
    p.add_argument("--scan_eval", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run each validation pass as one replayed graph "
                        "and one host fetch; --no-scan_eval goes batch by "
                        "batch")
    p.add_argument("--fused_attention_min_len", type=int, default=256,
                   help="sequence length below which attention takes the "
                        "plain path (0 = always the kernel)")
    p.add_argument("--attention_variant", type=str, default="full",
                   choices=["full", "ds", "prob", "lsh"],
                   help="the Transformer encoder's attention (full runs "
                        "the fused kernels; ds, prob and lsh are "
                        "models/extra/attention_variants.py)")
    p.add_argument("--loso", action="store_true",
                   help="leave-one-subject-out sweep (EEG), the folds one "
                        "after another, or split across the processes of "
                        "a multi-process launch")
    p.add_argument("--checkpoint_dir", type=str, default="./checkpoints")
    p.add_argument("--result_dir", type=str, default="./result")
    p.add_argument("--cache_dir", type=str, default="./cache")
    p.add_argument("--stream_from_disk", action="store_true",
                   help="keep classification/regression splits in memmap "
                        "caches under --cache_dir, fed from the host "
                        "(data/stream.py)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of training "
                        "(host and card) under this directory")
    p.add_argument("--export_bundle", type=str, default=None,
                   help="write a serving bundle of the tested weights here "
                        "(serve it with python -m "
                        "sie_tpu_torch.serve_http --bundle DIR)")
    p.add_argument("--augment", type=str, default="",
                   help="comma-separated train-time augmentations on the "
                        "device from {noise, scale, chdrop, tshift} "
                        "(data/augment.py; off by default)")
    p.add_argument("--augment_noise_std", type=float, default=0.1)
    p.add_argument("--augment_scale_std", type=float, default=0.1)
    p.add_argument("--augment_chdrop_prob", type=float, default=0.1)
    p.add_argument("--augment_tshift_max", type=int, default=16)
    p.add_argument("--metrics_jsonl", type=str, default=None,
                   help="append one JSON line per epoch (epoch, train_loss, "
                        "val_loss, val_accuracy, beta, seconds, seed)")
    p.add_argument("--export_stablehlo", type=str, default=None,
                   help="write ahead-of-time programs (torch.export, one "
                        "per bucket of --stablehlo_batch_sizes) here; "
                        "serve them with serve.CompiledPredictor or "
                        "serve_http --stablehlo DIR")
    p.add_argument("--stablehlo_batch_sizes", type=int, nargs="+",
                   default=[1, 32])
    p.add_argument("--quantize_bundle", action="store_true",
                   help="--export_bundle with int8 weights "
                        "(weights_q.npz)")
    p.add_argument("--export_torch_ckpt", type=str, default=None,
                   help="after test, write the weights as a "
                        "reference-loadable torch checkpoint.pth "
                        "(compat/torch_export.py; load there with "
                        "strict=False)")
    p.add_argument("--import_torch_ckpt", type=str, default=None,
                   help="evaluate a reference-trained checkpoint.pth "
                        "(compat/torch_import.py); training is skipped")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError at the first non-finite "
                        "loss, gradient, parameter or eval output, naming "
                        "the step and the operation that made it (the "
                        "steps stay CUDA graphs; one host sync a step)")
    return p.parse_args(argv)


def mesh_shape(args) -> tuple:
    return tuple(int(t) for t in args.mesh.split("x") if t) \
        if args.mesh else ()


def mesh_axes(args) -> tuple:
    return tuple(t.strip() for t in args.mesh_axes.split(",") if t.strip())


def check_mesh_args(args) -> None:
    """ValueError for a mesh axis name the mesh does not know, or fewer
    names than `--mesh` has dimensions (parallel/mesh.py `Mesh` refuses
    both), before any process or process group starts."""
    from sie_tpu_torch.parallel.mesh import AXES
    shape, axes = mesh_shape(args), mesh_axes(args)
    if len(axes) < len(shape):
        raise ValueError(f"--mesh {args.mesh} needs {len(shape)} axis names; "
                         f"--mesh_axes gives {axes}")
    for axis in axes[: len(shape)]:
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; one of {AXES}")


def args_to_config(args, seed: int) -> Config:
    subject_ids = []
    for s in args.subject_ids:
        subject_ids.extend(t.strip() for t in s.split(",") if t.strip())
    pooling = None if args.eegcnn_pooling == "none" else args.eegcnn_pooling
    fields = set(Config.__dataclass_fields__)
    kw = {k: v for k, v in vars(args).items() if k in fields}
    kw.update(subject_ids=tuple(subject_ids), seed=seed,
              augment=validate_augment(
                  tuple(t.strip() for t in args.augment.split(",")
                        if t.strip())),
              mesh_shape=mesh_shape(args), mesh_axes=mesh_axes(args),
              use_pallas=not args.no_pallas,
              eegcnn_pooling=pooling, gradient_clip=float(args.gradient_clip),
              dropout=float(args.dropout))
    if args.data in ("EEG", "EEG3"):
        # label artifacts by the EEG workload, not the UEA-only --dataset
        kw["dataset"] = args.data
    return Config(**kw)


def export(experiment, args, seed: int, n_seeds: int, variables=None,
           device=None) -> None:
    """The tested weights as a serving bundle (--export_bundle,
    --quantize_bundle) and as ahead-of-time programs (--export_stablehlo),
    each under seed-<n> when there are several seeds; under a mesh from
    the gathered `variables`."""
    from sie_tpu_torch.serve import Predictor
    device = device or args.device
    pred = (Predictor.from_module(experiment.cfg, experiment.trainer.model,
                                  device=device) if variables is None else
            Predictor(experiment.cfg, variables, device=device))
    sub = lambda d: os.path.join(d, f"seed-{seed}") if n_seeds > 1 else d
    if args.export_bundle:
        bundle_dir = sub(args.export_bundle)
        pred.save_bundle(bundle_dir, quantize=args.quantize_bundle)
        print(f"serving bundle exported to {bundle_dir}"
              + (" (int8 weights)" if args.quantize_bundle else ""))
    if args.export_stablehlo:
        hlo_dir = sub(args.export_stablehlo)
        pred.export_stablehlo(hlo_dir,
                              batch_sizes=tuple(args.stablehlo_batch_sizes))
        print(f"StableHLO serving artifacts exported to {hlo_dir}")


def run_loso_folds(args, cfg, seed: int, mesh, device):
    """--loso on EEG/EEG3: one fold per held-out subject, one after another
    (each over `mesh` when there is one: every process trains every fold),
    or, under a multi-process launch without --mesh, this process's slice
    of the folds -> (seed, None, the folds' metrics)."""
    from sie_tpu_torch.parallel.loso import run_loso
    from sie_tpu_torch.parallel.multihost import (multihost_requested,
                                                  rank_and_world,
                                                  run_loso_multihost)
    if multihost_requested() and mesh is None:
        from sie_tpu_torch.data.eeg import load_eeg_dataset
        probe = load_eeg_dataset(cfg, "train", three_class=(cfg.data == "EEG3"))
        n_subj = (int(probe.subject_ids.max()) + 1
                  if probe.subject_ids is not None else 1)
        fold_results, sl = run_loso_multihost(cfg, n_subj, device=device)
        rank, world = rank_and_world()
        print(f"[multihost] process {rank}/{world} took folds {sl}")
    else:
        fold_results = run_loso(cfg, mesh=mesh, device=device)
    accs = [r["accuracy"] for r in fold_results]
    if not accs:
        print("LOSO: no folds assigned to this process")
        return (seed, None, {"per_fold": []})
    num_class = 3 if cfg.data == "EEG3" else 39
    print(f"LOSO ({len(accs)} folds): accuracy "
          f"{np.mean(accs):.2f} +/- {np.std(accs):.2f} "
          f"(random baseline {100.0 / num_class:.2f})")
    return (seed, None, {"accuracy": float(np.mean(accs)),
                         "random_baseline": 100.0 / num_class,
                         "per_fold": fold_results})


TASKS = ("long_term_forecast", "short_term_forecast", "imputation",
         "anomaly_detection")


def run_task(args, cfg, seed: int):
    """One seed of a forecast, imputation or anomaly task: train, test,
    print the metrics, pickle them (and the M4 forecasts) under
    {result_dir}/{model} -> (seed, None, metrics)."""
    from sie_tpu_torch.train.tasks import TASK_EXPERIMENTS
    experiment = TASK_EXPERIMENTS[args.task_name](cfg, device=args.device)
    params = experiment.train(seed=seed, verbose=True)
    metrics = experiment.test(params)
    print(f"[{args.task_name}] test: "
          + ", ".join(f"{k} {v:.5f}" for k, v in metrics.items()))
    result_dir = os.path.join(args.result_dir, args.model)
    os.makedirs(result_dir, exist_ok=True)
    if hasattr(experiment, "write_forecast_csv"):
        print("forecasts written to "
              + experiment.write_forecast_csv(params, result_dir))
    path = os.path.join(result_dir, f"{args.task_name}_seed{seed}.pkl")
    with open(path, "wb") as f:
        pickle.dump({"metrics": metrics, "args": vars(args)}, f)
    print(f"results pickled to {path}")
    return seed, None, metrics


def main(argv=None):
    import sys

    import torch.distributed as dist

    from sie_tpu_torch.parallel import multihost
    from sie_tpu_torch.utils.profiling import debug_nans
    argv = list(sys.argv[1:] if argv is None else argv)
    args = get_args(argv)
    check_mesh_args(args)
    n = int(np.prod(mesh_shape(args))) if args.mesh else 1
    if n > 1 and args.task_name in TASKS:
        # the JAX CLI builds the mesh (make_mesh raises on too few
        # devices), then trains the task on one device without it
        multihost.check_mesh_devices(n, args.device)
        print(f"[{args.task_name}] --mesh {args.mesh} is ignored: the task "
              f"trains in one process on one device, as in the JAX package")
        n = 1
    if n > 1 and not multihost.multihost_requested():
        code = multihost.spawn_workers(argv, n, args.device)
        if code:
            raise SystemExit(code)
        return []
    started = multihost.init_distributed(device=args.device)
    try:
        with debug_nans(args.debug_nans):
            return run_seeds(args, multihost.process_device(args.device))
    finally:
        if started:
            dist.destroy_process_group()


def run_seeds(args, device):
    from sie_tpu_torch.compat.from_jax import to_jax_variables
    from sie_tpu_torch.parallel.mesh import is_writer, make_mesh
    from sie_tpu_torch.train.experiment import Experiment
    from sie_tpu_torch.train.regression import RegressionExperiment
    from sie_tpu_torch.utils.profiling import trace

    seeds = list(DEFAULT_SEEDS) if args.seed == -1 else [args.seed]
    all_results = []
    mesh = (None if args.task_name in TASKS
            else make_mesh(args_to_config(args, 0)))
    writer = is_writer(mesh)

    for i, seed in enumerate(seeds):
        print(f"\n===== experiment {i + 1}/{len(seeds)} — seed {seed} =====")
        cfg = args_to_config(args, seed)
        if args.loso and args.data in ("EEG", "EEG3"):
            all_results.append(run_loso_folds(args, cfg, seed, mesh, device))
            continue

        if args.task_name in TASKS:
            all_results.append(run_task(args, cfg, seed))
            continue

        metrics_hook = None
        if args.metrics_jsonl:
            os.makedirs(os.path.dirname(args.metrics_jsonl) or ".",
                        exist_ok=True)

            def metrics_hook(rec, _seed=seed):
                with open(args.metrics_jsonl, "a") as f:
                    f.write(json.dumps(dict(rec, seed=_seed)) + "\n")
        kind = (RegressionExperiment if args.task_name == "regression"
                else Experiment)
        experiment = kind(cfg, metrics_hook=metrics_hook, device=device,
                          mesh=mesh)

        if args.import_torch_ckpt:
            unused = experiment.load_torch_checkpoint(args.import_torch_ckpt)
            print(f"imported torch checkpoint {args.import_torch_ckpt} "
                  f"({len(unused)} source keys without a counterpart)")
        elif not args.test_only:
            if experiment.has_checkpoint():
                print("checkpoint exists — skipping training")
                experiment.load_checkpoint()
            else:
                with trace(args.profile_dir):
                    experiment.train()
        elif not experiment.load_checkpoint():
            print("warning: no checkpoint found; testing a fresh model")

        test_loss, test_metrics, test_result = experiment.test(
            save_csv=True, result_dir=os.path.join(args.result_dir, args.model))
        result_file = os.path.join(experiment.checkpoint_dir, "test_results.pkl")
        if writer:
            os.makedirs(experiment.checkpoint_dir, exist_ok=True)
            with open(result_file, "wb") as f:
                # the per-seed bundle: the ClassificationResult carries x,
                # p, d, eta, the shapelets and w (regression: its dict)
                pickle.dump({"test_loss": test_loss,
                             "test_metrics": test_metrics,
                             "result": test_result, "args": vars(args)}, f)
            print(f"results pickled to {result_file}")

        exporting = (args.export_bundle or args.export_stablehlo
                     or args.export_torch_ckpt)
        # every 'model' rank takes part in gathering the weights
        variables = (to_jax_variables(experiment.trainer.model)
                     if exporting and mesh is not None else None)
        if writer and (args.export_bundle or args.export_stablehlo):
            export(experiment, args, seed, len(seeds), variables, device)
        if writer and args.export_torch_ckpt:
            from sie_tpu_torch.compat.torch_export import save_torch_checkpoint
            pth = (args.export_torch_ckpt if len(seeds) == 1 else
                   args.export_torch_ckpt + f".seed{seed}")
            save_torch_checkpoint(pth, variables or to_jax_variables(
                experiment.trainer.model), experiment.cfg)
            print(f"torch checkpoint exported to {pth}")

        if test_metrics and "accuracy" in test_metrics:
            acc = test_metrics["accuracy"]
            baseline = test_metrics["random_baseline"]
            print(f"accuracy {acc:.2f}% vs random baseline {baseline:.2f}% "
                  f"({acc - baseline:+.2f})")
        all_results.append((seed, test_loss, test_metrics))

    accs = [m["accuracy"] for _, _, m in all_results if m and "accuracy" in m]
    if len(accs) > 1:
        print(f"\n=== {len(accs)} seeds: accuracy "
              f"{np.mean(accs):.2f} +/- {np.std(accs):.2f} ===")
    return all_results


if __name__ == "__main__":
    main()
