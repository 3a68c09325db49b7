"""sie_tpu_torch — the PyTorch and CUDA port of sie_tpu for NVIDIA Hopper.

The JAX package `sie_tpu` stays the reference; this package imports torch,
numpy and the standard library only. Its Pallas kernels become CUDA C++
kernels under `csrc/`, built by nvcc for sm_90a at first use
(`ops/build.py`); each kernel's wrapper runs the kernel for a CUDA tensor
and its plain PyTorch version for a CPU tensor.

Ported so far: the serving forward of InterpGN / SBM / LTS / DNN with the
Transformer, FCN, ResNet, TimesNet and PatchTST experts and EEGCNN, their training step and
the epoch-staged train and eval paths, captured as CUDA graphs on the card
(`train.trainer.Trainer`), the classification experiment with its data
path and flax-format checkpoints (`train.experiment.Experiment`), and the
command line `python -m sie_tpu_torch.run` with run.py's options past
classification: on-device augmentation (`data.augment`), regression on
the Monash archive (`train.regression.RegressionExperiment`), the
reference's `checkpoint.pth` in and out (`compat.torch_import`,
`compat.torch_export`), leave-one-subject-out folds on one device
(`parallel.loso`), profiler traces and NaN checks (`utils.profiling`);
kernels K1/K2 (shapelet
distance, forward and backward, `ops/shapelet_l1.py`; K3/K4 for grouped
banks) and K5/K6 (fused attention with dropout, forward and backward,
`ops/attention.py`), the forwards K1, K3 and K5 registered as the PyTorch
ops `sie_tpu_torch::l1_fwd`, `l1_grouped_fwd` and `attention_fwd`.

The serving surface:
- `serve.Predictor`: bucket-padded batch inference, `from_checkpoint`,
  `save_bundle` / `load_bundle` (f32 `checkpoint.msgpack` or int8
  `weights_q.npz`, held as int8 on the device; bundles of either package
  serve in the other), `calibrate` (temperature), `warmup`, and
  `export_stablehlo` (`torch.export` programs, one per bucket);
- `serve.CompiledPredictor`: serves those programs with `ops` alone;
- `quant`: the int8 weight format;
- `python -m sie_tpu_torch.serve_http --bundle DIR` (or `--stablehlo
  DIR`): the JAX package's HTTP API, byte for byte;
- `client.InferenceClient`: its client (numpy and the standard library);
- `python -m sie_tpu_torch.run ... --export_bundle DIR [--quantize_bundle]
  [--export_stablehlo DIR]`.
"""

__version__ = "0.1.0"
