"""sie_tpu_torch — the PyTorch and CUDA port of sie_tpu for NVIDIA Hopper.

The JAX package `sie_tpu` stays the reference; this package imports torch,
numpy and the standard library only. Its Pallas kernels become CUDA C++
kernels under `csrc/`, built by nvcc for sm_90a at first use
(`ops/build.py`); each kernel's wrapper runs the kernel for a CUDA tensor
and its plain PyTorch version for a CPU tensor.

Ported so far: the serving forward of InterpGN / SBM / LTS / DNN with the
Transformer expert (`serve.Predictor`), their training step and the
epoch-staged train and eval paths, captured as CUDA graphs on the card
(`train.trainer.Trainer`), the classification experiment with its data
path and flax-format checkpoints (`train.experiment.Experiment`), and the
command line `python -m sie_tpu_torch.run`; kernels K1/K2 (shapelet
distance, forward and backward, `ops/shapelet_l1.py`; K3/K4 for grouped
banks) and K5/K6 (fused attention with dropout, forward and backward,
`ops/attention.py`).
"""
