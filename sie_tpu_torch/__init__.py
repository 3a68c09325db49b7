"""sie_tpu_torch — the PyTorch and CUDA port of sie_tpu for NVIDIA Hopper.

The JAX package `sie_tpu` stays the reference; this package imports torch,
numpy and the standard library only. Its Pallas kernels become CUDA C++
kernels under `csrc/`, built by nvcc for sm_90a at first use
(`ops/build.py`); each kernel's wrapper runs the kernel for a CUDA tensor
and its plain PyTorch version for a CPU tensor.

Ported so far: the serving forward of InterpGN / SBM / LTS / DNN with the
Transformer expert (`serve.Predictor`) and their training step
(`train.trainer.Trainer`), with kernels K1/K2 (shapelet distance, forward
and backward, `ops/shapelet_l1.py`) and K5/K6 (fused attention with
dropout, forward and backward, `ops/attention.py`).
"""
