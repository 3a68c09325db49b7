"""The JAX package's extra layer families (counterpart of
sie_tpu/models/extra/): the attention variants (DS, ProbSparse, LSH,
two-stage), the Autoformer, FEDformer (Fourier and multiwavelet),
ETSformer, Pyraformer and Crossformer blocks, their classification,
imputation and anomaly backbones and their forecasters, and the 2D
Inception blocks. Plain PyTorch: none of them reaches a TPU kernel in the
JAX package, so none launches a kernel of this port."""
