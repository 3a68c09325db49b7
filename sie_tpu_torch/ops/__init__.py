"""The port's kernels. Importing the package registers the forward kernels
K1, K3 and K5 as the PyTorch ops `sie_tpu_torch::l1_fwd`,
`sie_tpu_torch::l1_grouped_fwd` and `sie_tpu_torch::attention_fwd`, which
an exported program (`serve.CompiledPredictor`) needs."""

from sie_tpu_torch.ops import attention, shapelet_l1  # noqa: F401
