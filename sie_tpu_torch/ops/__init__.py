"""The port's kernels. Importing the package registers the forward kernels
K1, K3, K5 and K9 as the PyTorch ops `sie_tpu_torch::l1_fwd`,
`sie_tpu_torch::l1_grouped_fwd`, `sie_tpu_torch::attention_fwd` and
`sie_tpu_torch::flash_fwd`, which an exported program
(`serve.CompiledPredictor`) needs."""

from sie_tpu_torch.ops import attention, flash, shapelet_l1  # noqa: F401
