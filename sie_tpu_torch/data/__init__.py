"""Data loading for sie_tpu_torch (counterpart of sie_tpu/data)."""
