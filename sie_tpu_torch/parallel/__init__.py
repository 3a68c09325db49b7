"""Work spread over subjects or devices (counterpart of sie_tpu/parallel/)."""
