"""Kernels with their plain PyTorch versions, and plain ops (counterpart of moegan_tpu/ops)."""
