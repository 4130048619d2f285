"""Checkpoint reading (counterpart of moegan_tpu/utils)."""
