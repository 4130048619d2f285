"""The training step (counterpart of moegan_tpu/train/)."""
