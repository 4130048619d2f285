"""Losses of the training step (counterpart of moegan_tpu/losses/)."""
