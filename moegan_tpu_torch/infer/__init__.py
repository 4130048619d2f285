"""Sampling and serving (counterpart of moegan_tpu/infer)."""
