"""Models (counterpart of moegan_tpu/models)."""
