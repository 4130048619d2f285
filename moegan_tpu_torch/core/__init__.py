"""Building blocks of the generator (counterpart of moegan_tpu/core)."""
