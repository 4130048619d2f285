"""Command-line entry points (counterpart of moegan_tpu/cli/)."""
