"""Command-line drivers of the port (counterpart of lightningdot_tpu/cli)."""
