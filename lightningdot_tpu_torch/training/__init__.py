"""Training-side modules of the port (counterpart of
lightningdot_tpu/training)."""
