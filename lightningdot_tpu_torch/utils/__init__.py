"""Host-side utilities of the port (counterpart of lightningdot_tpu/utils):
retrieval metrics and the logger."""
