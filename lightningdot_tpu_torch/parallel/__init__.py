"""Data parallelism of the port (counterpart of lightningdot_tpu/parallel):
process groups over ``torch.distributed`` for training, and device meshes
for the sharded corpus."""
