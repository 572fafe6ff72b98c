"""repro_torch.checkpoint — atomic, hash-verified npz checkpoints of any
tree of tensors (``manager``), in the JAX package's on-disk format."""
