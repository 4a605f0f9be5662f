"""PyTorch counterparts of ``cmrtpu.train`` (weights only, so far)."""
