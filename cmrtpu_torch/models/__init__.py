"""PyTorch counterparts of ``cmrtpu.models``."""
