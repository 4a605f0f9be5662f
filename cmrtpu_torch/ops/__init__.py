"""PyTorch ops and hand-written CUDA kernels (counterparts of ``cmrtpu.ops``)."""
