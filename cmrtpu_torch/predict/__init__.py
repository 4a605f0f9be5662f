"""PyTorch counterparts of ``cmrtpu.predict`` (the serving path)."""
