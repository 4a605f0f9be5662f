"""Landmark detection and live metrics (counterparts of ``cmrtpu.eval``)."""
