"""Host utilities (copies of ``cmrtpu.utils`` modules)."""
