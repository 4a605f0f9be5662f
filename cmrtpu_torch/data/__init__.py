"""File naming and fold lists (counterparts of ``cmrtpu.data``)."""
