"""Figures (counterparts of ``cmrtpu.visualization``). matplotlib is
imported inside each function that draws: a host without it (the card's)
imports these modules and fails only when it asks for a figure."""
