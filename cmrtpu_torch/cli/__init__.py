"""Command-line entry points of ``cmrtpu_torch``."""
