"""One-off measurement scripts of cmrtpu_torch, run as modules on a card."""
