"""Common interactive-session imports and seeding — counterpart of
``cmrtpu/utils/notebook_imports.py`` (parity with
src/utils/Notebook_imports.py:1-29).

Usage in a notebook or REPL::

    from cmrtpu_torch.utils.notebook_imports import *

Seeds Python's and numpy's global generators with ``SEED``; sets no torch
generator (the port draws from explicit ``torch.Generator``s). ``pd`` is
always None: the port keeps no pandas. ``plt`` and the ipywidgets helpers
are None where their packages are missing (the card's host).
"""

import logging
import os
import random
import sys

import numpy as np

try:
    import matplotlib
    import matplotlib.pyplot as plt
except ImportError:  # headless minimal env
    plt = None
pd = None

SEED = 42
random.seed(SEED)
np.random.seed(SEED)

logging.basicConfig(level=logging.INFO,
                    format="%(asctime)s %(levelname)s %(message)s")
logger = logging.getLogger(__name__)

try:  # widget interactivity if available (notebooks only)
    from ipywidgets import interact, interact_manual  # noqa: F401
except ImportError:
    interact = interact_manual = None

__all__ = ["logging", "logger", "np", "os", "pd", "plt", "random", "sys",
           "SEED", "interact", "interact_manual"]
