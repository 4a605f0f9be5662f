"""cmrtpu_torch never imports jax, flax, optax, orbax or pandas.

The port runs on hosts that have none of them, so every module of the
package — the serving entry points first — is imported in a fresh
interpreter and ``sys.modules`` is checked."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
import cmrtpu_torch, cmrtpu_torch.predict.serving, cmrtpu_torch.cli.serve
for info in pkgutil.walk_packages(cmrtpu_torch.__path__, "cmrtpu_torch."):
    importlib.import_module(info.name)
bad = [m for m in ("jax", "flax", "optax", "orbax", "pandas") if m in sys.modules]
print("loaded:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    # cmrtpu/__init__.py imports jax when CMRTPU_PLATFORM is set
    env = {k: v for k, v in os.environ.items() if k != "CMRTPU_PLATFORM"}
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
