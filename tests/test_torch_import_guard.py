"""cmrtpu_torch never imports cmrtpu, jax, flax, optax, orbax, pandas,
scikit-learn or h5py (the keras route imports h5py only when it reads a
model.h5), nor tensorflow (``tools/tf_twin_ab.py`` imports it in
``main``).

The port runs on hosts that have none of them and keeps its own copies of
the host modules it needs, so every module of the package — the serving,
training, prediction, evaluation and dataset entry points first — is
imported in a fresh interpreter and ``sys.modules`` is checked for those
packages and for ``cmrtpu`` and every ``cmrtpu.*`` module. ``CMRTPU_PLATFORM`` is set, which makes
``cmrtpu/__init__.py`` import jax: the port must not care. matplotlib (the
card has none) is imported only inside the functions that draw: importing
every module but ``utils/notebook_imports.py`` loads neither it nor
pandas, and that one loads no pandas either."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
import cmrtpu_torch, cmrtpu_torch.predict.serving, cmrtpu_torch.cli.serve
import cmrtpu_torch.cli.train, cmrtpu_torch.train.fold
import cmrtpu_torch.cli.predict, cmrtpu_torch.cli.evaluate_cv
import cmrtpu_torch.cli.predict_4d, cmrtpu_torch.train.keras_import
import cmrtpu_torch.data.analytics, cmrtpu_torch.eval.file_metrics
import cmrtpu_torch.cli.make_dataset, cmrtpu_torch.tools.full_cv_demo
import cmrtpu_torch.tools.cine_quality_demo, cmrtpu_torch.ops.cuda_kernels
import cmrtpu_torch.cli.export, cmrtpu_torch.predict.tta
import cmrtpu_torch.predict.ensemble, cmrtpu_torch.predict.quantize
import cmrtpu_torch.predict.export, cmrtpu_torch.ops.int8_conv
import cmrtpu_torch.train.streaming, cmrtpu_torch.parallel.prefetch
import cmrtpu_torch.parallel.mesh
import cmrtpu_torch.train.manual_collectives, cmrtpu_torch.utils.profiling
import cmrtpu_torch.visualization.visualize
import cmrtpu_torch.visualization.analysis, cmrtpu_torch.tools.predict_ab
import cmrtpu_torch.tools.tta_ab, cmrtpu_torch.tools.int8_ab
import cmrtpu_torch.tools.soup_ab, cmrtpu_torch.tools.synthetic_quickstart
import cmrtpu_torch.tools.analyze_results, cmrtpu_torch.tools.roofline
import cmrtpu_torch.tools.probe2d, cmrtpu_torch.tools.probe3d
import cmrtpu_torch.tools.tf_twin_ab
for info in pkgutil.walk_packages(cmrtpu_torch.__path__, "cmrtpu_torch."):
    importlib.import_module(info.name)
banned = ("jax", "flax", "optax", "orbax", "pandas", "sklearn", "cmrtpu",
          "h5py", "tensorflow", "tf_keras")
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print("loaded:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, CMRTPU_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# every module but notebook_imports (whose purpose is to import pyplot for
# a session) imports matplotlib only inside the functions that draw, and
# notebook_imports still loads no pandas
_LAZY = """
import importlib, pkgutil, sys
import cmrtpu_torch
SESSION = "cmrtpu_torch.utils.notebook_imports"
names = [i.name for i in pkgutil.walk_packages(cmrtpu_torch.__path__,
                                                "cmrtpu_torch.")]
assert SESSION in names and "cmrtpu_torch.visualization.analysis" in names
for name in names:
    if name != SESSION:
        importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("matplotlib", "pandas"))
print("loaded:", loaded)
session = importlib.import_module(SESSION)
pandas = [m for m in sys.modules if m.split(".")[0] == "pandas"]
print("session pandas:", pandas, session.pd)
sys.exit(1 if loaded or pandas or session.pd is not None else 0)
"""


def test_port_imports_no_matplotlib_or_pandas():
    proc = subprocess.run([sys.executable, "-c", _LAZY], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
