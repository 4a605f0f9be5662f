"""No run loads JAX or the JAX package, judged by whole top-level module
names; the plain reference loads nothing of the program."""

import json
import subprocess
import sys

import pytest

from benchmark import harness as H


@pytest.mark.parametrize("name,bad", [
    ("cmrtpu_torch.train.trainer", False), ("cmrtpu_torch", False),
    ("cmrtpu", True), ("cmrtpu.ops.gaussian", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("optax", True), ("jaxtyping", False), ("optaxx", False)])
def test_top_level_names(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in H.forbidden_modules()) is bad


def _modules_after(root, code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json;"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=root, capture_output=True, text=True,
                         timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_program(root):
    mods = _modules_after(root, "import benchmark.reference.unet, "
                          "benchmark.reference.train, "
                          "benchmark.reference.serve, "
                          "benchmark.reference.augment, "
                          "benchmark.reference.files, benchmark.counts.unet")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"cmrtpu_torch", "cmrtpu", "jax", "jaxlib", "flax",
                       "optax"}


def test_a_whole_run_loads_no_jax(root):
    code = (
        "import time, torch\n"
        "from benchmark import harness as H\n"
        "run = H.run_cell('.', 'cine_3d.train', 3, 0.2, False, "
        "torch.device('cpu'), time.time(), {'DIM': [4, 32, 32], "
        "'FILTERS': 4, 'BATCHSIZE': 2}, {'patients': 2})\n"
        "assert run['steps'] >= 1\n"
        "assert H.forbidden_modules() == [], H.forbidden_modules()\n")
    mods = _modules_after(root, code)
    assert "cmrtpu_torch.train.device_cache" in mods
    assert not {m.split(".")[0] for m in mods} & set(H.FORBIDDEN)
