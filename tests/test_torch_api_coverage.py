"""Every public name of cmrtpu has its counterpart in cmrtpu_torch.

Each module under ``cmrtpu/`` is parsed with ``ast`` (nothing is
imported), and its public top-level functions and classes, the public
methods of those classes and its public aliases (``name = other_name``)
are collected. Each must be defined in the counterpart file under
``cmrtpu_torch/`` (same path; ``Class.method`` in the same class), or
stand in one of two maps:

  * ``RENAMED``: the port's file and name(s) that do the same work, each
    of which must be defined there;
  * ``SKIPPED``: the reason the port has no counterpart, from ROADMAP's
    skip list or Queue 3.

A public name added to cmrtpu without a counterpart or an entry fails its
module's case; so does an entry that has become stale (its name gone from
cmrtpu, or defined in the port after all). One case per cmrtpu module; each
records how many of its names are defined, renamed and skipped.

The repo's scripts under ``tools/`` and ``examples/`` are walked the same
way: each one's public names must be defined in
``cmrtpu_torch/tools/<same file name>``, unless the script stands in
``SKIPPED_SCRIPTS`` with its reason."""

import ast
import pathlib
from functools import lru_cache
from typing import Dict, List, Set

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
REF = REPO / "cmrtpu"
PORT = REPO / "cmrtpu_torch"

# a cmrtpu module whose port lives in a file of another name
RENAMED_MODULES = {"ops/pallas_kernels.py": "ops/cuda_kernels.py"}

# cmrtpu "file::name" -> the port's "file::name" targets
RENAMED: Dict[str, List[str]] = {
    "models/unet.py::init_variables": ["models/unet.py::UNet.reset_parameters",
                                       "models/unet.py::init_weights_"],
    "ops/pallas_kernels.py::gaussian_blur_2d_pallas":
        ["ops/cuda_kernels.py::gaussian_blur_2d_cuda"],
    "ops/pallas_kernels.py::converge_labels_pallas":
        ["ops/cuda_kernels.py::converge_labels_cuda"],
    "parallel/prefetch.py::prefetch_to_device":
        ["parallel/prefetch.py::PutAhead"],
    "pipeline/augment.py::augment_example":
        ["pipeline/augment.py::draw_params",
         "pipeline/augment.py::apply_params"],
    "pipeline/augment.py::augment_batch_fn":
        ["pipeline/augment.py::draw_params",
         "pipeline/augment.py::apply_params"],
    "pipeline/augment.py::make_batch_augmenter":
        ["pipeline/augment.py::draw_params",
         "pipeline/augment.py::apply_params"],
    "pipeline/histmatch.py::match_histograms_jax":
        ["pipeline/histmatch.py::match_histograms_exact"],
    "pipeline/histmatch.py::match_histograms_binned_jax":
        ["pipeline/histmatch.py::match_histograms_binned"],
    "train/device_cache.py::hist_quota": ["pipeline/histmatch.py::hist_quota"],
    "train/device_cache.py::make_cache_reshuffler":
        ["train/device_cache.py::reshuffle_shards"],
    "train/device_cache.py::make_cached_train_step":
        ["train/device_cache.py::FusedStep.train_batch",
         "train/device_cache.py::DeviceCachedLoop.train_step"],
    "train/device_cache.py::make_cached_eval_step":
        ["train/device_cache.py::FusedStep.eval_batch",
         "train/device_cache.py::DeviceCachedLoop.eval_step"],
    "train/steps.py::create_train_state": ["train/steps.py::TrainState"],
    "train/steps.py::inference_params":
        ["train/steps.py::TrainState.inference_params"],
    "train/steps.py::make_train_step":
        ["train/steps.py::TrainState.train_step"],
    "train/steps.py::make_eval_step": ["train/steps.py::TrainState.eval_step"],
    "train/steps.py::make_predict_step": ["train/trainer.py::Trainer.predict"],
    "utils/profiling.py::annotate": ["utils/profiling.py::span"],
}

_TPU_PLUMBING = "TPU/XLA plumbing (ROADMAP skip list)"
# cmrtpu "file::name" or "file" -> why the port has no counterpart
SKIPPED: Dict[str, str] = {
    "parallel/mesh.py::put_global": _TPU_PLUMBING,
    "parallel/mesh.py::batch_sharding":
        f"{_TPU_PLUMBING}: a jax NamedSharding; the port's rank takes its "
        "rows with shard_batch",
    "parallel/mesh.py::replicated_sharding":
        f"{_TPU_PLUMBING}: a jax NamedSharding; every rank holds the "
        "replicated tensors",
    "utils/xla_cache.py": f"{_TPU_PLUMBING}: XLA's compilation cache",
    "ops/resample.py::resample_nd_jax":
        "jax's jit-compatible resample, called nowhere in cmrtpu; the port "
        "resamples on the host with resample_nd",
    "predict/export.py::jax_device_get":
        f"{_TPU_PLUMBING}: jax.device_get; tensors leave the card with "
        ".cpu()",
    "cli/make_dataset.py::clean_import":
        "deletes the downloaded label archives; the port downloads nothing "
        "(ROADMAP Queue 3, 'make_dataset downloads nothing')",
}


def _public(name: str) -> bool:
    return not name.startswith("_")


@lru_cache(maxsize=None)
def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(encoding="utf-8"))


def public_names(path: pathlib.Path) -> List[str]:
    """Public top-level defs and classes, the classes' public methods as
    ``Class.method``, and public aliases ``name = other``."""
    names = []
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and _public(node.name):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{sub.name}" for sub in node.body
                          if isinstance(sub, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))
                          and _public(sub.name)]
        elif isinstance(node, ast.Assign) and isinstance(node.value,
                                                         ast.Name):
            names += [t.id for t in node.targets
                      if isinstance(t, ast.Name) and _public(t.id)]
    return names


def defined_names(path: pathlib.Path) -> Set[str]:
    """Every top-level def, class and assigned name of a file, and every
    def and assigned name in its classes as ``Class.name``."""
    if not path.exists():
        return set()
    out: Set[str] = set()

    def targets(node):
        if isinstance(node, ast.Assign):
            return [t.id for t in node.targets if isinstance(t, ast.Name)]
        if isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                          ast.Name):
            return [node.target.id]
        return []

    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        out.add(f"{node.name}.{sub.name}")
                    out.update(f"{node.name}.{t}" for t in targets(sub))
        out.update(targets(node))
    return out


def _port_has(target: str) -> bool:
    file, name = target.split("::")
    return name in defined_names(PORT / file)


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_port(module, record_property):
    names = public_names(REF / module)
    port_file = PORT / RENAMED_MODULES.get(module, module)
    defined = defined_names(port_file)
    counts = {"defined": 0, "renamed": 0, "skipped": 0}
    missing = []
    for name in names:
        key = f"{module}::{name}"
        owner = f"{module}::{name.split('.')[0]}"
        if name in defined:
            assert key not in RENAMED and key not in SKIPPED, \
                f"{key} is defined in {port_file.relative_to(REPO)}: drop " \
                "its map entry"
            counts["defined"] += 1
        elif key in RENAMED:
            absent = [t for t in RENAMED[key] if not _port_has(t)]
            assert not absent, f"{key} maps to {absent}, not in the port"
            counts["renamed"] += 1
        elif module in SKIPPED or key in SKIPPED or owner in SKIPPED:
            counts["skipped"] += 1
        else:
            missing.append(name)
    assert not missing, (
        f"cmrtpu/{module}: {missing} have no counterpart in "
        f"{port_file.relative_to(REPO)} and no RENAMED or SKIPPED entry")
    # entries of this module must name what cmrtpu has
    stale = [k for k in (*RENAMED, *SKIPPED)
             if k.split("::")[0] == module and "::" in k
             and k.split("::")[1] not in names]
    assert not stale, f"map entries for names cmrtpu no longer has: {stale}"
    assert sum(counts.values()) == len(names)
    record_property("names", counts)
    print(f"cmrtpu/{module}: {counts}")


# a script of tools/ or examples/ -> why the port has no counterpart
SKIPPED_SCRIPTS: Dict[str, str] = {
    "tools/gen_parity.py":
        "writes cmrtpu's parity goldens (a maintenance tool of cmrtpu's "
        "tests)",
    "tools/gen_itk_goldens.py":
        "writes cmrtpu's ITK resampling goldens (a maintenance tool of "
        "cmrtpu's tests)",
    "tools/run_notebooks.py": "runs cmrtpu's notebooks (ROADMAP skip list)",
}

SCRIPTS = sorted(str(p.relative_to(REPO)) for d in ("tools", "examples")
                 for p in (REPO / d).glob("*.py"))


@pytest.mark.parametrize("script", SCRIPTS)
def test_every_script_has_a_port(script, record_property):
    """A script's public names defined in cmrtpu_torch/tools/ under its
    file name, or the script skipped with a reason (and then not
    ported)."""
    port_file = PORT / "tools" / pathlib.Path(script).name
    if script in SKIPPED_SCRIPTS:
        assert not port_file.exists(), \
            f"{script} is ported to {port_file.relative_to(REPO)}: drop " \
            "its SKIPPED_SCRIPTS entry"
        record_property("names", "skipped")
        return
    names = public_names(REPO / script)
    missing = [n for n in names if n not in defined_names(port_file)]
    assert not missing, (
        f"{script}: {missing} are not defined in "
        f"{port_file.relative_to(REPO)} and the script has no "
        "SKIPPED_SCRIPTS entry")
    record_property("names", len(names))


def test_maps_name_real_files():
    """Every map key names a cmrtpu module, every target a port file."""
    for key in (*RENAMED, *SKIPPED):
        assert key.split("::")[0] in MODULES, key
    for targets in RENAMED.values():
        for target in targets:
            assert (PORT / target.split("::")[0]).exists(), target
    for module, port in RENAMED_MODULES.items():
        assert module in MODULES and (PORT / port).exists()
    for script in SKIPPED_SCRIPTS:
        assert script in SCRIPTS, script
