"""A configuration, a traffic mix, a cell and a metric added as new files
and entries, with no file of the benchmark edited, are found by name and
run."""

import json
import os
import shutil
import subprocess
import sys

NEW_METRIC = '''"""Steps a second of the window (a test's metric)."""


def read(run):
    return run["steps"] / run["window_s"] if "steps" in run else None
'''


def test_new_files_are_found_by_name(root, tmp_path):
    shutil.copytree(os.path.join(root, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: (tmp_path / "benchmark" / p).read_bytes()
              for p in ("harness.py", "drivers/train.py", "run.py")}
    spec = json.loads(open(os.path.join(root, "BENCHMARK.json")).read())
    cfg = json.loads(open(os.path.join(
        root, "benchmark", "configs", "flagship_2d.json")).read())
    cfg["config"].update(DIM=[32, 32], FILTERS=4, BATCHSIZE=4)
    (tmp_path / "benchmark" / "configs" / "tiny_2d.json").write_text(
        json.dumps(cfg))
    (tmp_path / "benchmark" / "traffic" / "two_patients.json").write_text(
        json.dumps({"driver": "train", "generator": "slices",
                    "patients": 2, "slices": [3, 4],
                    "frame_scales": [1.0, 0.72]}))
    (tmp_path / "benchmark" / "metrics" / "train.steps_per_s.py"
     ).write_text(NEW_METRIC)
    spec["configs"].append(dict(spec["configs"][0], name="tiny_2d",
                                file="benchmark/configs/tiny_2d.json"))
    spec["workloads"].append({"name": "tiny_2d.train", "config": "tiny_2d",
                              "traffic": "two_patients", "chips": 1,
                              "why": "a test's cell"})
    spec["end_to_end"].append({"name": "train.steps_per_s", "unit": "1/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["tiny_2d.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import json, time, torch\n"
        "from benchmark import harness as H\n"
        "assert H.HERE.startswith(%r)\n"
        "run = H.run_cell('.', 'tiny_2d.train', 5, 0.2, False, "
        "torch.device('cpu'), time.time())\n"
        "spec = H.benchmark_spec('.')\n"
        "print(json.dumps(H.read_metrics(spec, 'tiny_2d.train', run, "
        "False)))\n" % str(tmp_path))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), root]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["train.steps_per_s"]["value"] > 0
    # the metrics without a workloads list, and the one that lists it
    assert set(metrics) == {"peak_mem_gib", "setup_s", "train.steps_per_s"}
    for p, blob in before.items():
        assert (tmp_path / "benchmark" / p).read_bytes() == blob
