"""cmrtpu_torch's stage timer, trace and ranges
(``cmrtpu_torch/utils/profiling.py``) against cmrtpu's
(``cmrtpu/utils/profiling.py``) on the CPU.

* ``StageTimer``: counts, totals, means, maxima and reset as
  tests/test_profiling.py holds cmrtpu's; 8 threads report 400 stages.
* The generator's ``generator/fix_preprocess`` and ``generator/batch``
  stages: on the same files and calls (in memory and from disk, with
  HIST_MATCHING, ``raw_batch`` and ``fixed_rows``) the port's
  ``GLOBAL_TIMER`` counts what cmrtpu's counts.
* ``annotate`` lets an exception of its body through unchanged; cmrtpu's
  turns it into ``RuntimeError("generator didn't stop after throw()")``
  (ROADMAP Queue 3).
* ``trace`` on the CPU writes a Chrome trace that names the annotated
  ranges.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from cmrtpu.io import MedicalImage, write_image
from cmrtpu.pipeline.generator import DataGenerator as JaxGenerator
from cmrtpu.utils import profiling as JP
from cmrtpu_torch.pipeline.generator import DataGenerator
from cmrtpu_torch.utils import profiling as P

torch.set_num_threads(1)


def test_stage_timer_counts_and_means():
    t = P.StageTimer()
    for _ in range(3):
        with t.stage("work"):
            time.sleep(0.01)
    s = t.summary()["work"]
    assert set(s) == set(JP.StageTimer().summary().get("work", s))
    assert s["count"] == 3
    assert s["total_s"] >= 0.03
    assert s["mean_s"] == pytest.approx(s["total_s"] / 3)
    assert 0.01 <= s["max_s"] <= s["total_s"]
    t.reset()
    assert t.summary() == {}


def test_stage_timer_keys_match_cmrtpu():
    mine, ref = P.StageTimer(), JP.StageTimer()
    for timer in (mine, ref):
        with timer.stage("a"):
            pass
    assert set(mine.summary()["a"]) == set(ref.summary()["a"]) == {
        "count", "total_s", "max_s", "mean_s"}


def test_stage_timer_thread_safety():
    t = P.StageTimer()

    def worker():
        for _ in range(50):
            with t.stage("x"):
                pass

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert t.summary()["x"]["count"] == 400


def test_stage_records_a_failing_body():
    t = P.StageTimer()
    with pytest.raises(KeyError):
        with t.stage("bad"):
            raise KeyError("x")
    assert t.summary()["bad"]["count"] == 1


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("slices")
    rng = np.random.default_rng(42)
    xs, ys = [], []
    for i in range(8):
        img = rng.normal(size=(26, 22)).astype(np.float32)
        msk = np.zeros((26, 22), np.uint8)
        msk[8:11, 6:9] = 1
        msk[14:17, 10:13] = 2
        xp = str(root / f"patient{i:03d}__t01_z0_img.nrrd")
        yp = str(root / f"patient{i:03d}__t01_z0_msk.nrrd")
        write_image(MedicalImage(array=img, spacing=(1.4, 1.4)), xp)
        write_image(MedicalImage(array=msk, spacing=(1.4, 1.4)), yp)
        xs.append(xp)
        ys.append(yp)
    return xs, ys


def _drive(gen_cls, timer, xs, ys, in_memory, **kwargs):
    cfg = {"DIM": [24, 24], "BATCHSIZE": 4, "MASK_VALUES": [1, 2],
           "SEED": 1, "AUGMENT": True, "AUGMENT_PROB": 0.0,
           "HIST_MATCHING": True, "STREAM_DTYPE": "float32"}
    timer.reset()
    gen = gen_cls(xs, ys, config=cfg, in_memory=in_memory, **kwargs)
    for _ in range(4):  # 8 batches x 4 examples at a 0.1 matching rate
        for i in range(len(gen)):
            gen[i]
        gen.on_epoch_end()
    gen.raw_batch(0)
    gen.fixed_rows([0, 3])
    return {k: v["count"] for k, v in timer.summary().items()}


@pytest.mark.parametrize("in_memory", [True, False], ids=["memory", "disk"])
def test_generator_stage_counts_match_cmrtpu(files, in_memory):
    xs, ys = files
    ref = _drive(JaxGenerator, JP.GLOBAL_TIMER, xs, ys, in_memory)
    got = _drive(DataGenerator, P.GLOBAL_TIMER, xs, ys, in_memory,
                 device="cpu")
    assert set(got) == {"generator/fix_preprocess", "generator/batch"}
    assert got == ref
    assert got["generator/batch"] == 4 * 2


def test_annotate_lets_the_body_error_through():
    with pytest.raises(ValueError, match="body"):
        with P.annotate("x"):
            raise ValueError("body")
    # cmrtpu's annotate yields again from its except clause, so the body's
    # error becomes a RuntimeError and is lost (a defect the port fixes)
    with pytest.raises(RuntimeError, match="didn't stop after throw"):
        with JP.annotate("x"):
            raise ValueError("body")


def test_annotate_without_a_trace_is_a_plain_block():
    with P.annotate("anything"):
        y = torch.ones(3) + 1
    assert y.sum().item() == 6.0


def test_trace_names_the_annotated_ranges(tmp_path):
    log_dir = str(tmp_path / "trace")
    with P.trace(log_dir):
        for _ in range(3):
            with P.annotate("train_step"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    path = os.path.join(log_dir, "trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("train_step") == 3
    assert any("mm" in str(n) for n in names)


def test_trace_disabled_writes_nothing(tmp_path):
    with P.trace(str(tmp_path / "off"), enabled=False):
        torch.ones(2) + 1
    assert not os.path.exists(tmp_path / "off")
