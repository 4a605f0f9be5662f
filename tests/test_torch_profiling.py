"""cmrtpu_torch's stage timer, trace and ranges
(``cmrtpu_torch/utils/profiling.py``) against cmrtpu's
(``cmrtpu/utils/profiling.py``) on the CPU.

* ``StageTimer``: counts, totals, means, maxima and reset as
  tests/test_profiling.py holds cmrtpu's; 8 threads report 400 stages.
* The generator's ``generator/fix_preprocess`` and ``generator/batch``
  stages: on the same files and calls (in memory and from disk, with
  HIST_MATCHING, ``raw_batch`` and ``fixed_rows``) the port's
  ``GLOBAL_TIMER`` counts what cmrtpu's counts.
* ``span`` (the port's counterpart of cmrtpu's ``annotate``) lets an
  exception of its body through unchanged; cmrtpu's ``annotate`` turns it
  into ``RuntimeError("generator didn't stop after throw()")`` (ROADMAP
  Queue 3). With no profiler running it opens no ``record_function``
  range and still times its body into ``GLOBAL_TIMER``; counters add up
  beside the stages and leave ``summary()``'s keys as cmrtpu's.
* ``trace`` on the CPU writes a Chrome trace in which nested spans are
  nested ``user_annotation`` ranges, their args in the range's name.
* The hot paths' spans: one ``process_study`` gives one of each serving
  span, the per-slice spans once a slice, the row counters, and a record
  whose times are the spans'; one ``FusedStep.train_batch`` gives each
  training span once, inside ``train.step``.
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


def test_span_lets_the_body_error_through():
    P.GLOBAL_TIMER.reset()
    with pytest.raises(ValueError, match="body"):
        with P.span("x"):
            raise ValueError("body")
    assert P.GLOBAL_TIMER.summary()["x"]["count"] == 1
    # cmrtpu's annotate yields again from its except clause, so the body's
    # error becomes a RuntimeError and is lost (a defect the port fixes)
    with pytest.raises(RuntimeError, match="didn't stop after throw"):
        with JP.annotate("x"):
            raise ValueError("body")


def test_span_without_a_profiler_opens_no_range(monkeypatch):
    def no_range(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    P.GLOBAL_TIMER.reset()
    assert not torch.autograd._profiler_enabled()
    with P.span("serve.read", stem="s0") as s:
        y = torch.ones(3) + 1
    assert y.sum().item() == 6.0
    stage = P.GLOBAL_TIMER.summary()["serve.read"]
    assert stage["count"] == 1
    assert stage["total_s"] == s.seconds == s.t1 - s.t0 > 0


def test_counters_add_up_beside_the_stages():
    t = P.StageTimer()
    t.count("rows")
    t.count("rows", 15)
    t.count("real", 5)
    with t.stage("a"):
        pass
    assert t.counts() == {"rows": 16, "real": 5}
    assert set(t.summary()) == {"a"}
    assert set(t.summary()["a"]) == set(JP.StageTimer().summary().get(
        "a", {"count": 0, "total_s": 0, "max_s": 0, "mean_s": 0}))
    t.reset()
    assert t.counts() == {} and t.summary() == {}


def test_recent_keeps_each_names_latest_values_in_order():
    t = P.StageTimer(history=4)
    for v in range(6):
        t.add("a", float(v))
    t.count("rows", 16)
    t.count("rows", 3)
    with P.span("b"):
        pass
    assert t.recent("a").tolist() == [2.0, 3.0, 4.0, 5.0]
    assert t.recent("rows").tolist() == [16.0, 3.0]
    assert t.recent("none").tolist() == []
    assert t.summary()["a"]["count"] == 6  # the stats keep every value
    assert len(P.GLOBAL_TIMER.recent("b")) >= 1
    assert P.GLOBAL_TIMER.recent("b")[-1] >= 0
    t.reset()
    assert t.recent("a").tolist() == []


def _ranges(log_dir):
    with open(os.path.join(log_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def _inside(child, parent):
    return parent["ts"] <= child["ts"] and \
        child["ts"] + child["dur"] <= parent["ts"] + parent["dur"]


def test_trace_names_the_annotated_ranges(tmp_path):
    log_dir = str(tmp_path / "trace")
    P.GLOBAL_TIMER.reset()
    with P.trace(log_dir):
        for k in range(3):
            with P.span("train.step", step=k):
                with P.span("train.forward"):
                    torch.ones(8, 8) @ torch.ones(8, 8)
    ranges = _ranges(log_dir)
    steps = [e for e in ranges if e["name"].startswith("train.step")]
    assert [e["name"] for e in steps] == [f"train.step step={k}"
                                          for k in range(3)]
    forwards = [e for e in ranges if e["name"] == "train.forward"]
    assert len(forwards) == 3
    for step, fwd in zip(steps, forwards):
        assert _inside(fwd, step)
    with open(os.path.join(log_dir, "trace.json")) as fh:
        names = [e.get("name") for e in json.load(fh)["traceEvents"]]
    assert any("mm" in str(n) for n in names)
    assert P.GLOBAL_TIMER.summary()["train.step"]["count"] == 3


SERVE_CFG = {"DIM": [32, 32], "DEPTH": 2, "FILTERS": 4, "MASK_CLASSES": 2,
             "MASK_VALUES": [1, 2], "BATCHSIZE": 16,
             "MIXED_PRECISION": False, "SPACING": [1.0, 1.0],
             "RESAMPLE": True, "SCALER": "MinMax", "GROUP_NORM": 4,
             "CC_FILTER": True, "SEED": 11}
SERVE_SPANS = ("serve.study", "serve.read", "serve.preprocess",
               "serve.forward", "serve.cc", "serve.undo", "serve.write")


def test_process_study_spans_and_record(tmp_path):
    from cmrtpu_torch.io import MedicalImage as TM, write_image as tw
    from cmrtpu_torch.models.hybrids import get_model
    from cmrtpu_torch.predict.serving import ServingEngine
    from cmrtpu_torch.train.checkpoint import save_weights

    torch.manual_seed(0)
    save_weights(str(tmp_path / "model"), get_model(SERVE_CFG))
    z = 5
    rng = np.random.default_rng(3)
    study = str(tmp_path / "s0.nrrd")
    tw(TM(array=rng.normal(size=(z, 24, 28)).astype(np.float32),
          spacing=(1.5, 1.5, 8.0), origin=(3.0, -2.0, 10.0)), study)
    engine = ServingEngine(config=SERVE_CFG, model_path=str(tmp_path /
                                                             "model"),
                           device="cpu")
    P.GLOBAL_TIMER.reset()
    rec = engine.process_study(study, str(tmp_path))
    stages, counts = P.GLOBAL_TIMER.summary(), P.GLOBAL_TIMER.counts()
    assert {k: stages[k]["count"] for k in stages} == dict(
        {k: 1 for k in SERVE_SPANS}, **{"serve.resample": 1,
                                        "serve.normalise": 1})
    assert counts == {"serve.rows_real": z, "serve.rows_forwarded": 16,
                      "serve.rows_preprocessed_device": 0}
    total = {k: v["total_s"] for k, v in stages.items()}
    assert rec["read_s"] == round(total["serve.read"], 4)
    assert rec["preprocess_s"] == round(total["serve.preprocess"], 4)
    assert rec["forward_s"] == round(total["serve.forward"], 4)
    assert rec["post_write_s"] == round(
        total["serve.cc"] + total["serve.undo"] + total["serve.write"], 4)
    assert rec["total_s"] == round(total["serve.study"], 4)
    assert total["serve.resample"] + total["serve.normalise"] \
        <= total["serve.preprocess"]
    assert rec["outputs"] == ["s0_msk_pred.nrrd"]


TRAIN_CFG = {"EXPERIMENT": "spans", "DIM": [32, 32], "DEPTH": 2,
             "FILTERS": 4, "MASK_CLASSES": 2, "MASK_VALUES": [1, 2],
             "GROUP_NORM": 4, "MIXED_PRECISION": False, "DROPOUT_MIN": 0.0,
             "DROPOUT_MAX": 0.0, "AUGMENT": False, "GAUS": True,
             "SIGMA": 1, "SPACING": [1.0, 1.0], "BATCHSIZE": 4, "SEED": 7,
             "LOSS_FUNCTION": "BcdDiceLoss"}
TRAIN_SPANS = ("train.step", "train.gather", "train.augment",
               "train.finalize", "train.forward", "train.loss",
               "train.backward", "train.optimizer", "train.logs")


@pytest.mark.parametrize("extra,more", [
    ({}, ()),
    ({"AUGMENT": True, "HIST_MATCHING": True, "HIST_MATCHING_PROB": 1.0,
      "EMA": True}, ("train.hist_match", "train.ema"))],
    ids=["plain", "hist_match_ema"])
def test_train_batch_spans_nest_in_the_step(tmp_path, extra, more):
    from types import SimpleNamespace

    from cmrtpu_torch.train.device_cache import DeviceCachedLoop
    from cmrtpu_torch.train.trainer import Trainer

    cfg = dict(TRAIN_CFG, **extra)
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(8, 32, 32)).astype(np.float32)
    ys = np.zeros((8, 32, 32), np.float32)
    ys[:, 8:10, 8:10], ys[:, 20:22, 14:16] = 1, 2
    trainer = Trainer(cfg, device="cpu")
    loop = DeviceCachedLoop(trainer, SimpleNamespace(
        _cache_x=xs, _cache_y=ys, masks=True))
    loop.train_step(torch.arange(4))
    P.GLOBAL_TIMER.reset()
    log_dir = str(tmp_path / "trace")
    with P.trace(log_dir):
        loop.train_step(torch.arange(4, 8))
    want = set(TRAIN_SPANS) | set(more)
    stages = P.GLOBAL_TIMER.summary()
    assert {k: v["count"] for k, v in stages.items()} == {k: 1 for k in want}
    # torch's optimizer annotates its own step and zero_grad
    ranges = {e["name"]: e for e in _ranges(log_dir)
              if not e["name"].startswith("Optimizer.")}
    assert set(ranges) == (want - {"train.step"}) | {"train.step step=1"}
    root = ranges.pop("train.step step=1")
    for e in _ranges(log_dir):
        assert e is root or _inside(e, root), e["name"]


def test_trace_disabled_writes_nothing(tmp_path):
    with P.trace(str(tmp_path / "off"), enabled=False):
        torch.ones(2) + 1
    assert not os.path.exists(tmp_path / "off")
