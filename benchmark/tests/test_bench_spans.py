"""The program's spans in a trace (``benchmark/spans.py``) on synthetic
Kineto events, the span store a run keeps, and the readers of the
per-layer metrics that read either."""

import time

import pytest
import torch

from benchmark import harness as H
from benchmark import spans as S


def rng(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur}


def launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "tid": tid, "ts": ts, "dur": 2, "args": {"correlation": corr}}


def kernel(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "tid": 7, "ts": ts,
            "dur": dur, "args": {"correlation": corr}}


EVENTS = [
    rng("bench_window", 0, 1000),
    rng("bench_window", 0, 1000, cat="gpu_user_annotation"),
    rng("train.step step=0", 10, 490),
    rng("train.forward", 20, 80),
    rng("train.backward", 150, 250),
    rng("train.optimizer", 400, 80),
    rng("Optimizer.step#Adam.step", 410, 60),
    launch(1, 30), kernel(1, 40, 30),
    launch(6, 90), kernel(6, 95, 5, cat="gpu_memcpy"),
    launch(2, 200, tid=2), kernel(2, 210, 100),  # autograd's own thread
    launch(3, 420), kernel(3, 430, 20),
    launch(4, 600), kernel(4, 610, 10),
]


def us(x):
    return round(x * 1e6, 6)


def test_device_time_goes_to_the_innermost_span_by_correlation():
    r = S.reduce(EVENTS)
    assert "bench_window" not in r
    assert {k: us(v["device_s"]) for k, v in r.items()
            if v["device_s"]} == {"train.forward": 35,
                                  "train.backward": 100,
                                  "Optimizer.step#Adam.step": 20,
                                  "no span": 10}
    total = {k: us(v["device_total_s"]) for k, v in r.items()}
    assert total["train.step"] == 155
    assert total["train.optimizer"] == total["Optimizer.step#Adam.step"] == 20
    assert r["train.step"]["count"] == 1
    assert us(r["train.step"]["host_s"]) == 490


def test_a_launch_from_another_thread_lands_in_train_backward():
    r = S.reduce(EVENTS)
    assert us(r["train.backward"]["device_s"]) == 100
    # a span on another thread is still a span, matched by time alone
    r = S.reduce(EVENTS + [rng("train.backward.inner", 190, 20, tid=2)])
    assert us(r["train.backward.inner"]["device_s"]) == 100
    assert us(r["train.backward"]["device_s"]) == 0


def test_idle_time_split_between_spans_and_no_span():
    r = S.reduce(EVENTS)
    idle = {k: us(v["idle_s"]) for k, v in r.items() if v["idle_s"]}
    # busy [40, 70] [95, 100] [210, 310] [430, 450] [610, 620]
    assert idle == {"no span": 10 + 110 + 380, "train.step": 10 + 50 + 20,
                    "train.forward": 20 + 25, "train.backward": 60 + 90,
                    "train.optimizer": 10 + 10,
                    "Optimizer.step#Adam.step": 20 + 20}
    busy = sum(v["device_s"] for v in r.values())
    assert us(sum(v["idle_s"] for v in r.values()) + busy) == 1000


def test_a_trace_without_spans_gives_no_span_alone():
    r = S.reduce([e for e in EVENTS if e["cat"] != "user_annotation"
                  or e["name"] == "bench_window"])
    assert set(r) == {"no span"}
    assert us(r["no span"]["idle_s"] + r["no span"]["device_s"]) == 1000
    with pytest.raises(RuntimeError, match="bench_window"):
        S.reduce(EVENTS[2:])


def _serve_timer(monkeypatch, warm=(8, 12), win=(10, 9, 11, 10),
                 traced=(12, 8), batch=16):
    """A fresh store holding a serving run's spans and counters: warm-up
    studies, the window's and the traced ones, each of ``z`` slices; the
    window's read takes 10 ms a study, a slice's resample 2 ms."""
    from cmrtpu_torch.utils import profiling as P

    timer = P.StageTimer()
    monkeypatch.setattr(P, "GLOBAL_TIMER", timer)
    records = []
    for part, zs in (("warm", warm), ("win", win), ("traced", traced)):
        scale = 1.0 if part == "win" else 7.0
        for z in zs:
            timer.add("serve.read", 0.01 * scale)
            for _ in range(z):
                timer.add("serve.resample", 0.002 * scale)
                timer.add("serve.normalise", 0.0015 * scale)
            timer.count("serve.rows_real", z)
            timer.count("serve.rows_forwarded", -(-z // batch) * batch)
            for k, t in (("cc", 0.005), ("undo", 0.003), ("write", 0.002)):
                timer.add(f"serve.{k}", t * scale)
            total = 0.1 * scale + 1e-4 * z
            timer.add("serve.study", total)
            if part == "win":
                records.append({"total_s": round(total, 4)})
    return {"failed": 0, "records": records, "slices": list(win),
            "traced_k2_calls": [{"planes": 2 * z} for z in traced]}


def _train_timer(monkeypatch, warm=6, win=10, traced=3):
    from cmrtpu_torch.utils import profiling as P

    timer = P.StageTimer()
    monkeypatch.setattr(P, "GLOBAL_TIMER", timer)
    for n, t in ((warm, 0.2), (win, 0.05), (traced, 0.3)):
        for _ in range(n):
            timer.add("train.step", t)
    return {"steps": win, "trace": {"steps": traced}}


@pytest.mark.parametrize("metric,want", [
    ("serve.read_ms", 10.0), ("serve.resample_ms", 20.0),
    ("serve.normalise_ms", 15.0), ("serve.cc_ms", 5.0),
    ("serve.undo_ms", 3.0), ("serve.write_ms", 2.0),
    ("serve.forward_row_use_pct", 62.5), ("train.enqueue_ms", 50.0)])
def test_metric_reads_a_synthetic_run_and_none_without_data(
        monkeypatch, metric, want):
    from cmrtpu_torch.utils import profiling as P

    read = H.metric_reader(metric)
    serve = metric.startswith("serve")
    run = _serve_timer(monkeypatch) if serve else _train_timer(monkeypatch)
    assert read(run) == pytest.approx(want)
    assert read({}) is None
    if serve:  # a store out of step with the records, or a failed study
        assert read(dict(run, failed=1)) is None
        assert read(dict(run, traced_k2_calls=[])) is None
    else:
        assert read(dict(run, steps=run["steps"] + 10)) is None

    class Old:  # the parent's program: a store that keeps no history
        def summary(self):
            return {}

    monkeypatch.setattr(P, "GLOBAL_TIMER", Old())
    assert read(run) is None


def test_window_takes_the_values_before_the_traced_ones(monkeypatch):
    from cmrtpu_torch.utils import profiling as P

    timer = P.StageTimer(history=8)
    monkeypatch.setattr(P, "GLOBAL_TIMER", timer)
    for v in range(12):
        timer.add("s", float(v))
    assert S.window("s", 3, 2).tolist() == [7.0, 8.0, 9.0]
    assert S.window("s", 6, 2).tolist() == [4.0, 5.0, 6.0, 7.0, 8.0, 9.0]
    assert S.window("s", 7, 2) is None  # more than the store keeps
    assert S.window("s", 0, 2) is None
    assert S.window("other", 1, 0) is None


@pytest.mark.parametrize("cell,small,stages,metrics", [
    ("cine_3d.train",
     ({"DIM": [4, 32, 32], "FILTERS": 4, "BATCHSIZE": 2,
       "MIXED_PRECISION": False}, {"patients": 2}),
     {"train.step", "train.gather", "train.augment", "train.finalize",
      "train.forward", "train.loss", "train.backward", "train.optimizer",
      "train.logs"}, {"train.enqueue_ms"}),
    ("flagship_2d.serve",
     ({"DIM": [32, 32], "FILTERS": 4, "MIXED_PRECISION": False},
      {"studies": 4, "matrix": [30, 40], "field_mm": 38.4, "sample": 4,
       "head_bias_prob": [0.5, 1e-9]}),
     {"serve.study", "serve.read", "serve.preprocess", "serve.resample",
      "serve.normalise", "serve.forward", "serve.cc", "serve.undo",
      "serve.write"},
     {"serve.read_ms", "serve.resample_ms", "serve.normalise_ms",
      "serve.cc_ms", "serve.undo_ms", "serve.write_ms",
      "serve.forward_row_use_pct"})])
def test_a_run_reads_the_window_from_the_store(root, cell, small, stages,
                                               metrics):
    """A whole run on the CPU at a small size, after the store has been
    filled beforehand: the store's metrics read the window alone."""
    from cmrtpu_torch.utils.profiling import GLOBAL_TIMER

    for name in stages:
        GLOBAL_TIMER.add(name, 100.0)  # what earlier work left behind
    run = H.run_cell(root, cell, 2 ** 31 + 5, 0.3, False,
                     torch.device("cpu"), time.time(), *small)
    assert stages <= set(GLOBAL_TIMER.summary())
    read = H.read_metrics(H.benchmark_spec(root), cell, run, True)
    assert metrics <= set(read)
    got = {m: read[m]["value"] for m in metrics}
    if "train" in cell:
        assert 0 < got["train.enqueue_ms"] \
            <= 1e3 * run["window_s"] / run["steps"]
        return
    recs = run["records"]
    host = 1e3 * sum(r["read_s"] + r["preprocess_s"] for r in recs) \
        / len(recs)
    parts = sum(got[f"serve.{k}_ms"] for k in ("read", "resample",
                                               "normalise"))
    assert 0 < parts <= host + 0.1  # the records round to 0.1 ms
    batch = H.context(root, cell, 1, 0.1, False, "cpu", 0.0,
                      small[0]).config["BATCHSIZE"]
    z = run["slices"]
    assert got["serve.forward_row_use_pct"] == pytest.approx(
        100 * sum(z) / sum(-(-n // batch) * batch for n in z))
