"""cmrtpu_torch's host prefetch against cmrtpu's on the CPU.

* ``numpy_prefetch``: the counterparts of tests/test_prefetch.py's cases
  (order and content, depth 0, the producer's exception in the consumer, a
  consumer that leaves early stops the producer, the sentinel delivered
  with the queue full), each also against cmrtpu's ``numpy_prefetch`` on
  the same items, and a stress run of many pipelines at once.
* ``PutAhead`` on the CPU: staged batches equal their host tensors and are
  copies (a later write to the source or to the ring does not reach them),
  the ring keeps depth + 2 slots per tensor and reallocates a slot whose
  shapes change.

Every consumer runs in a thread joined with a timeout, so a lost sentinel
fails the test instead of hanging the run.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from cmrtpu.parallel.prefetch import numpy_prefetch as jax_numpy_prefetch
from cmrtpu_torch.parallel.prefetch import PutAhead, numpy_prefetch

torch.set_num_threads(1)


def _bounded(fn, timeout=20.0):
    """fn() in a thread joined with a timeout; its result, or its error."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(timeout)
    assert not thread.is_alive(), "the consumer did not finish in time"
    if "error" in out:
        raise out["error"]
    return out["value"]


@pytest.mark.parametrize("items,depth", [(list(range(7)), 2), ([], 2),
                                         ([0, 1, 2], 0), (list(range(9)), 1)],
                         ids=["depth2", "empty", "depth0", "depth1"])
def test_order_and_content_match_cmrtpu(items, depth):
    got = _bounded(lambda: list(numpy_prefetch(iter(items), depth=depth)))
    want = _bounded(lambda: list(jax_numpy_prefetch(iter(items),
                                                    depth=depth)))
    assert got == want == items


@pytest.mark.parametrize("impl", [numpy_prefetch, jax_numpy_prefetch],
                         ids=["port", "cmrtpu"])
def test_producer_exception_reaches_the_consumer(impl):
    def bad():
        yield 1
        yield 2
        raise RuntimeError("decode failed")

    got = []

    def consume():
        for item in impl(bad(), depth=2):
            got.append(item)

    with pytest.raises(RuntimeError, match="decode failed"):
        _bounded(consume)
    assert got == [1, 2]


def test_consumer_early_exit_stops_the_producer():
    produced = []

    def slow():
        for i in range(100):
            produced.append(i)
            time.sleep(0.001)
            yield i

    def consume():
        it = numpy_prefetch(slow(), depth=2)
        for item in it:
            if item == 3:
                break
        it.close()

    _bounded(consume)
    time.sleep(0.3)
    # bounded by the queue's depth past the consumer's last item
    assert len(produced) < 10, f"the producer ran on: {len(produced)} items"


def test_sentinel_delivered_with_the_queue_full():
    def consume():
        out = []
        for item in numpy_prefetch(iter(range(5)), depth=2):
            time.sleep(0.05)  # the producer finishes with the queue full
            out.append(item)
        return out

    assert _bounded(consume) == [0, 1, 2, 3, 4]


def test_many_pipelines_at_once_keep_order():
    """More pipelines than cores, with a short switch interval: every
    consumer sees its own items, all of them, in order."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results = {}

        def consume(k):
            results[k] = list(numpy_prefetch(
                iter(range(k * 1000, k * 1000 + 200)), depth=1 + k % 3))

        threads = [threading.Thread(target=consume, args=(k,), daemon=True)
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert results == {k: list(range(k * 1000, k * 1000 + 200))
                       for k in range(16)}


def test_put_ahead_on_the_cpu_stages_copies():
    put = PutAhead(torch.device("cpu"), depth=2)
    rng = np.random.default_rng(0)
    staged, sources = [], []
    for i in range(9):
        x = torch.from_numpy(rng.random((4, 8, 8)).astype(np.float32)).to(
            torch.bfloat16)
        y = torch.from_numpy(rng.integers(0, 3, (4, 8, 8)).astype(np.uint8))
        sources.append((x.clone(), y.clone()))
        staged.append(put.put([x, y]))
        x.zero_()  # a later write to the source does not reach the batch
    # 9 puts through a ring of 4 slots: every slot was reused, and no batch
    # was overwritten by a later one
    for (x, y), batch in zip(sources, staged):
        got_x, got_y = put.take(batch)
        assert got_x.dtype == torch.bfloat16 and got_y.dtype == torch.uint8
        assert torch.equal(got_x, x) and torch.equal(got_y, y)
    assert len(put.host_buffers()) == 2 * 4
    assert put.stream is None and staged[0].done is None

    # a slot whose shapes change is reallocated
    put.put([torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.uint8)])
    shapes = sorted(tuple(b.shape) for b in put.host_buffers())
    assert shapes.count((2, 3)) == 2 and shapes.count((4, 8, 8)) == 6
