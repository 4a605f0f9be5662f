"""The control, the reference in the next lower precision (the cell's
limits file names it: int8 or float8 e4m3 for the configurations'
bfloat16) standing in for the program, fails the correctness check of
each cell at the cell's own size, on the card: at least one number that
the cell's limits name reads above its limit."""

import shutil
import time

import pytest

from benchmark import harness as H


@pytest.mark.card
@pytest.mark.parametrize("cell", ["flagship_2d.serve", "cine_3d.train"])
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_control_is_not_correct(root, card, cell, seed):
    ctx = H.context(root, cell, seed, 0, False, card, time.time())
    assert ctx.limits, f"no limits for {cell}"
    try:
        numbers = H.driver(ctx.traffic["driver"]).control(ctx)
    finally:
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    checks = H.checks_from(numbers, ctx.limits)
    assert not H.passes(checks), numbers
    assert any(c.value > c.limit for c in checks), numbers


def test_only_the_limited_numbers_are_judged():
    """A number the limits leave out neither fails nor passes a run; a
    number they name that the run lacks fails it."""
    limits = {"a": 0.1}
    assert H.passes(H.checks_from({"a": 0.05, "b": 9.0}, limits))
    assert not H.passes(H.checks_from({"a": 0.2, "b": 0.0}, limits))
    assert not H.passes(H.checks_from({"b": 0.0}, limits))
    assert not H.passes(H.checks_from({"a": 0.0}, {}))


def test_int8_control_keeps_255_levels_and_the_largest_entry():
    import torch

    from benchmark.reference.unet import _round

    t = torch.randn(1000, dtype=torch.float32) * 3.0
    q = _round(t, torch.int8)
    step = t.abs().max() / 127.0
    assert len(torch.unique(q)) <= 255
    assert torch.allclose(q.abs().max(), t.abs().max())
    assert (q - t).abs().max() <= step / 2 + 1e-6
