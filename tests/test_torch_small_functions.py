"""``cache_nbytes`` and ``show_available_devices`` against cmrtpu's.

``show_available_devices`` is held on the CPU (one line that says so) and
on a card stubbed through ``torch.cuda``: one line per device in the form
of cmrtpu's ``device <id>: <kind>, hbm <in use>/<total>``."""

import logging

import numpy as np
import pytest
import torch

from cmrtpu.train.device_cache import cache_nbytes as jax_cache_nbytes
from cmrtpu_torch.train.device_cache import cache_nbytes
from cmrtpu_torch.utils.io_utils import show_available_devices

torch.set_num_threads(1)


@pytest.mark.parametrize("dtypes", [("float32",), ("float32", "uint8"),
                                    ("float16", "float64", "int32")])
def test_cache_nbytes_matches_cmrtpu(dtypes):
    arrays = [np.zeros((3, 5, 7 + i), d) for i, d in enumerate(dtypes)]
    assert cache_nbytes(*arrays) == jax_cache_nbytes(*arrays)
    assert cache_nbytes(*map(torch.from_numpy, arrays)) \
        == jax_cache_nbytes(*arrays)
    assert cache_nbytes() == jax_cache_nbytes() == 0


def test_show_available_devices_on_the_cpu(caplog, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with caplog.at_level(logging.INFO):
        devices = show_available_devices()
    assert devices == [torch.device("cpu")]
    lines = [r.getMessage() for r in caplog.records]
    assert lines == ["device cpu: no CUDA device, running on the CPU"]


def test_show_available_devices_lists_each_card(caplog, monkeypatch):
    gib = 1 << 30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: f"Card {i}")
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: ((70 - i) * gib, 80 * gib))
    with caplog.at_level(logging.INFO):
        devices = show_available_devices()
    assert devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert [r.getMessage() for r in caplog.records] == [
        f"device 0: Card 0, hbm {10 * gib}/{80 * gib}",
        f"device 1: Card 1, hbm {11 * gib}/{80 * gib}"]
