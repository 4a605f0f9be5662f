"""The reduction of a profiler trace: busy time as the union of device
intervals inside the window, idle gaps named by the innermost host op
running at their start, and kernel time by symbol."""

import pytest

from benchmark import trace as T

EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "bench_window",
     "ts": 0, "dur": 100},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "bench_window",
     "ts": 5, "dur": 200},
    {"ph": "X", "cat": "kernel", "ts": 10, "dur": 20,
     "name": "void (anonymous namespace)::gaussian_blur_kernel<8>(float "
             "const*, float*, int)"},
    {"ph": "X", "cat": "kernel", "ts": 25, "dur": 10,
     "name": "(anonymous namespace)::cc_local_kernel(unsigned char const*)"},
    {"ph": "X", "cat": "gpu_memcpy", "ts": 60, "dur": 10,
     "name": "Memcpy DtoH"},
    {"ph": "X", "cat": "kernel", "ts": 95, "dur": 20, "name": "tail"},
    {"ph": "X", "cat": "cpu_op", "ts": 30, "dur": 40, "name": "aten::outer"},
    {"ph": "X", "cat": "cpu_op", "ts": 34, "dur": 10, "name": "aten::inner"},
]


def test_reduce():
    r = T.reduce(EVENTS)
    assert r["window_s"] == pytest.approx(100e-6)
    # [10, 35] + [60, 70] + [95, 100] (the tail clipped to the window)
    assert r["busy_s"] == pytest.approx(40e-6)
    # gaps [35, 60], [70, 95], [0, 10], longest first; [35, 60] starts
    # inside aten::inner within aten::outer, [70, 95] at outer's end
    assert [[n, round(s * 1e6, 6)] for n, s in r["breakdown"]["idle_gaps"]
            ] == [["aten::inner", 25], ["aten::outer", 25],
                  ["no host op", 10]]


def test_kernel_time_by_symbol():
    r = T.reduce(EVENTS)
    assert T.kernel_time(r, ("gaussian_blur_kernel",)) == (1, pytest.approx(
        20e-6))
    assert T.kernel_time(r, ("cc_local_kernel", "cc_merge_kernel"))[0] == 1
    assert T.symbol("void at::native::vectorized_elementwise_kernel<4>(int)"
                    ) == "vectorized_elementwise_kernel"
