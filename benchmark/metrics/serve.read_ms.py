"""Mean host time of a study's read (the span ``serve.read``: the
file read and decoded) over the measured window, from the program's span
store."""

from benchmark.spans import serve_ms


def read(run):
    return serve_ms(run, "serve.read")
