"""Mean host time of a study's CC stage (the span ``serve.cc``: the
threshold and flatten, the upload, K2 and its copy back) over the
measured window, from the span store."""

from benchmark.spans import serve_ms


def read(run):
    return serve_ms(run, "serve.cc")
