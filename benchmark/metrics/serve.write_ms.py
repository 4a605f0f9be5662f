"""Mean host time of a study's nrrd write (the span ``serve.write``)
over the measured window, from the span store."""

from benchmark.spans import serve_ms


def read(run):
    return serve_ms(run, "serve.write")
