"""Mean host time of a study's undo steps (the span ``serve.undo``: the
label map cropped, padded and resampled back to the study's grid) over
the measured window, from the span store."""

from benchmark.spans import serve_ms


def read(run):
    return serve_ms(run, "serve.undo")
