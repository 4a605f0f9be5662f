"""Mean host time a study in its slices' linear resample to the target
spacing (the per-slice span ``serve.resample`` inside
``serve.preprocess``) over the measured window, from the span store."""

from benchmark.spans import serve_ms


def read(run):
    return serve_ms(run, "serve.resample", per_slice=True)
