"""Mean host time a study in its slices' quantile clip, normalise,
pad/crop and second normalise (the per-slice span ``serve.normalise``
inside ``serve.preprocess``) over the measured window, from the span
store."""

from benchmark.spans import serve_ms


def read(run):
    return serve_ms(run, "serve.normalise", per_slice=True)
