"""Share of the rows the serving forward ran that were a study's
slices, not padding to BATCHSIZE: the increments of the counters
``serve.rows_real`` over those of ``serve.rows_forwarded`` that
``predict_slices`` made in the measured window."""

from benchmark.spans import serve_window


def read(run):
    real = serve_window(run, "serve.rows_real")
    forwarded = serve_window(run, "serve.rows_forwarded")
    if real is None or forwarded is None or not forwarded.sum():
        return None
    return 100.0 * float(real.sum()) / float(forwarded.sum())
