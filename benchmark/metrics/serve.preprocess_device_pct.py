"""Share of a study's slices that serving preprocessed on a CUDA device:
the increments of the counter ``serve.rows_preprocessed_device`` that
``process_study`` made in the measured window over those of
``serve.rows_real``, in %. A program without the counter gives None."""

from benchmark.spans import serve_window


def read(run):
    device = serve_window(run, "serve.rows_preprocessed_device")
    real = serve_window(run, "serve.rows_real")
    if device is None or real is None or not real.sum():
        return None
    return 100.0 * float(device.sum()) / float(real.sum())
