"""Mean host time of a step (the span ``train.step``) over the
measured window, from the span store. Launches are asynchronous, so this
is the time the host takes to enqueue a step; where it nears the step's
wall time, launches set the pace. The driver's window steps come just
before its traced ones (``trace.steps``)."""

from benchmark.spans import window


def read(run):
    if not run.get("steps"):
        return None
    steps = window("train.step", int(run["steps"]),
                   int((run.get("trace") or {}).get("steps", 0)))
    return None if steps is None else 1e3 * float(steps.mean())
