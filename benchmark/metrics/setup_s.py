"""Set-up: process start to the first timed step or study (host clock)."""


def read(run):
    return run.get("setup_s")
