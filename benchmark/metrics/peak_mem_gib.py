"""The card's allocator peak over the window (reset at its start), GiB."""


def read(run):
    return run["memory_peak_bytes"] / 2 ** 30
